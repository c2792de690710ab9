"""Command-line tools over the port's planes: ``hvt_top`` (``/statusz``)
and ``hvt_analyze`` (timelines)."""
