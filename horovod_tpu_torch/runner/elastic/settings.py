"""Elastic job settings: the port's copy of the JAX package's
``runner/elastic/settings.py`` (Horovod's ``runner/elastic/settings.py``
and the elastic arguments of ``runner/launch.py:392``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ElasticSettings:
    """Knobs for an elastic run.

    - ``min_np`` / ``max_np``: world-size bounds; the job starts as soon as
      ``min_np`` slots are discovered and never grows past ``max_np``.
    - ``elastic_timeout``: seconds to wait for ``min_np`` slots before
      giving up (reference constant ELASTIC_TIMEOUT_SECS, default 600).
    - ``reset_limit``: max number of re-rendezvous rounds before the job is
      failed (reference ``launch.py:392`` --reset-limit).
    - ``cooldown_range``: (min, max) seconds a blacklisted host stays
    blacklisted before it may be retried; ``None`` = permanent blacklist.
    - ``discovery_interval``: seconds between discovery polls (reference
      polls every 1 s, ``runner/elastic/driver.py:177``).
    """

    min_np: int = 1
    max_np: Optional[int] = None
    elastic_timeout: float = 600.0
    reset_limit: Optional[int] = None
    cooldown_range: Optional[tuple] = None
    discovery_interval: float = 1.0
    verbose: bool = False

    def __post_init__(self):
        if self.max_np is not None and self.max_np < self.min_np:
            raise ValueError(
                f"max_np ({self.max_np}) < min_np ({self.min_np})")
