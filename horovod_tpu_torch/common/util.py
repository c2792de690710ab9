"""Small shared helpers (Horovod's ``common/util.py``; the JAX package's
``common/util.py``)."""

from __future__ import annotations


def split_list(xs, num_parts):
    """``xs`` in at most ``num_parts`` contiguous, non-empty chunks whose
    lengths differ by one at most, the longer first (``num_groups``
    gradient grouping)."""
    if not xs:
        return []
    num_parts = min(num_parts, len(xs))
    base, extra = divmod(len(xs), num_parts)
    out, i = [], 0
    for p in range(num_parts):
        n = base + (1 if p < extra else 0)
        out.append(xs[i:i + n])
        i += n
    return out
