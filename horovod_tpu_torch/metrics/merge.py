"""Snapshot merge algebra: the port's copy of the JAX package's
``metrics/merge.py``. A small, associative merge over
:func:`exposition.json_snapshot`-shaped dicts, with unit-pinned semantics
per metric type:

- **counter** — summed: per-rank monotonic totals whose gang-wide reading
  is their sum, so the merged value equals the sum of the per-rank values.
- **gauge** — maxed: instantaneous readings where the operator question
  is "how bad is the worst rank".
- **histogram** — bucket-wise added, ``sum``/``count`` added. Buckets are
  keyed by their ``le`` bound string and the layouts MUST match (snapshot
  buckets are cumulative, so unioning two bound sets would break
  monotonicity): a layout mismatch raises :class:`MetricError`.

``merge`` operates on **frames** — ``{"ranks": [...], "metrics":
snapshot}`` — produced by :func:`frame`, so every rollup says which ranks
it covers. The operation is associative and commutative (exact for
integral values; float payloads up to rounding), so frames fold in any
order. The JAX package's fleet plane folds per-host frames with it; the
port's launcher-side fold is left for the fleet plane's port.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

from horovod_tpu_torch.metrics.registry import MetricError

MERGE_SCHEMA = "hvt-metrics-frame-r1"


def frame(ranks, snapshot: dict) -> dict:
    """Lift one rank's (or host's) snapshot into a mergeable frame.

    ``ranks`` is an int or an iterable of ints — the ranks whose
    telemetry the snapshot covers."""
    if isinstance(ranks, int):
        ranks = [ranks]
    return {"schema": MERGE_SCHEMA,
            "ranks": sorted(int(r) for r in ranks),
            "metrics": snapshot or {}}


def _sample_key(labels: dict):
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _merge_family(name: str, a: dict, b: dict) -> dict:
    if a.get("type") != b.get("type"):
        raise MetricError(
            f"cannot merge metric {name}: type {a.get('type')!r} vs "
            f"{b.get('type')!r}")
    mtype = a.get("type")
    out_samples: Dict[tuple, dict] = {}
    for src in (a, b):
        for s in src.get("samples", ()):
            key = _sample_key(s.get("labels", {}))
            cur = out_samples.get(key)
            if cur is None:
                if mtype == "histogram":
                    out_samples[key] = {
                        "labels": dict(s.get("labels", {})),
                        "buckets": dict(s.get("buckets", {})),
                        "sum": s.get("sum", 0.0),
                        "count": s.get("count", 0)}
                else:
                    out_samples[key] = {
                        "labels": dict(s.get("labels", {})),
                        "value": s.get("value", 0.0)}
                continue
            if mtype == "counter":
                cur["value"] = cur.get("value", 0.0) + s.get("value", 0.0)
            elif mtype == "gauge":
                cur["value"] = max(cur.get("value", 0.0),
                                   s.get("value", 0.0))
            else:  # histogram
                bk = cur["buckets"]
                sb = s.get("buckets") or {}
                if set(bk) != set(sb):
                    # cumulative buckets: adding across DIFFERENT
                    # layouts would credit counts to the wrong bounds
                    # and break the le-monotonicity every consumer
                    # assumes — refuse, like a type mismatch
                    raise MetricError(
                        f"cannot merge histogram {name}: bucket "
                        f"layouts differ ({sorted(bk)} vs "
                        f"{sorted(sb)})")
                for le, n in sb.items():
                    bk[le] = bk.get(le, 0) + n
                cur["sum"] = cur.get("sum", 0.0) + s.get("sum", 0.0)
                cur["count"] = cur.get("count", 0) + s.get("count", 0)
    return {"type": mtype,
            "help": a.get("help") or b.get("help") or "",
            "samples": [out_samples[k] for k in sorted(out_samples)]}


def merge(*frames: dict) -> dict:
    """Fold any number of frames (see :func:`frame`) into one.

    Families are unioned; samples with identical label sets combine per
    the type semantics above. Raises :class:`MetricError` when the same
    family name carries different types across frames (a schema drift
    that silent coercion would hide)."""
    ranks: List[int] = []
    metrics: Dict[str, dict] = {}
    for fr in frames:
        if fr is None:
            continue
        ranks.extend(fr.get("ranks", ()))
        for name, fam in (fr.get("metrics") or {}).items():
            if name in metrics:
                metrics[name] = _merge_family(name, metrics[name], fam)
            else:
                # deep-enough copy: merging must never mutate an input
                metrics[name] = {
                    "type": fam.get("type"), "help": fam.get("help", ""),
                    "samples": [
                        dict(s, labels=dict(s.get("labels", {})),
                             **({"buckets": dict(s.get("buckets", {}))}
                                if "buckets" in s else {}))
                        for s in fam.get("samples", ())]}
    return {"schema": MERGE_SCHEMA, "ranks": sorted(set(ranks)),
            "metrics": metrics}


def counter_total(frame_or_snapshot: dict, name: str) -> float:
    """Sum of one family's sample values in a frame or bare snapshot —
    the equivalence probe the tests use."""
    metrics = frame_or_snapshot.get("metrics", frame_or_snapshot)
    fam = (metrics or {}).get(name) or {}
    total = 0.0
    for s in fam.get("samples", ()):
        v = s.get("value", 0.0)
        if isinstance(v, (int, float)) and not math.isnan(v):
            total += v
    return total
