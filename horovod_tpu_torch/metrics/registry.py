"""Dependency-free metric registry: the port's copy of the JAX package's
``metrics/registry.py``. Counter / Gauge / Histogram with label support,
thread-safe, serializable to Prometheus text exposition and JSON snapshots
(``metrics/exposition.py``).

The eager collectives (``ops/collective_ops.py``, their latencies resolved
from CUDA events by ``utils/timeline.py``'s drainer), the elastic driver
and recovery loop, and ``callbacks.MetricsCallback`` write here; ``GET
/metrics`` (``metrics.serve`` in each worker, or the launcher's
``runner/http_server.py``) reads it at scrape time. Family names, label
names, bucket bounds and the text format are the JAX package's, so one
dashboard reads both.

Design constraints (as in the JAX package):

- **No third-party deps.** ``prometheus_client`` is not required; the
  subset implemented here (counter/gauge/histogram, labels, text
  exposition) is what the scrape ecosystem consumes.
- **Cheap on the hot path.** A labeled child is resolved once and
  cached; ``inc``/``observe`` is a lock + float add.
- **Pull model.** Collectors registered on the registry run at
  serialization time.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# Fixed log-scale histogram buckets: 1 µs → ~67 s in powers of four.
# Collective latencies span loopback-eager (~10 µs) to cross-host rings
# behind a stall (~seconds); 4x steps keep the series short (14 buckets)
# while every decade stays resolvable.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-6 * 4.0 ** i for i in range(14))


class MetricError(ValueError):
    """Raised on metric misuse (bad labels, type mismatch, re-registration
    with a different schema)."""


def _validate_name(name: str):
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise MetricError(f"invalid metric name {name!r}")
    if name[0].isdigit():
        raise MetricError(f"metric name must not start with a digit: {name!r}")


class _Child:
    """One (metric, labelvalues) time series."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise MetricError("counters can only increase; use a Gauge")
        with self._lock:
            self._value += amount

    def set_total(self, value: float):
        """Overwrite the running total — ONLY for bridging an external
        monotonic source whose raw value already IS the total. Regular
        code must use ``inc``."""
        with self._lock:
            self._value = float(value)


class _GaugeChild(_Child):
    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1 → +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            # linear scan: bucket lists are short (14 by default) and a
            # scan beats bisect's call overhead at that size
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += v
            self._count += 1

    def set_state(self, counts, sum_, count):
        """Overwrite the bucket/total state — ONLY for bridging an
        external histogram source whose raw arrays already ARE the
        running totals. ``counts`` is per-bucket
        (non-cumulative), length ``len(buckets) + 1`` (+Inf last);
        shorter inputs zero-fill, longer ones truncate. Regular code
        must use ``observe``."""
        with self._lock:
            n = len(self._counts)
            cs = [int(c) for c in list(counts)[:n]]
            self._counts = cs + [0] * (n - len(cs))
            self._sum = float(sum_)
            self._count = int(count)

    def snapshot(self):
        """(cumulative_bucket_counts, sum, count) — cumulative per the
        Prometheus histogram convention (le buckets nest)."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, total = [], 0
        for n in counts:
            total += n
            cum.append(total)
        return cum, s, c


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild}


class Metric:
    """A named metric family: one child per label-value combination."""

    def __init__(self, name: str, help: str, type: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        _validate_name(name)
        for l in labelnames:
            _validate_name(l)
        if type not in ("counter", "gauge", "histogram"):
            raise MetricError(f"unknown metric type {type!r}")
        self.name = name
        self.help = help
        self.type = type
        self.labelnames = tuple(labelnames)
        if type == "histogram":
            bs = tuple(sorted(buckets if buckets is not None
                              else DEFAULT_LATENCY_BUCKETS))
            if any(math.isinf(b) for b in bs):
                raise MetricError("+Inf bucket is implicit; do not pass it")
            self.buckets = bs
        else:
            if buckets is not None:
                raise MetricError("buckets= is only valid for histograms")
            self.buckets = None
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self.labels()  # eager default child → series exists at scrape

    def labels(self, *labelvalues, **labelkwargs):
        """Resolve (and cache) the child for one label-value combination.
        Accepts positional values in ``labelnames`` order or keywords."""
        if labelvalues and labelkwargs:
            raise MetricError("pass labels positionally or by keyword, "
                              "not both")
        if labelkwargs:
            try:
                labelvalues = tuple(str(labelkwargs[l])
                                    for l in self.labelnames)
            except KeyError as e:
                raise MetricError(
                    f"missing label {e.args[0]!r} for metric {self.name} "
                    f"(labels: {list(self.labelnames)})") from None
            if len(labelkwargs) != len(self.labelnames):
                extra = set(labelkwargs) - set(self.labelnames)
                raise MetricError(
                    f"unexpected labels {sorted(extra)} for metric "
                    f"{self.name} (labels: {list(self.labelnames)})")
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise MetricError(
                f"metric {self.name} takes {len(self.labelnames)} label "
                f"value(s) {list(self.labelnames)}, got "
                f"{len(labelvalues)}")
        with self._lock:
            child = self._children.get(labelvalues)
            if child is None:
                if self.type == "histogram":
                    child = _HistogramChild(self.buckets)
                else:
                    child = _CHILD_TYPES[self.type]()
                self._children[labelvalues] = child
        return child

    # convenience forwards for label-less metrics -------------------------
    def _default(self):
        if self.labelnames:
            raise MetricError(
                f"metric {self.name} has labels {list(self.labelnames)}; "
                f"resolve a child with .labels(...) first")
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def set(self, value: float):
        self._default().set(value)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def observe(self, value: float):
        self._default().observe(value)

    @property
    def value(self) -> float:
        return self._default().value

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels_dict, child), ...] in insertion order."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, lv)), child)
                for lv, child in items]


class MetricRegistry:
    """Holds metric families; get-or-create semantics so instrumentation
    sites stay declaration-free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    # ------------------------------------------------------------ factories
    def _get_or_create(self, name, help, type, labelnames, buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.type != type or m.labelnames != tuple(labelnames):
                    raise MetricError(
                        f"metric {name} already registered as {m.type} "
                        f"with labels {list(m.labelnames)}")
                return m
            m = Metric(name, help, type, labelnames, buckets=buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._get_or_create(name, help, "histogram", labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    # ----------------------------------------------------------- collection
    def register_collector(self, fn: Callable[[], None]):
        """``fn()`` runs before every serialization — the pull hook for
        bridged sources. Registering the same function twice is a
        no-op."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> List[Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                # a broken bridge must never take down the scrape —
                # the remaining families still serialize
                pass
        with self._lock:
            return list(self._metrics.values())

    def clear(self):
        """Drop every metric and collector (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()
