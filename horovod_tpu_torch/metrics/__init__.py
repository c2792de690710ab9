"""``horovod_tpu_torch.metrics``: the port's live observability plane (the
JAX package's ``horovod_tpu/metrics``), a dependency-free metric registry
fed by

- the **eager collective instrumentation**: per-(op, process set) latency
  histograms and byte counters around every eager collective, sync and
  async (``ops/collective_ops.py``); on CUDA each latency comes from a
  pair of CUDA events resolved off the issuing thread
  (``utils/timeline.py``);
- the **elastic driver** (rendezvous rounds, world size, hosts) and the
  **recovery loop** (``hvt_recovery_*``);
- ``callbacks.MetricsCallback`` (training metrics by name).

Consumption paths: ``GET /metrics`` and ``GET /metrics.json`` from
:func:`serve` (``launch --metrics-port`` starts it in each worker at base
port + rank) or from the launcher's rendezvous server; and
:func:`json_snapshot`, which the harness embeds in its record
(``bench.py``'s ``engine_metrics``).

The port has no engine, so the JAX package's ``hvt_engine_*``,
``hvt_cache_*``, ``hvt_ctrl_*`` and ``hvt_events_dropped_total`` bridges
are not emitted: the port does not feed a series it cannot measure.

    from horovod_tpu_torch import metrics
    port = metrics.serve(9090)          # or launch --metrics-port 9090
    metrics.counter("my_steps_total", "steps run").inc()
    print(metrics.prometheus_text())
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from horovod_tpu_torch.metrics.registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, Metric, MetricError, MetricRegistry)
from horovod_tpu_torch.metrics import exposition as _exposition
from horovod_tpu_torch.metrics.exposition import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE, MetricsServer)

# reentrant: serve() resolves registry() while holding it
_lock = threading.RLock()
_registry: Optional[MetricRegistry] = None
_server: Optional[MetricsServer] = None


def registry() -> MetricRegistry:
    """The process-wide default registry, created on first use. It
    outlives elastic rounds: counters keep counting across a reset."""
    global _registry
    with _lock:
        if _registry is None:
            _registry = MetricRegistry()
        return _registry


# ---------------------------------------------------------------- factories
def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Metric:
    return registry().counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Metric:
    return registry().gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Metric:
    return registry().histogram(name, help, labelnames, buckets=buckets)


# ------------------------------------------------------------ serialization
def prometheus_text(reg: Optional[MetricRegistry] = None) -> str:
    return _exposition.prometheus_text(reg or registry())


def json_snapshot(reg: Optional[MetricRegistry] = None) -> dict:
    return _exposition.json_snapshot(reg or registry())


# ------------------------------------------------------------------ serving
def serve(port: int = 0, addr: str = "0.0.0.0") -> int:
    """Start (or return) the process-wide scrape endpoint; returns the
    bound port. Idempotent: a second call returns the running server's
    port. A port that cannot be bound raises ``OSError``.
    ``launch --metrics-port`` calls this from ``hvt.init()`` with
    ``port + rank`` so co-hosted workers don't collide."""
    global _server
    with _lock:
        if _server is None:
            server = MetricsServer(registry())
            server.start(port=port, addr=addr)
            _server = server
        return _server.port


def server_port() -> Optional[int]:
    with _lock:
        return _server.port if _server is not None else None


def stop_server():
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None


def reset():
    """Drop the default registry and endpoint (tests only)."""
    global _registry, _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None
        _registry = None
