"""Serializers and the standalone scrape endpoint for the metric registry:
the port's copy of the JAX package's ``metrics/exposition.py``.

Two wire formats from one ``MetricRegistry``:

- :func:`prometheus_text` — Prometheus text exposition format 0.0.4
  (``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket{le=...}``
  histogram series with ``_sum``/``_count``), scrapeable by any
  Prometheus-compatible agent.
- :func:`json_snapshot` — structured dict of every family and sample,
  embedded verbatim in the harness's records (``bench.py``'s
  ``engine_metrics``) so perf data carries its collective counters even
  when the live endpoint is unreachable.

:class:`MetricsServer` is a daemon HTTP server answering ``GET /metrics``
(text) and ``GET /metrics.json``; each worker starts one under
``launch --metrics-port`` (``metrics.serve``), and the launcher's
rendezvous server exposes the same routes (``runner/http_server.py``).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.metrics.registry import MetricRegistry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_le(b: float) -> str:
    # %g keeps bucket bounds short and stable ("1e-06", "0.004096")
    return "%g" % b


def _label_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = list(labels.items()) + list((extra or {}).items())
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in items)
    return "{" + inner + "}"


def prometheus_text(registry: MetricRegistry) -> str:
    """Serialize every family to Prometheus text exposition format."""
    lines = []
    for m in registry.collect():
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.type}")
        for labels, child in m.samples():
            if m.type == "histogram":
                cum, s, c = child.snapshot()
                bounds = list(m.buckets) + [math.inf]
                for b, n in zip(bounds, cum):
                    le = "+Inf" if math.isinf(b) else _fmt_le(b)
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_label_str(labels, {'le': le})} {n}")
                lines.append(
                    f"{m.name}_sum{_label_str(labels)} {_fmt_value(s)}")
                lines.append(f"{m.name}_count{_label_str(labels)} {c}")
            else:
                lines.append(
                    f"{m.name}{_label_str(labels)} "
                    f"{_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"


def json_snapshot(registry: MetricRegistry) -> dict:
    """Structured snapshot: {name: {type, help, samples: [...]}}."""
    out = {}
    for m in registry.collect():
        samples = []
        for labels, child in m.samples():
            if m.type == "histogram":
                cum, s, c = child.snapshot()
                bounds = [_fmt_le(b) for b in m.buckets] + ["+Inf"]
                samples.append({"labels": labels,
                                "buckets": dict(zip(bounds, cum)),
                                "sum": s, "count": c})
            else:
                samples.append({"labels": labels, "value": child.value})
        out[m.name] = {"type": m.type, "help": m.help, "samples": samples}
    return out


# --------------------------------------------------------------------------
# standalone endpoint (launch --metrics-port)
# --------------------------------------------------------------------------

class MetricsServer:
    """Daemon HTTP server: GET /metrics (text), GET /metrics.json."""

    def __init__(self, registry: MetricRegistry):
        self._registry = registry
        self._server = None

    def start(self, port: int = 0, addr: str = "0.0.0.0") -> int:
        registry = self._registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path in ("/metrics", ""):
                    body = prometheus_text(registry).encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(json_snapshot(registry)).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer((addr, port), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
