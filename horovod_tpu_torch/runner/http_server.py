"""HTTP KV store and rendezvous server: the port's copy of the JAX
package's ``runner/http_server.py`` (Horovod's
``runner/http/http_server.py``: a KV handler with scoped keys, and a
rendezvous server re-``init()``-ed for each elastic round).

The elastic driver runs it: workers PUT their notification endpoints and
reports under scoped keys, and GET their slot for each round. A static job
joins on the TCP store and starts one only for ``--timeline``: workers
sample its ``GET /clock`` to align their shards and PUT each shard under
``/kv/timeline/<rank>``. It serves the launcher process's metrics
(``GET /metrics``, ``GET /metrics.json``: the elastic driver's families);
the JAX package's ``/statusz``, ``/debugz`` and ``/kvbulk`` belong to the
fleet plane, not ported yet.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# scopes kept across elastic round resets (init / DELETE /rendezvous):
# `workers` (notification registrations, made once per worker),
# `recovery` (recovery-phase reports, written between rounds) and
# `timeline` (shards, uploaded as workers end, merged at the job's end)
KEEP_SCOPES = ("workers", "recovery", "timeline")


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.scopes = {}

    def put(self, scope, key, value: bytes):
        with self.lock:
            self.scopes.setdefault(scope, {})[key] = value

    def get(self, scope, key):
        with self.lock:
            return self.scopes.get(scope, {}).get(key)

    def keys(self, scope):
        with self.lock:
            return list(self.scopes.get(scope, {}).keys())

    def clear(self, keep_scopes=()):
        with self.lock:
            self.scopes = {s: v for s, v in self.scopes.items()
                           if s in keep_scopes}


class RendezvousServer:
    """KV + slot-info rendezvous.

    Paths:
      PUT/GET /kv/<scope>/<key>         — raw bytes KV
      GET     /keys/<scope>             — JSON list of keys
      GET     /rendezvous/<host>/<local_rank> — JSON SlotInfo
      GET     /world                    — JSON {size, hosts, master_host,
                                          master_port, round}
      GET     /metrics                  — Prometheus text exposition of
                                          this process's registry
      GET     /metrics.json             — its JSON snapshot
      GET     /clock                    — server wall clock (epoch µs);
                                          the timeline's clock-offset
                                          handshake samples this
      DELETE  /rendezvous               — finalize round (elastic)
    """

    def __init__(self, master_port_fn, verbose=False, on_put=None):
        self._store = _Store()
        self._slots = {}
        self._world = {}
        self._server = None
        self._verbose = verbose
        self._round = 0
        self._on_put = on_put
        # fn(slots, round) -> int: the TCP store's port for this round,
        # published in world info so every worker (fresh spawn or survivor
        # re-syncing) joins the same one
        self._master_port_fn = master_port_fn

    def set_put_hook(self, fn):
        """``fn(scope, key, value_bytes)`` called on every /kv PUT — the
        elastic driver uses this to receive worker state reports."""
        self._on_put = fn

    def init(self, slots):
        """(Re)initialize with a host allocation plan — one call per
        elastic rendezvous round (Horovod's ``http_server.py:195``).
        Worker notification registrations survive the reset. Each init
        bumps ``round`` so workers re-rendezvousing can tell fresh slot
        info from the previous round's."""
        self._store.clear(keep_scopes=KEEP_SCOPES)
        self._round += 1
        self._slots = {
            f"{s.hostname}/{s.local_rank}": {
                "hostname": s.hostname, "rank": s.rank,
                "local_rank": s.local_rank, "cross_rank": s.cross_rank,
                "size": s.size, "local_size": s.local_size,
                "cross_size": s.cross_size, "round": self._round,
            } for s in slots
        }
        world = {"size": len(slots),
                 "hosts": sorted({s.hostname for s in slots}),
                 "master_host": slots[0].hostname,
                 "master_port": int(self._master_port_fn(slots, self._round)),
                 "round": self._round}
        # publish atomically, master_port included: a worker polling
        # /world between "round visible" and "port visible" would join a
        # different store than its peers
        self._world = world

    @property
    def round(self):
        return self._round

    @property
    def world(self):
        return dict(self._world)

    def start(self, port=0) -> int:
        store, server_ref = self._store, self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body=b"", ctype="application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_PUT(self):
                parts = self.path.strip("/").split("/")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if len(parts) >= 3 and parts[0] == "kv":
                    store.put(parts[1], "/".join(parts[2:]), body)
                    hook = server_ref._on_put
                    if hook is not None:
                        try:
                            hook(parts[1], "/".join(parts[2:]), body)
                        except Exception:
                            pass
                    self._send(200)
                else:
                    self._send(404)

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if len(parts) >= 3 and parts[0] == "kv":
                    v = store.get(parts[1], "/".join(parts[2:]))
                    if v is None:
                        self._send(404)
                    else:
                        self._send(200, v)
                elif len(parts) == 2 and parts[0] == "keys":
                    self._send(200, json.dumps(
                        store.keys(parts[1])).encode(), "application/json")
                elif len(parts) == 3 and parts[0] == "rendezvous":
                    info = server_ref._slots.get(f"{parts[1]}/{parts[2]}")
                    if info is None:
                        self._send(404)
                    else:
                        self._send(200, json.dumps(info).encode(),
                                   "application/json")
                elif parts == ["world"]:
                    self._send(200, json.dumps(server_ref._world).encode(),
                               "application/json")
                elif parts == ["metrics"]:
                    from horovod_tpu_torch import metrics

                    self._send(200, metrics.prometheus_text().encode(),
                               metrics.PROMETHEUS_CONTENT_TYPE)
                elif parts == ["metrics.json"]:
                    from horovod_tpu_torch import metrics

                    self._send(200, json.dumps(
                        metrics.json_snapshot()).encode(),
                        "application/json")
                elif parts == ["clock"]:
                    self._send(200, json.dumps(
                        {"epoch_us": time.time_ns() // 1000}).encode(),
                        "application/json")
                else:
                    self._send(404)

            def do_DELETE(self):
                if self.path.strip("/") == "rendezvous":
                    store.clear(keep_scopes=KEEP_SCOPES)
                    self._send(200)
                else:
                    self._send(404)

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    @property
    def port(self):
        return self._server.server_address[1] if self._server else None

    @property
    def store(self):
        return self._store

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
