"""HTTP KV store and rendezvous server: the port's copy of the JAX
package's ``runner/http_server.py`` (Horovod's
``runner/http/http_server.py``: a KV handler with scoped keys, and a
rendezvous server re-``init()``-ed for each elastic round).

The elastic driver runs it: workers PUT their notification endpoints and
reports under scoped keys, and GET their slot for each round. A static job
joins on the TCP store and starts one only for ``--timeline``: workers
sample its ``GET /clock`` to align their shards and PUT each shard under
``/kv/timeline/<rank>``. Workers push their telemetry here
(``/kv/debugz/<rank>``, or one host frame ``/kv/telemetry/host/<host>`` per
host leader; ``metrics/telemetry.py``), which ``GET /debugz`` and ``GET
/statusz`` fold, and host leaders batch relayed reports into ``PUT
/kvbulk``. It serves the launcher process's metrics (``GET /metrics``,
``GET /metrics.json``: the elastic driver's families).

Every PUT is stamped with the server's monotonic clock and counted per
scope (bytes, entries, requests: the ``ingest`` block of ``/statusz``).
The worker-telemetry scopes (``SWEEP_SCOPES``) are swept of entries not
rewritten for ``HVT_KV_TTL_SEC`` (default 120 s, 0 = off), so a dead rank
reads as stale in ``/statusz`` first and then leaves the store.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# KV scopes that survive round resets AND are worker-telemetry streams:
# the only scopes the TTL sweep prunes. A shed rank's last snapshot must
# leave the rollup (reported as stale first, dropped after HVT_KV_TTL_SEC),
# while `workers` (notification registrations) and `timeline` (shards
# merged at the job's end) are never aged out.
SWEEP_SCOPES = ("serving", "debugz", "telemetry", "recovery")

# scopes kept across elastic round resets (init / DELETE /rendezvous):
# `workers` (made once per worker), `timeline` (merged at the job's end),
# the telemetry streams (the autoscaler and /statusz must not go blind at
# the rendezvous they caused), and `recovery` (written between rounds)
KEEP_SCOPES = ("workers", "timeline", "debugz", "serving", "telemetry",
               "recovery")


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.scopes = {}
        # last-write monotonic stamps per (scope, key): /statusz's
        # liveness source, taken by the server so no worker clock skews it
        self.meta = {}
        # cumulative ingest per scope: bytes and entries PUT, and HTTP
        # requests (a /kvbulk batch is one request whatever it carries)
        self.put_bytes = {}
        self.put_count = {}
        self.put_requests = {}

    def put(self, scope, key, value: bytes, now=None):
        now = time.monotonic() if now is None else now
        with self.lock:
            self.scopes.setdefault(scope, {})[key] = value
            self.meta.setdefault(scope, {})[key] = now
            self.put_bytes[scope] = (self.put_bytes.get(scope, 0)
                                     + len(value))
            self.put_count[scope] = self.put_count.get(scope, 0) + 1

    def note_request(self, scope, n=1):
        with self.lock:
            self.put_requests[scope] = (self.put_requests.get(scope, 0)
                                        + n)

    def get(self, scope, key):
        with self.lock:
            return self.scopes.get(scope, {}).get(key)

    def keys(self, scope):
        with self.lock:
            return list(self.scopes.get(scope, {}).keys())

    def age(self, scope, key, now=None):
        """Seconds since the key was last written (None: never)."""
        now = time.monotonic() if now is None else now
        with self.lock:
            t = self.meta.get(scope, {}).get(key)
        return None if t is None else max(0.0, now - t)

    def ingest_stats(self):
        with self.lock:
            return {"put_bytes": dict(self.put_bytes),
                    "put_count": dict(self.put_count),
                    "put_requests": dict(self.put_requests)}

    def sweep(self, ttl_sec, scopes=SWEEP_SCOPES, now=None):
        """Drop entries not rewritten for ``ttl_sec`` from the telemetry
        scopes; returns the removed (scope, key) pairs."""
        if not ttl_sec or ttl_sec <= 0:
            return []
        now = time.monotonic() if now is None else now
        removed = []
        with self.lock:
            for scope in scopes:
                meta = self.meta.get(scope)
                if not meta:
                    continue
                for key, t in list(meta.items()):
                    if now - t > ttl_sec:
                        meta.pop(key, None)
                        self.scopes.get(scope, {}).pop(key, None)
                        removed.append((scope, key))
        return removed

    def clear(self, keep_scopes=()):
        with self.lock:
            self.scopes = {s: v for s, v in self.scopes.items()
                           if s in keep_scopes}
            self.meta = {s: v for s, v in self.meta.items()
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
      GET     /debugz                   — world info and every worker's
                                          last pushed snapshot
      GET     /statusz                  — the gang health rollup
                                          (metrics/telemetry.py)
      PUT     /kvbulk                   — a JSON list of {scope, key,
                                          value_b64} entries, stored and
                                          hooked as single PUTs
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
        self._statusz = None    # a StatuszBuilder, made on first use
        self._statusz_lock = threading.Lock()

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

    def kv_ttl_sec(self) -> float:
        """TTL of the worker-telemetry scopes (``HVT_KV_TTL_SEC``; 0
        disables the sweep)."""
        try:
            return float(os.environ.get("HVT_KV_TTL_SEC", "") or 120.0)
        except ValueError:
            return 120.0

    def statusz_snapshot(self, now=None) -> dict:
        """The gang health rollup of ``GET /statusz``, also the
        autoscaler's alert feed; expired telemetry is swept first."""
        from horovod_tpu_torch.metrics import telemetry

        self._store.sweep(self.kv_ttl_sec(), now=now)
        with self._statusz_lock:
            if self._statusz is None:
                self._statusz = telemetry.StatuszBuilder()
            return self._statusz.build(
                self._store, self._world, self._round, now=now,
                server_stats=self._store.ingest_stats())

    def debugz_snapshot(self) -> dict:
        """``GET /debugz``: the world, the round, the timeline shards, the
        hosts whose leaders push frames, and each directly pushed rank's
        last snapshot."""
        store = self._store
        store.sweep(self.kv_ttl_sec())
        ranks = {}
        for key in store.keys("debugz"):
            try:
                ranks[key] = json.loads(store.get("debugz", key))
            except Exception:
                ranks[key] = {"error": "unparseable report"}
        return {"world": self._world, "round": self._round,
                "timeline_shards": sorted(store.keys("timeline")),
                "telemetry_hosts": sorted(
                    k[5:] for k in store.keys("telemetry")
                    if k.startswith("host/")),
                "ranks": ranks}

    def _put_bulk(self, body: bytes):
        """Store each entry of a ``PUT /kvbulk`` batch as a single PUT
        would be, one request counted per scope; None when the body is
        not a JSON list."""
        try:
            envs = json.loads(body)
            assert isinstance(envs, list)
        except (ValueError, AssertionError, UnicodeDecodeError):
            return None
        seen, accepted = set(), 0
        for env in envs:
            try:
                scope, key = str(env["scope"]), str(env["key"])
                value = base64.b64decode(env.get("value_b64") or "")
            except (TypeError, KeyError, ValueError):
                continue
            if scope not in seen:
                seen.add(scope)
                self._store.note_request(scope)
            self._put(scope, key, value)
            accepted += 1
        return accepted

    def _put(self, scope, key, value):
        self._store.put(scope, key, value)
        if self._on_put is not None:
            try:
                self._on_put(scope, key, value)
            except Exception:
                pass

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
                    store.note_request(parts[1])
                    server_ref._put(parts[1], "/".join(parts[2:]), body)
                    self._send(200)
                elif parts == ["kvbulk"]:
                    accepted = server_ref._put_bulk(body)
                    if accepted is None:
                        self._send(400)
                    else:
                        self._send(200, json.dumps(
                            {"accepted": accepted}).encode(),
                            "application/json")
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
                elif parts in (["debugz"], ["statusz"]):
                    try:
                        body = (server_ref.debugz_snapshot()
                                if parts == ["debugz"]
                                else server_ref.statusz_snapshot())
                    except Exception as e:
                        self._send(500, json.dumps(
                            {"error": repr(e)}).encode(),
                            "application/json")
                        return
                    self._send(200, json.dumps(body).encode(),
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
