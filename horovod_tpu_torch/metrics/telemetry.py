"""Fleet telemetry plane: the port's copy of the JAX package's
``metrics/telemetry.py`` (leader-aggregated push and the gang health
rollup), with the same schemas (``hvt-telemetry-host-r1``,
``hvt-statusz-r1``), the same knobs and, for the same inputs, the same JSON.

- **Per-rank snapshots** (:func:`build_snapshot`): ``hvt.diagnostics()``
  enriched with a fixed-size ``telemetry`` compact record and a ``metrics``
  counter frame (``metrics/merge.py``).
- **Leader aggregation** (:class:`TelemetryPusher` +
  :class:`HostAggregator`): members push snapshots to their host leader
  (local process id 0) over loopback; the leader merges them (counters
  summed, gauges maxed, histogram buckets added) and PUTs ONE host frame to
  ``/kv/telemetry/host/<host>``, so the server's ingest is O(hosts).
  Direct mode: every rank PUTs to ``/kv/debugz/<rank>``.
- **Gang rollup** (:class:`StatuszBuilder` + :class:`HealthEngine`): the
  fold behind the rendezvous server's ``GET /statusz``
  (``runner/http_server.py``): per-rank liveness, links, byte rates, active
  codecs, and rolling-window health rules (straggler, reconnect storm, push
  stale, serving backlog) counted in ``hvt_health_alerts_total{rule}``; the
  ``alerts`` list feeds the autoscaler
  (``runner/elastic/autoscaler.py``).
- **Relay** (:func:`relay_put`): the elastic loop's failure, state and
  recovery reports go through the host leader's aggregator, batched into one
  ``PUT /kvbulk``, with a direct PUT as fallback.

Where the port departs: it has no C++ engine, so a snapshot's stats are the
port's own (``common/basics.py``: collective bytes and counts per op, wire
bytes per op and codec, error-feedback residual bytes); the engine's cycles,
cache hits, control-plane bytes, link reconnects and arrival tables read as
zero or absent, as the JAX module renders an absent engine. When the stats
carry ``collective_bytes``, the counter frame adds
``hvt_collective_bytes_total{op}`` and ``hvt_collectives_total{op}``. The
port has no ``HVT_CTRL_TOPOLOGY``, so ``HVT_TELEMETRY_AGG=auto`` (the
default) means direct pushes; ``1`` forces leader aggregation.

Knobs: ``HVT_DEBUGZ_INTERVAL_MS`` (push period, default 5000, ±25 %
jitter), ``HVT_TELEMETRY_AGG`` (``auto``/``1``/``0``),
``HVT_TELEMETRY_ROLE`` (``leader``/``member``/``direct`` override),
``HVT_KV_RELAY``, ``HVT_RELAY_FLUSH_MS`` and the health thresholds
``HVT_HEALTH_STRAGGLER_WINDOWS`` / ``HVT_HEALTH_RECONNECT_STORM`` /
``HVT_HEALTH_STALE_INTERVALS`` / ``HVT_HEALTH_BACKLOG_WINDOWS``.
"""

from __future__ import annotations

import json
import os
import random
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.metrics import merge as _merge

TELEMETRY_SCHEMA = "hvt-telemetry-host-r1"
STATUSZ_SCHEMA = "hvt-statusz-r1"
TELEMETRY_SCOPE = "telemetry"

# KV scopes eligible for leader routing (the per-host-leader shape applied
# to the remaining O(ranks) PUT streams): recovery-path
# worker reports (failure/state/preempt/recovery), serving stats, and
# timeline shards. Members hand envelopes to their host leader, which
# batches them into ONE driver request (``PUT /kvbulk``) — per-round
# driver fan-in becomes O(hosts). The driver's storage layout is
# unchanged: a relayed PUT lands under the same (scope, key) as a
# direct one, so every existing hook/reader sees identical data.
RELAY_SCOPES = ("failure", "state", "preempt", "recovery", "serving",
                "timeline")

# Only negotiations that have been waiting at least this long count as
# straggler evidence: rank 0's arrival table is a point sample, and a
# healthy gang always has µs-scale open negotiations in flight — without
# the floor, a clean gang would trip the straggler rule on snapshot
# timing alone, even with the persistence threshold at its most
# trigger-happy setting.
STRAGGLER_MIN_WAIT_SEC = 0.5

# How many per-rank stall/negotiation entries a compact record keeps —
# the host frame must stay O(1) per rank or the O(hosts) scrape-cost
# claim quietly erodes.
_COMPACT_CAP = 8


# Env reads stay literal (no name indirection) so the env↔docs lint
# pass sees every knob.
def _as_float(raw, default: float) -> float:
    try:
        return float(raw) if raw not in (None, "") else default
    except ValueError:
        return default


def interval_sec() -> float:
    """The debugz/telemetry push period (HVT_DEBUGZ_INTERVAL_MS)."""
    return max(0.05, _as_float(
        os.environ.get("HVT_DEBUGZ_INTERVAL_MS"), 5000.0) / 1e3)


def jittered(period_sec: float) -> float:
    """±25% full jitter: every rank pushing on the same 5 s phase is a
    thundering herd at 64+ ranks; decorrelating the phases flattens the
    rendezvous server's arrival process."""
    return period_sec * (0.75 + 0.5 * random.random())


def host_name() -> str:
    """This rank's host identity — the leader-election and frame key.
    ``HVT_TOPO_HOST`` (the same knob the engine's tree leaders key on,
    letting harnesses fake multi-host layouts on loopback) wins over
    the launcher's ``HVT_HOSTNAME`` and the kernel hostname."""
    return (os.environ.get("HVT_TOPO_HOST")
            or os.environ.get("HVT_HOSTNAME")
            or socket.gethostname())


def telemetry_role() -> str:
    """``leader`` / ``member`` / ``direct`` for this rank.

    Explicit ``HVT_TELEMETRY_ROLE`` wins. Otherwise leader aggregation
    is active iff ``HVT_TELEMETRY_AGG`` is ``1``; ``auto``/unset means
    direct pushes, since the port has no tree control plane whose
    per-host leaders the JAX package's ``auto`` follows."""
    explicit = os.environ.get("HVT_TELEMETRY_ROLE", "").strip().lower()
    if explicit in ("leader", "member", "direct"):
        return explicit
    agg = os.environ.get("HVT_TELEMETRY_AGG", "auto").strip().lower()
    if agg not in ("1", "on", "true"):
        return "direct"
    local = os.environ.get("HVT_LOCAL_PROCESS_ID")
    try:
        local_id = int(local)
    except (TypeError, ValueError):
        # absent or malformed — cannot tell who leads this host, and a
        # raise here would silently kill the daemon push thread;
        # direct is always correct
        return "direct"
    return "leader" if local_id == 0 else "member"


def kv_relay_enabled() -> bool:
    """``HVT_KV_RELAY`` gate for leader-routed KV scopes: ``0`` forces
    every PUT direct, ``1`` forces routing,
    ``auto`` (default) routes iff this rank's telemetry role is not
    ``direct`` — the relay rides the same per-host leader the telemetry
    plane already elects."""
    raw = os.environ.get("HVT_KV_RELAY", "auto").strip().lower()
    if raw in ("0", "off", "false"):
        return False
    if raw in ("1", "on", "true"):
        return True
    return telemetry_role() != "direct"


_relay_ep_cache: Dict[str, str] = {}
_relay_ep_miss: Dict[str, float] = {}  # host -> monotonic retry-after
_RELAY_MAX_PAYLOAD = 256 << 10  # bigger blobs go direct (see relay_put)
_RELAY_MISS_TTL = 5.0
# the leader process's own aggregator (set by TelemetryPusher while a
# leader role is active): its relay_put envelopes enqueue in-process —
# no loopback HTTP hop to itself, which matters exactly when the box
# is saturated by a gang-wide failure storm
_local_aggregator = None


def relay_put(addr: str, scope: str, key: str, obj=None,
              data: Optional[bytes] = None, urgent: bool = False,
              timeout: float = 3.0) -> bool:
    """PUT one KV entry, leader-routed when the relay is active.

    The envelope goes to this host's aggregator endpoint over loopback
    (leaders and members alike — the leader's own reports queue through
    the same door); the leader batches queued envelopes into one driver
    ``/kvbulk`` request per push tick, flushing immediately when an
    envelope is ``urgent`` (failure/preempt notices sit on the recovery
    path and cannot wait a tick). ANY relay failure — no leader
    endpoint published, the leader's host just died, a refused
    connection — falls back to the direct PUT, so routing can delay a
    report by at most one short timeout, never lose it."""
    from horovod_tpu_torch.runner.http_client import put_bytes

    payload = data if data is not None else json.dumps(obj).encode()
    # large blobs (multi-MB timeline shards) skip the relay: the
    # base64+JSON envelope costs +33% and a full buffered copy on the
    # leader AND the driver, where a raw direct PUT streams — batching
    # only pays for the small, frequent report scopes
    if len(payload) <= _RELAY_MAX_PAYLOAD and kv_relay_enabled() \
            and scope in RELAY_SCOPES:
        env = {"scope": scope, "key": key, "urgent": bool(urgent)}
        import base64

        env["value_b64"] = base64.b64encode(payload).decode()
        if _local_aggregator is not None:
            try:
                _local_aggregator.relay([env])
                return True
            except Exception:
                pass
        host = host_name()
        ep = _relay_ep_cache.get(host) or _discover_relay_ep(addr, host)
        if ep is not None:
            try:
                put_bytes(ep, "/relay", json.dumps([env]).encode(),
                          timeout=min(timeout, 2.0), retries=0)
                return True
            except Exception:
                _relay_ep_cache.pop(host, None)
    try:
        put_bytes(addr, f"/kv/{scope}/{key}", payload,
                  timeout=timeout, retries=0)
        return True
    except Exception:
        return False


def _discover_relay_ep(addr: str, host: str, timeout: float = 2.0,
                       use_miss_cache: bool = True) -> Optional[str]:
    """Resolve (and cache) the host leader's aggregator endpoint from
    the KV — the ONE spelling of endpoint discovery, shared by
    relay_put and the member pusher. relay_put honors a short negative
    cache: with no leader published, every relayed report would
    otherwise pay a discovery GET against the driver on exactly the
    storm the relay exists to suppress. The pusher probes UNCACHED —
    its whole job is noticing the leader appear."""
    import time as _time

    if use_miss_cache and \
            _time.monotonic() < _relay_ep_miss.get(host, 0.0):
        return None
    from horovod_tpu_torch.runner.http_client import get_json

    try:
        ep = get_json(addr, f"/kv/{TELEMETRY_SCOPE}/ep/{host}",
                      timeout=timeout, retries=0)
    except Exception:
        ep = None
    ep = ep.get("addr") if isinstance(ep, dict) else None
    if ep:
        _relay_ep_cache[host] = ep
        _relay_ep_miss.pop(host, None)
    else:
        _relay_ep_miss[host] = _time.monotonic() + _RELAY_MISS_TTL
    return ep


# ---------------------------------------------------------------------------
# stats normalization + snapshot builders
# ---------------------------------------------------------------------------

_FLAT_RE = re.compile(r"^(\w+)\[(\w+)\]$")


def _normalize_stats(stats: dict) -> dict:
    """Accept either the decoded stats form (nested dicts and lists; the
    port's own, ``common/basics.py``) or the flat manifest form
    (``lane_depth[0]``, ``link_reconnects[ctrl]``, ...), and return the
    decoded shape this module consumes."""
    stats = stats or {}
    if "lane_depth" in stats or not any(_FLAT_RE.match(k)
                                        for k in stats):
        return stats
    out = dict(stats)
    nested: Dict[str, dict] = {}
    for k, v in stats.items():
        m = _FLAT_RE.match(k)
        if m:
            nested.setdefault(m.group(1), {})[m.group(2)] = v
    for key, sub in nested.items():
        if all(s.isdigit() for s in sub):
            out[key] = [sub.get(str(i), 0)
                        for i in range(max(int(s) for s in sub) + 1)]
        else:
            out[key] = sub
    return out


def counters_frame(rank: int, stats: dict) -> dict:
    """A small, fixed-schema metrics frame (``merge.frame``) carrying
    the counters the gang rollup sums and rates: one frame per rank,
    merged leader-side. Kept deliberately narrow — the full registry
    snapshot is a per-rank scrape surface, not a push payload."""
    stats = _normalize_stats(stats)
    wire_total = sum((stats.get("wire_tx_bytes") or {}).values())
    lr = stats.get("link_reconnects") or {}

    def counter(value, help_=""):
        return {"type": "counter", "help": help_,
                "samples": [{"labels": {}, "value": float(value)}]}

    def gauge(value, help_=""):
        return {"type": "gauge", "help": help_,
                "samples": [{"labels": {}, "value": float(value)}]}

    metrics = {
        "hvt_engine_cycles_total": counter(stats.get("cycles", 0)),
        "hvt_cache_hits_total": counter(stats.get("cache_hits", 0)),
        "hvt_ctrl_tx_bytes_total": counter(stats.get("ctrl_tx_bytes", 0)),
        "hvt_ctrl_rx_bytes_total": counter(stats.get("ctrl_rx_bytes", 0)),
        "hvt_wire_tx_bytes_total": counter(wire_total),
        "hvt_frames_replayed_total": counter(
            stats.get("frames_replayed", 0)),
        "hvt_link_replay_bytes_total": counter(
            stats.get("replay_bytes", 0)),
        "hvt_link_reconnects_total": {
            "type": "counter", "help": "",
            "samples": [{"labels": {"plane": p}, "value": float(v)}
                        for p, v in sorted(lr.items())]},
        "hvt_ef_residual_bytes": gauge(stats.get("ef_residual_bytes", 0)),
        "hvt_lane_depth": {
            "type": "gauge", "help": "",
            "samples": [{"labels": {"lane": str(i)}, "value": float(v)}
                        for i, v in
                        enumerate(stats.get("lane_depth") or ())]},
    }
    if "collective_bytes" in stats:
        # the port's own dispatch counters (no engine feeds the above)
        for name, key in (("hvt_collective_bytes_total", "collective_bytes"),
                          ("hvt_collectives_total", "collective_count")):
            metrics[name] = {
                "type": "counter", "help": "",
                "samples": [{"labels": {"op": op}, "value": float(v)}
                            for op, v in sorted(
                                (stats.get(key) or {}).items())]}
    return _merge.frame(rank, metrics)


def compact_rank(snap: dict) -> dict:
    """The O(1)-size per-rank record a host frame carries (and the
    record ``/statusz`` renders per rank): liveness-adjacent engine
    state, lane depths, link health, byte totals, codecs, and the
    worst stalls/negotiations — everything the "which rank/link/lane?"
    question needs, nothing sized by tensor count."""
    eng = snap.get("engine") or {}
    stats = _normalize_stats(snap.get("stats") or {})
    links = snap.get("links") or []
    by_state: Dict[str, List[int]] = {}
    for l in links:
        by_state.setdefault(l.get("state", "?"), []).append(
            l.get("peer", -1))

    def trim(entries):
        rows = [{"tensor": n.get("tensor", "?"),
                 "waiting_sec": n.get("waiting_sec", 0.0),
                 "missing_ranks": n.get("missing_ranks", [])}
                for n in (entries or [])
                if n.get("missing_ranks")]
        rows.sort(key=lambda r: -r["waiting_sec"])
        return rows[:_COMPACT_CAP]

    lr = stats.get("link_reconnects") or {}
    out = {
        "rank": snap.get("rank", snap.get("process_rank", -1)),
        "host": snap.get("host", "?"),
        "running": bool(eng.get("running")),
        "broken": bool(eng.get("broken")),
        "cycles": eng.get("cycles", 0),
        "queue_depth": eng.get("queue_depth", 0),
        "pending": len(snap.get("pending") or ()),
        "lane_depth": list(stats.get("lane_depth") or ()),
        "links": {
            "healthy": len(by_state.get("healthy", ())),
            "reconnecting": sorted(by_state.get("reconnecting", ())),
            "dead": sorted(by_state.get("dead", ())),
        },
        "reconnects": {"ctrl": lr.get("ctrl", 0),
                       "data": lr.get("data", 0)},
        "bytes": {
            "ctrl_tx": stats.get("ctrl_tx_bytes", 0),
            "ctrl_rx": stats.get("ctrl_rx_bytes", 0),
            "wire_tx": sum((stats.get("wire_tx_bytes") or {}).values()),
            "ef_residual": stats.get("ef_residual_bytes", 0),
        },
        "codecs": eng.get("wire") or {},
        "stalls": trim(snap.get("stalls")),
    }
    negotiations = trim(snap.get("negotiations"))
    if negotiations:
        out["negotiations"] = negotiations
    return out


def build_snapshot(rank: int, host: str, diag: dict, stats: dict,
                   serving: Optional[dict] = None) -> dict:
    """The per-rank push payload: the raw diagnostics dict (back-compat
    with every existing ``/debugz`` consumer) + ``host``/``stats`` +
    the compact ``telemetry`` record + the mergeable ``metrics``
    frame."""
    snap = dict(diag or {})
    snap["rank"] = rank
    snap["host"] = host
    snap["stats"] = _normalize_stats(stats)
    if serving:
        snap["serving"] = serving
    snap["telemetry"] = compact_rank(snap)
    snap["metrics"] = counters_frame(rank, snap["stats"])
    # the full stats dict was only an input to the compact/metrics
    # fold; shipping it would re-inflate the payload the fold exists
    # to shrink (keep the normalized lane/link views via telemetry)
    snap.pop("stats")
    return snap


def build_host_frame(host: str, leader_rank: int,
                     members: Dict[int, dict],
                     member_age_sec: Dict[int, float],
                     period_sec: float) -> dict:
    """Fold member snapshots into the ONE frame the leader PUTs to
    ``/kv/telemetry/host/<host>``."""
    ranks = {}
    merged = _merge.merge()
    for r, snap in sorted(members.items()):
        ranks[str(r)] = snap.get("telemetry") or compact_rank(snap)
        fr = snap.get("metrics")
        if fr is None:
            fr = counters_frame(r, snap.get("stats") or {})
        try:
            merged = _merge.merge(merged, fr)
        except Exception:
            # a malformed member frame (type/layout drift, wrong
            # shapes) costs THAT member's counters, never the whole
            # host frame — its compact record above still rides
            continue
    frame = {
        "schema": TELEMETRY_SCHEMA,
        "host": host,
        "leader_rank": leader_rank,
        "interval_sec": round(period_sec, 3),
        "ranks": ranks,
        "member_age_sec": {str(r): round(a, 3)
                           for r, a in sorted(member_age_sec.items())},
        "metrics": merged,
    }
    # rank-0's arrival table rides at frame top level too: the statusz
    # straggler rules need it without walking every rank record
    for snap in members.values():
        neg = (snap.get("telemetry") or {}).get("negotiations")
        if neg:
            frame["negotiations"] = neg
            break
    return frame


# ---------------------------------------------------------------------------
# leader-side member aggregator
# ---------------------------------------------------------------------------

class HostAggregator:
    """Loopback HTTP endpoint on the host leader: members PUT their
    snapshots to ``/push/<rank>``; the leader's push tick folds the
    latest copies into one host frame. Members and leader share a host
    by construction, so the endpoint binds loopback-reachable and the
    member→leader hop never crosses the fabric."""

    def __init__(self):
        self._lock = threading.Lock()
        self._members: Dict[int, tuple] = {}  # rank -> (snap, mono_sec)
        self._server = None
        self._relay_q: List[dict] = []
        self._flush_timer: Optional[threading.Timer] = None
        # fn(envelopes) -> bool: the leader's driver-side /kvbulk flush
        # (TelemetryPusher wires it); urgent envelopes flush after a
        # short debounce so a failure report never waits a full tick
        # but a same-instant burst still folds into one request
        self.relay_sink: Optional[Callable[[list], bool]] = None

    def ingest(self, rank: int, snap: dict, now: Optional[float] = None):
        with self._lock:
            self._members[int(rank)] = (
                snap, time.monotonic() if now is None else now)

    @staticmethod
    def urgent_flush_sec() -> float:
        """Seconds an urgent envelope waits before the flush fires
        (``HVT_RELAY_FLUSH_MS``, default 250): a host losing a peer
        produces one failure/READY report per local rank, skewed by
        each rank's detection path (RST vs abort-frame vs deadline —
        sub-second, not sub-millisecond), and the debounce folds that
        burst into a couple of driver requests per host (the O(hosts)
        fan-in claim) while staying far below any recovery-path
        timescale."""
        return max(0.01, _as_float(
            os.environ.get("HVT_RELAY_FLUSH_MS"), 250.0) / 1e3)

    def relay(self, envelopes: list):
        """Queue KV envelopes from host members (``PUT /relay``); an
        urgent envelope arms a short debounce timer that drains the
        whole queue through the sink."""
        urgent = any(e.get("urgent") for e in envelopes)
        with self._lock:
            self._relay_q.extend(envelopes)
            if not (urgent and self.relay_sink is not None):
                return
            if self._flush_timer is not None:
                return  # a flush is already armed; this burst rides it
            self._flush_timer = threading.Timer(
                self.urgent_flush_sec(), self._urgent_flush)
            self._flush_timer.daemon = True
            self._flush_timer.start()

    # requeued-envelope cap: bounds leader memory when the driver is
    # down for a long stretch (oldest envelopes drop first — staler
    # telemetry loses to fresher reports)
    RELAY_QUEUE_CAP = 4096

    def _urgent_flush(self):
        with self._lock:
            self._flush_timer = None
        self.flush(self.relay_sink)

    def flush(self, sink) -> bool:
        """Drain the queue through ``sink``; a failed flush REQUEUES
        the batch (capped) — an envelope relay_put already claimed as
        delivered must survive a transiently-unreachable driver, or
        the 'delayed, never lost' contract breaks for exactly the
        READY/failure reports the recovery round waits on."""
        with self._lock:
            batch, self._relay_q = self._relay_q, []
        if not batch or sink is None:
            return True
        if sink(batch):
            return True
        with self._lock:
            self._relay_q[:0] = batch
            overflow = len(self._relay_q) - self.RELAY_QUEUE_CAP
            if overflow > 0:
                # oldest NON-urgent drop first; urgent envelopes
                # (failure/READY — the reports a recovery round blocks
                # on) are never evicted by telemetry backlog
                keep, dropped = [], 0
                for env in self._relay_q:
                    if dropped < overflow and not env.get("urgent"):
                        dropped += 1
                        continue
                    keep.append(env)
                self._relay_q = keep
        return False

    def take_relay(self) -> list:
        with self._lock:
            batch, self._relay_q = self._relay_q, []
        return batch

    def members(self, now: Optional[float] = None,
                max_age_sec: Optional[float] = None):
        """(snapshots, ages) — entries older than ``max_age_sec`` are
        dropped from the fold (the driver-side TTL sweep handles the
        frame level; this handles a member that died mid-job)."""
        now = time.monotonic() if now is None else now
        snaps, ages = {}, {}
        with self._lock:
            for r, (snap, t) in self._members.items():
                age = max(0.0, now - t)
                if max_age_sec is not None and age > max_age_sec:
                    continue
                snaps[r] = snap
                ages[r] = age
        return snaps, ages

    def start(self, port: int = 0) -> int:
        agg = self

        class Handler(BaseHTTPRequestHandler):
            def do_PUT(self):
                parts = self.path.strip("/").split("/")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if len(parts) == 2 and parts[0] == "push":
                    try:
                        agg.ingest(int(parts[1]), json.loads(body))
                    except (ValueError, TypeError):
                        self.send_response(400)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                elif parts == ["relay"]:
                    # leader-routed KV envelopes (relay_put): a JSON
                    # list of {scope, key, value_b64, urgent}
                    try:
                        envs = json.loads(body)
                        if isinstance(envs, dict):
                            envs = [envs]
                        assert all(isinstance(e, dict) and "scope" in e
                                   and "key" in e for e in envs)
                    except (ValueError, TypeError, AssertionError):
                        self.send_response(400)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    agg.relay(envs)
                    self.send_response(200)
                else:
                    self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        # loopback-only on purpose: members share the leader's host by
        # construction and dial 127.0.0.1, and this endpoint accepts
        # unauthenticated PUTs that flow straight into the host frame —
        # it must not be reachable off-host
        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    def stop(self):
        with self._lock:
            if self._flush_timer is not None:
                self._flush_timer.cancel()
                self._flush_timer = None
            server, self._server = self._server, None
        if server is not None:  # idempotent under concurrent close()
            server.shutdown()
            server.server_close()


# ---------------------------------------------------------------------------
# the push loop (all roles)
# ---------------------------------------------------------------------------

class TelemetryPusher:
    """One rank's telemetry push driver.

    - ``direct``: PUT the full snapshot to ``/kv/debugz/<rank>`` (the
      pre-aggregation wire surface, unchanged).
    - ``leader``: run a :class:`HostAggregator`, publish its endpoint
      under ``/kv/telemetry/ep/<host>``, and each tick fold own + member
      snapshots into ``/kv/telemetry/host/<host>``.
    - ``member``: discover the leader endpoint from the KV and PUT the
      snapshot to the leader; after ``_FALLBACK_AFTER`` consecutive
      failures fall back to direct pushes (re-probing the leader each
      tick) so a dead leader degrades to the star shape instead of
      going dark.

    Best-effort everywhere: a dead rendezvous server or leader must
    never disturb training.
    """

    _FALLBACK_AFTER = 3

    def __init__(self, addr: str, rank: int,
                 snapshot_fn: Callable[[], dict],
                 stop: "threading.Event",
                 host: Optional[str] = None,
                 role: Optional[str] = None,
                 period_sec: Optional[float] = None,
                 timeout: float = 3.0):
        self.addr = addr
        self.rank = int(rank)
        self.host = host or host_name()
        self.role = role or telemetry_role()
        self.period_sec = (period_sec if period_sec is not None
                           else interval_sec())
        self._snapshot_fn = snapshot_fn
        self._stop = stop
        self._timeout = timeout
        self._agg: Optional[HostAggregator] = None
        self._leader_ep: Optional[str] = None
        self._member_failures = 0
        self.pushes = 0  # introspection/tests

    # ----------------------------------------------------------- plumbing
    def _put(self, path: str, obj: dict) -> bool:
        from horovod_tpu_torch.runner.http_client import put_bytes

        try:
            put_bytes(self.addr, path, json.dumps(obj).encode(),
                      timeout=self._timeout, retries=0)
            return True
        except Exception:
            return False

    def _discover_leader(self) -> Optional[str]:
        # shares _discover_relay_ep, which also primes the relay's
        # endpoint cache: relay_put must reach the leader WITHOUT a
        # discovery GET at failure time — 100+ ranks discovering
        # simultaneously against a server already fielding the report
        # storm is what the relay exists to prevent (found live at 128
        # simulated ranks)
        return _discover_relay_ep(self.addr, self.host, self._timeout,
                                  use_miss_cache=False)

    # -------------------------------------------------------------- roles
    def _ensure_leader(self):
        global _local_aggregator
        if self._agg is None:
            self._agg = HostAggregator()
            self._agg.relay_sink = self._flush_relay
            port = self._agg.start()
            # the leader's own relay_put enqueues in-process, and the
            # endpoint cache is seeded so members never need the
            # discovery GET mid-storm
            _local_aggregator = self._agg
            _relay_ep_cache[self.host] = f"127.0.0.1:{port}"

    def _flush_relay(self, envelopes: list) -> bool:
        """Batch queued member KV envelopes into ONE driver request
        (``PUT /kvbulk``). On a bulk failure, degrade to per-entry
        direct PUTs — a failure report may cost extra requests in that
        corner, but is never dropped."""
        if not envelopes:
            return True
        from horovod_tpu_torch.runner.http_client import put_bytes

        try:
            put_bytes(self.addr, "/kvbulk",
                      json.dumps(envelopes).encode(),
                      timeout=self._timeout, retries=0)
            return True
        except Exception:
            pass
        import base64

        ok = True
        for env in envelopes:
            try:
                put_bytes(self.addr,
                          f"/kv/{env['scope']}/{env['key']}",
                          base64.b64decode(env.get("value_b64") or ""),
                          timeout=self._timeout, retries=0)
            except Exception:
                ok = False
        return ok

    def step(self) -> bool:
        """One push tick; returns True when the snapshot reached its
        destination (server, leader, or fallback server)."""
        try:
            snap = self._snapshot_fn()
        except Exception:
            return False
        ok = False
        if self.role == "leader":
            self._ensure_leader()
            # re-published every tick: ~60 bytes of insurance against
            # an elastic rendezvous restart losing the endpoint key
            self._put(f"/kv/{TELEMETRY_SCOPE}/ep/{self.host}",
                      {"addr": f"127.0.0.1:{self._agg.port}",
                       "rank": self.rank})
            self._agg.ingest(self.rank, snap)
            members, ages = self._agg.members(
                max_age_sec=max(10 * self.period_sec, 30.0))
            frame = build_host_frame(self.host, self.rank, members,
                                     ages, self.period_sec)
            ok = self._put(f"/kv/{TELEMETRY_SCOPE}/host/{self.host}",
                           frame)
            # drain the leader-routed KV envelopes members queued since
            # the last tick (urgent ones already debounce-flushed);
            # a failed flush requeues so no report is ever dropped
            self._agg.flush(self._flush_relay)
        elif self.role == "member":
            ok = self._push_member(snap)
        else:
            ok = self._put(f"/kv/debugz/{self.rank}", snap)
        if ok:
            self.pushes += 1
        return ok

    def _push_member(self, snap: dict) -> bool:
        from horovod_tpu_torch.runner.http_client import put_bytes

        if self._leader_ep is None:
            self._leader_ep = self._discover_leader()
        if self._leader_ep is not None:
            try:
                put_bytes(self._leader_ep, f"/push/{self.rank}",
                          json.dumps(snap).encode(),
                          timeout=self._timeout, retries=0)
                self._member_failures = 0
                return True
            except Exception:
                self._member_failures += 1
                self._leader_ep = None  # re-discover next tick
        else:
            self._member_failures += 1
        if self._member_failures >= self._FALLBACK_AFTER:
            # leader gone: degrade to the star shape rather than dark
            return self._put(f"/kv/debugz/{self.rank}", snap)
        return False

    def close(self):
        """Tear down the leader-side aggregator endpoint (harnesses
        that drive :meth:`step` manually call this at exit). Queued
        relay envelopes flush first — teardown must not eat a report."""
        global _local_aggregator
        if self._agg is not None:
            try:
                self._agg.flush(self._flush_relay)
            except Exception:
                pass
            if _local_aggregator is self._agg:
                _local_aggregator = None
            self._agg.stop()
            self._agg = None

    def run(self):
        """The loop ``common/basics.py`` parks in a daemon thread:
        jittered period, exits on the stop event, final aggregator
        teardown on the way out. Best-effort to the letter: a raising
        tick (a member PUTting a malformed snapshot that breaks the
        leader's merge, a bind failure, ...) must cost ONE window, not
        kill the thread and go dark for the rest of the job."""
        try:
            while True:
                try:
                    self.step()
                except Exception:
                    pass
                if self._stop.wait(jittered(self.period_sec)):
                    return
        finally:
            self.close()


# ---------------------------------------------------------------------------
# health rules
# ---------------------------------------------------------------------------

class HealthEngine:
    """Rolling-window health rules over successive gang observations.

    Rules (all thresholds env-tunable, defaults conservative):

    - ``straggler`` — the same rank appears as straggler evidence
      (missing from a negotiation waiting ≥ ``STRAGGLER_MIN_WAIT_SEC``)
      in ``HVT_HEALTH_STRAGGLER_WINDOWS`` consecutive windows.
    - ``reconnect_storm`` — ≥ ``HVT_HEALTH_RECONNECT_STORM`` link
      reconnects summed over the last 3 windows (a link flapping
      faster than it carries traffic).
    - ``push_stale`` — a rank's last snapshot is older than
      ``HVT_HEALTH_STALE_INTERVALS`` push intervals (the worker died,
      wedged, or lost the rendezvous server).
    - ``serving_backlog`` — the gang-wide serving backlog grew strictly
      across ``HVT_HEALTH_BACKLOG_WINDOWS`` consecutive windows
      (sustained overload, the autoscaler's scale-out cue).

    ``observe()`` ingests at most once per half push-interval — the
    rules advance with *pushed data*, not with scrape frequency, so a
    dashboard polling ``/statusz`` at 10 Hz cannot fast-forward a
    persistence window. Newly-firing rules increment
    ``hvt_health_alerts_total{rule}``; an alert stays in the active
    list while its condition holds.
    """

    RECONNECT_LOOKBACK = 3

    def __init__(self, straggler_windows: Optional[int] = None,
                 reconnect_storm: Optional[int] = None,
                 stale_intervals: Optional[float] = None,
                 backlog_windows: Optional[int] = None,
                 alert_counter=None):
        self.straggler_windows = int(
            straggler_windows if straggler_windows is not None
            else _as_float(
                os.environ.get("HVT_HEALTH_STRAGGLER_WINDOWS"), 3))
        self.reconnect_storm = int(
            reconnect_storm if reconnect_storm is not None
            else _as_float(
                os.environ.get("HVT_HEALTH_RECONNECT_STORM"), 3))
        self.stale_intervals = float(
            stale_intervals if stale_intervals is not None
            else _as_float(
                os.environ.get("HVT_HEALTH_STALE_INTERVALS"), 3))
        self.backlog_windows = int(
            backlog_windows if backlog_windows is not None
            else _as_float(
                os.environ.get("HVT_HEALTH_BACKLOG_WINDOWS"), 3))
        self._alert_counter = alert_counter
        self._last_ingest: Optional[float] = None
        self._straggler_consec: Dict[int, int] = {}
        self._straggler_tensors: Dict[int, List[str]] = {}
        self._straggler_windows_seen: Dict[int, int] = {}
        self._reconnect_prev: Optional[float] = None
        self._reconnect_deltas: List[float] = []
        self._backlogs: List[float] = []
        self._active: Dict[tuple, dict] = {}
        self._alerts: List[dict] = []
        self.windows = 0

    # ------------------------------------------------------------ internals
    def _counter(self):
        if self._alert_counter is not None:
            return self._alert_counter
        try:
            from horovod_tpu_torch import metrics as _metrics

            return _metrics.counter(
                "hvt_health_alerts_total",
                "gang health-rule activations by rule (statusz health "
                "engine; incremented when a rule newly fires)", ("rule",))
        except Exception:
            return None

    def _set_active(self, now: float, fired: Dict[tuple, dict]):
        for key, alert in fired.items():
            prev = self._active.get(key)
            if prev is None:
                alert["since_sec"] = 0.0
                alert["_since"] = now
                c = self._counter()
                if c is not None:
                    try:
                        c.labels(rule=alert["rule"]).inc()
                    except Exception:
                        pass
            else:
                alert["_since"] = prev["_since"]
                alert["since_sec"] = round(now - prev["_since"], 1)
        self._active = fired
        self._alerts = [
            {k: v for k, v in a.items() if not k.startswith("_")}
            for _, a in sorted(fired.items())]

    # -------------------------------------------------------------- observe
    def observe(self, obs: dict, now: Optional[float] = None) -> list:
        """Ingest one gang observation; returns the active alerts.

        ``obs`` keys: ``interval_sec``, ``stragglers`` ({rank:
        [tensors]}), ``reconnect_total`` (gang-wide cumulative),
        ``rank_ages`` ({rank: age_sec}), ``backlog`` (float),
        ``ranks_expected`` / ``ranks_covered`` (ints, optional)."""
        now = time.monotonic() if now is None else now
        ival = float(obs.get("interval_sec") or interval_sec())
        if (self._last_ingest is not None
                and now - self._last_ingest < 0.5 * ival):
            return self.alerts()
        self._last_ingest = now
        self.windows += 1

        # straggler persistence
        stragglers = {int(r): list(ts)
                      for r, ts in (obs.get("stragglers") or {}).items()}
        for r in list(self._straggler_consec):
            if r not in stragglers:
                self._straggler_consec[r] = 0
        for r, tensors in stragglers.items():
            self._straggler_consec[r] = self._straggler_consec.get(r, 0) + 1
            self._straggler_windows_seen[r] = \
                self._straggler_windows_seen.get(r, 0) + 1
            self._straggler_tensors[r] = tensors[:4]

        # reconnect storm (deltas of the gang-wide cumulative counter)
        total = float(obs.get("reconnect_total") or 0)
        if self._reconnect_prev is not None:
            # an engine restart resets counters; a negative delta is a
            # new epoch, not -N reconnects
            self._reconnect_deltas.append(
                max(0.0, total - self._reconnect_prev))
            self._reconnect_deltas = \
                self._reconnect_deltas[-self.RECONNECT_LOOKBACK:]
        self._reconnect_prev = total

        # serving backlog growth
        self._backlogs.append(float(obs.get("backlog") or 0))
        self._backlogs = self._backlogs[-(self.backlog_windows + 1):]

        fired: Dict[tuple, dict] = {}
        for r, n in self._straggler_consec.items():
            if n >= self.straggler_windows:
                fired[("straggler", r)] = {
                    "rule": "straggler", "severity": "warn",
                    "subject": f"rank {r}", "windows": n,
                    "detail": (f"rank {r} missing from negotiations in "
                               f"{n} consecutive window(s); tensors: "
                               f"{self._straggler_tensors.get(r, [])}")}
        storm = sum(self._reconnect_deltas)
        if self.reconnect_storm > 0 and storm >= self.reconnect_storm:
            fired[("reconnect_storm", 0)] = {
                "rule": "reconnect_storm", "severity": "warn",
                "subject": "links", "windows": len(self._reconnect_deltas),
                "detail": (f"{storm:.0f} link reconnect(s) in the last "
                           f"{len(self._reconnect_deltas)} window(s)")}
        stale_after = self.stale_intervals * ival
        for r, age in sorted((obs.get("rank_ages") or {}).items()):
            if age is not None and age > stale_after:
                fired[("push_stale", int(r))] = {
                    "rule": "push_stale", "severity": "page",
                    "subject": f"rank {r}", "windows": 1,
                    "detail": (f"rank {r} last pushed {age:.1f}s ago "
                               f"(> {stale_after:.1f}s = "
                               f"{self.stale_intervals:g} intervals)")}
        if (len(self._backlogs) >= self.backlog_windows + 1
                and self._backlogs[-1] > 0
                and all(b > a for a, b in zip(self._backlogs,
                                              self._backlogs[1:]))):
            fired[("serving_backlog", 0)] = {
                "rule": "serving_backlog", "severity": "warn",
                "subject": "serving", "windows": self.backlog_windows,
                "detail": (f"serving backlog grew "
                           f"{self._backlogs[0]:.0f} -> "
                           f"{self._backlogs[-1]:.0f} over "
                           f"{self.backlog_windows} window(s)")}
        self._set_active(now, fired)
        return self.alerts()

    def alerts(self) -> list:
        return list(self._alerts)

    def straggler_ranking(self, top_k: int = 5) -> list:
        """Ranks by how many windows they appeared as stragglers —
        the /statusz ``stragglers`` section."""
        rows = [{"rank": r, "windows": n,
                 "consecutive": self._straggler_consec.get(r, 0),
                 "tensors": self._straggler_tensors.get(r, [])}
                for r, n in self._straggler_windows_seen.items() if n]
        rows.sort(key=lambda d: (-d["windows"], d["rank"]))
        return rows[:top_k]


# ---------------------------------------------------------------------------
# /statusz rollup
# ---------------------------------------------------------------------------

class StatuszBuilder:
    """The driver-side gang rollup behind ``GET /statusz``.

    Holds the rolling state one scrape surface needs: the
    :class:`HealthEngine` and the previous byte totals for rate
    computation. ``build()`` is pure over (store view, world, clock) —
    tests drive it with fake stores and synthetic clocks."""

    def __init__(self, health: Optional[HealthEngine] = None):
        self.health = health or HealthEngine()
        self._prev_totals = None  # (now, {metric: value})

    # store duck-type: keys(scope), get(scope, key), age(scope, key)
    def _rank_records(self, store, now):
        """{rank: (compact_record, age_sec, source)} from host frames
        (leader mode) and direct debugz keys (star mode); when a rank
        appears in both, the fresher copy wins."""
        records: Dict[int, tuple] = {}
        interval = None
        negotiations = []
        hosts = {}
        for key in store.keys(TELEMETRY_SCOPE):
            if not key.startswith("host/"):
                continue
            raw = store.get(TELEMETRY_SCOPE, key)
            try:
                frame = json.loads(raw)
            except (ValueError, TypeError):
                continue
            age = _store_age(store, TELEMETRY_SCOPE, key, now)
            interval = frame.get("interval_sec") or interval
            hosts[frame.get("host", key[5:])] = {
                "leader_rank": frame.get("leader_rank"),
                "age_sec": round(age, 1) if age is not None else None,
                "ranks": sorted(int(r) for r in frame.get("ranks", {})),
                "metrics": frame.get("metrics"),
            }
            negotiations.extend((n, age or 0.0)
                                for n in frame.get("negotiations") or ())
            for r_str, rec in (frame.get("ranks") or {}).items():
                r = int(r_str)
                r_age = (age or 0.0) + float(
                    (frame.get("member_age_sec") or {}).get(r_str, 0.0))
                prev = records.get(r)
                if prev is None or r_age < prev[1]:
                    records[r] = (rec, r_age, "leader")
        for key in store.keys("debugz"):
            raw = store.get("debugz", key)
            try:
                snap = json.loads(raw)
                r = int(key)
            except (ValueError, TypeError):
                continue
            if not isinstance(snap, dict):
                continue
            age = _store_age(store, "debugz", key, now) or 0.0
            rec = snap.get("telemetry") or compact_rank(snap)
            prev = records.get(r)
            if prev is None or age < prev[1]:
                records[r] = (rec, age, "direct")
            negotiations.extend((n, age)
                                for n in rec.get("negotiations") or ())
        return records, hosts, negotiations, interval

    def build(self, store, world: dict, round_: int,
              now: Optional[float] = None,
              server_stats: Optional[dict] = None) -> dict:
        now = time.monotonic() if now is None else now
        records, hosts, negotiations, ival = self._rank_records(store, now)
        ival = float(ival or interval_sec())
        stale_after = self.health.stale_intervals * ival

        ranks = {}
        rank_ages = {}
        mode_sources = set()
        codecs_intra, codecs_inter = set(), set()
        totals = {"ctrl_bytes": 0.0, "wire_bytes": 0.0,
                  "ef_residual_bytes": 0.0}
        reconnect_total = 0.0
        for r, (rec, age, source) in sorted(records.items()):
            mode_sources.add(source)
            rank_ages[r] = age
            b = rec.get("bytes") or {}
            totals["ctrl_bytes"] += b.get("ctrl_tx", 0) + b.get("ctrl_rx", 0)
            totals["wire_bytes"] += b.get("wire_tx", 0)
            totals["ef_residual_bytes"] += b.get("ef_residual", 0)
            rc = rec.get("reconnects") or {}
            reconnect_total += rc.get("ctrl", 0) + rc.get("data", 0)
            wire = rec.get("codecs") or {}
            if wire.get("intra"):
                codecs_intra.add(wire["intra"])
            if wire.get("inter"):
                codecs_inter.add(wire["inter"])
            ranks[str(r)] = dict(rec, age_sec=round(age, 1),
                                 stale=age > stale_after, source=source)

        # recovery scope: worker recovery-phase reports (elastic/run.py
        # PUTs one per phase transition) — the "where is the gang in
        # its recovery?" rows. Kept across round resets and TTL-swept,
        # so a finished recovery ages out instead of reading forever.
        recovery = {"reports": 0, "by_phase": {}, "by_outcome": {},
                    "ranks": {}, "max_seconds": 0.0}
        for key in store.keys("recovery"):
            raw = store.get("recovery", key)
            try:
                body = json.loads(raw)
                assert isinstance(body, dict)
            except (ValueError, TypeError, AssertionError):
                continue
            age = _store_age(store, "recovery", key, now)
            phase = str(body.get("phase", "?"))
            outcome = str(body.get("outcome", "?"))
            recovery["reports"] += 1
            recovery["by_phase"][phase] = \
                recovery["by_phase"].get(phase, 0) + 1
            recovery["by_outcome"][outcome] = \
                recovery["by_outcome"].get(outcome, 0) + 1
            recovery["max_seconds"] = max(
                recovery["max_seconds"],
                float(body.get("seconds") or 0.0))
            if len(recovery["ranks"]) < 32:
                recovery["ranks"][key] = {
                    "phase": phase, "outcome": outcome,
                    "round": body.get("round"),
                    "seconds": body.get("seconds"),
                    "age_sec": round(age, 1) if age is not None
                    else None}

        # serving scope: per-rank ReplicaGang snapshots. The entries get
        # the same last-write-timestamp treatment as the rank records —
        # a dead/shed rank's final push (the scope survives round
        # resets by design, and the TTL sweep takes up to HVT_KV_TTL_SEC
        # to retire it) reads as STALE and is excluded from the live
        # backlog signal instead of pinning it high: the health
        # engine's serving_backlog rule and the autoscaler both consume
        # inflight_max, so a ghost lane here was a ghost scale-out
        # there. Out-of-world rank ids (a re-shard shrank the gang) are
        # excluded the same way.
        serving = {"ranks": 0, "stale_ranks": 0, "inflight_max": 0,
                   "shed_total": 0, "lanes": {}}
        world_size = int(world.get("size") or 0)
        for key in store.keys("serving"):
            raw = store.get("serving", key)
            age = _store_age(store, "serving", key, now)
            try:
                body = json.loads(raw)
                rank_id = int(body.get("rank", key))
                ghost = ((age is not None and age > stale_after)
                         or (world_size and rank_id >= world_size))
                if ghost:
                    serving["stale_ranks"] += 1
                    continue
                serving["ranks"] += 1
                serving["inflight_max"] = max(serving["inflight_max"],
                                              int(body.get("inflight", 0)))
                serving["shed_total"] += int(body.get("shed", 0))
                lane = str(body.get("replica", "?"))
                row = serving["lanes"].setdefault(
                    lane, {"ranks": 0, "inflight_max": 0, "shed": 0,
                           "p99_ms_max": 0.0})
                row["ranks"] += 1
                row["inflight_max"] = max(row["inflight_max"],
                                          int(body.get("inflight", 0)))
                row["shed"] += int(body.get("shed", 0))
                row["p99_ms_max"] = max(row["p99_ms_max"],
                                        float(body.get("p99_ms", 0.0)))
            except (ValueError, TypeError, AttributeError):
                continue

        expected = int(world.get("size") or 0)
        covered = sorted(records)
        missing = [r for r in range(expected) if r not in records]

        # straggler evidence for the health engine: negotiations past
        # the wait floor name their missing ranks. STALE sources are
        # excluded — a dead pusher's frozen arrival table would
        # otherwise re-feed the same transient negotiation every
        # window and fire a false straggler alert against ranks that
        # are perfectly healthy.
        stragglers: Dict[int, List[str]] = {}
        for n, n_age in negotiations:
            if n_age > stale_after:
                continue
            if float(n.get("waiting_sec", 0)) < STRAGGLER_MIN_WAIT_SEC:
                continue
            for r in n.get("missing_ranks", ()):
                stragglers.setdefault(int(r), []).append(
                    n.get("tensor", "?"))

        alerts = self.health.observe({
            "interval_sec": ival,
            "stragglers": stragglers,
            "reconnect_total": reconnect_total,
            "rank_ages": rank_ages,
            "backlog": serving["inflight_max"],
            "ranks_expected": expected,
            "ranks_covered": len(covered),
        }, now=now)

        rates = {"window_sec": None, "ctrl_bytes_per_sec": None,
                 "wire_bytes_per_sec": None}
        if self._prev_totals is not None:
            prev_now, prev = self._prev_totals
            dt = now - prev_now
            if dt > 0.05:
                rates["window_sec"] = round(dt, 2)
                rates["ctrl_bytes_per_sec"] = round(
                    max(0.0, totals["ctrl_bytes"] - prev["ctrl_bytes"])
                    / dt, 1)
                rates["wire_bytes_per_sec"] = round(
                    max(0.0, totals["wire_bytes"] - prev["wire_bytes"])
                    / dt, 1)
        self._prev_totals = (now, dict(totals))

        mode = ("mixed" if len(mode_sources) > 1 else
                "leader" if "leader" in mode_sources else "direct")
        out = {
            "schema": STATUSZ_SCHEMA,
            "world": dict(world or {}),
            "round": round_,
            "mode": mode,
            "interval_sec": round(ival, 3),
            "ranks_expected": expected,
            "ranks_covered": len(covered),
            "missing_ranks": missing,
            "hosts": hosts,
            "ranks": ranks,
            "stragglers": self.health.straggler_ranking(),
            "rates": dict(rates,
                          ef_residual_bytes=totals["ef_residual_bytes"]),
            "totals": {k: int(v) for k, v in totals.items()},
            "reconnect_total": int(reconnect_total),
            "codecs": {"intra": sorted(codecs_intra),
                       "inter": sorted(codecs_inter)},
            "serving": serving,
            "recovery": recovery,
            "alerts": alerts,
            "health_windows": self.health.windows,
        }
        if server_stats:
            # scrape-cost self-accounting (put bytes per scope)
            out["ingest"] = server_stats
        return out


def _store_age(store, scope, key, now):
    age_fn = getattr(store, "age", None)
    if age_fn is None:
        return None
    try:
        return age_fn(scope, key, now)
    except TypeError:
        return age_fn(scope, key)
