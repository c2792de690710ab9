"""horovod_tpu_torch's fleet plane held against the JAX package's.

- The pure cases of ``tests/test_telemetry.py`` (snapshots, host frames,
  the aggregator, pushers, the relay, ``/kvbulk``, the store's stamps and
  TTL sweep, ``/statusz`` and its health rules, the autoscaler's feeds at
  ``:636-718``) run against both packages, each on its own rendezvous
  server; for the same inputs the two give byte-identical JSON.
- The port's own parts: its ``HVT_TELEMETRY_AGG=auto`` (direct), the
  collective families of its counter frame, a world's snapshot from its
  metrics registry, the push loop that ``init`` starts and ``shutdown``
  stops, the elastic reports through a host leader with the direct
  fallback, and a launched elastic gloo gang of two that the autoscaler
  grows to three on a sustained backlog in the ``serving`` scope.
"""

import base64
import importlib
import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import torch_port_elastic_worker as EW

PKGS = {"jax": "horovod_tpu", "torch": "horovod_tpu_torch"}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    root = PKGS[request.param]
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    return types.SimpleNamespace(
        name=request.param, T=mod("metrics.telemetry"),
        M=mod("metrics.merge"), http=mod("runner.http_server"),
        client=mod("runner.http_client"),
        auto=mod("runner.elastic.autoscaler"))


class _Slot:
    def __init__(self, hostname, rank, local_rank, local_size, size,
                 cross_size):
        self.hostname, self.rank, self.local_rank = hostname, rank, local_rank
        self.local_size, self.size, self.cross_size = (local_size, size,
                                                       cross_size)
        self.cross_rank = rank // local_size


def _server(pkg, np_=2, hosts=1):
    per_host = max(1, np_ // hosts)
    slots = [_Slot(f"h{min(r // per_host, hosts - 1)}", r, r % per_host,
                   per_host, np_, hosts) for r in range(np_)]
    server = pkg.http.RendezvousServer() if pkg.name == "jax" else \
        pkg.http.RendezvousServer(lambda s, r: 0)
    server.init(slots)
    port = server.start(0)
    return server, f"127.0.0.1:{port}"


def _diag(rank=0, queue=2, negotiations=None, links=None):
    return {
        "engine": {"running": True, "rank": rank, "size": 4,
                   "cycles": 10, "queue_depth": queue,
                   "wire": {"intra": "none", "inter": "int8",
                            "auto": False},
                   "broken": False},
        "pending": [{"tensor": "t", "age_sec": 0.1, "lane": 0}],
        "links": links or [],
        "negotiations": negotiations or [],
        "stalls": [],
    }


STATS = {"cycles": 10, "cache_hits": 1, "ctrl_tx_bytes": 100,
         "ctrl_rx_bytes": 60, "wire_tx_bytes": {"allreduce": 40},
         "lane_depth": [2, 0, 0, 0, 0, 0, 0, 0],
         "link_reconnects": {"ctrl": 0, "data": 1},
         "ef_residual_bytes": 8}
LINKS = [{"peer": 1, "plane": "data", "state": "healthy", "retries": 0,
          "epoch": 0, "in_state_sec": 1.0},
         {"peer": 2, "plane": "data", "state": "reconnecting", "retries": 1,
          "epoch": 1, "in_state_sec": 0.2}]
NEG = [{"tensor": "x", "waiting_sec": 0.9, "missing_ranks": [3],
        "arrived_ranks": [0, 1, 2]},
       {"tensor": "y", "waiting_sec": 0.1, "missing_ranks": [],
        "arrived_ranks": [0, 1, 2, 3]}]


# ------------------------------------------------------------------- units

def test_interval_env_and_jitter(pkg, monkeypatch):
    monkeypatch.delenv("HVT_DEBUGZ_INTERVAL_MS", raising=False)
    assert pkg.T.interval_sec() == 5.0
    monkeypatch.setenv("HVT_DEBUGZ_INTERVAL_MS", "800")
    assert pkg.T.interval_sec() == 0.8
    vals = {pkg.T.jittered(4.0) for _ in range(200)}
    assert all(3.0 <= v <= 5.0 for v in vals) and len(vals) > 100


def test_role_matrix_shared_cases(pkg, monkeypatch):
    T = pkg.T
    for var in ("HVT_TELEMETRY_ROLE", "HVT_TELEMETRY_AGG",
                "HVT_CTRL_TOPOLOGY", "HVT_LOCAL_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HVT_LOCAL_PROCESS_ID", "0")
    assert T.telemetry_role() == "direct"           # auto, no tree
    monkeypatch.setenv("HVT_TELEMETRY_AGG", "1")
    assert T.telemetry_role() == "leader"
    monkeypatch.setenv("HVT_LOCAL_PROCESS_ID", "2")
    assert T.telemetry_role() == "member"
    monkeypatch.setenv("HVT_TELEMETRY_AGG", "0")
    assert T.telemetry_role() == "direct"
    monkeypatch.setenv("HVT_TELEMETRY_AGG", "1")
    monkeypatch.setenv("HVT_LOCAL_PROCESS_ID", "not-a-number")
    assert T.telemetry_role() == "direct"
    monkeypatch.delenv("HVT_LOCAL_PROCESS_ID")
    assert T.telemetry_role() == "direct"
    monkeypatch.setenv("HVT_TELEMETRY_ROLE", "leader")
    assert T.telemetry_role() == "leader"


def test_port_agg_auto_is_direct_even_under_a_tree_topology(monkeypatch):
    """The departure: the port has no tree control plane, so ``auto``
    never elects leaders; the JAX package's does under
    HVT_CTRL_TOPOLOGY=tree."""
    from horovod_tpu.metrics import telemetry as jT
    from horovod_tpu_torch.metrics import telemetry as tT

    monkeypatch.delenv("HVT_TELEMETRY_ROLE", raising=False)
    monkeypatch.delenv("HVT_TELEMETRY_AGG", raising=False)
    monkeypatch.setenv("HVT_CTRL_TOPOLOGY", "tree")
    monkeypatch.setenv("HVT_LOCAL_PROCESS_ID", "0")
    assert jT.telemetry_role() == "leader"
    assert tT.telemetry_role() == "direct"


def test_normalize_stats_flat_manifest_form(pkg):
    flat = {"cycles": 7, "ctrl_tx_bytes": 9,
            "lane_depth[0]": 1, "lane_depth[2]": 5,
            "wire_tx_bytes[allreduce]": 10,
            "wire_tx_bytes[allgather]": 3,
            "link_reconnects[ctrl]": 1, "link_reconnects[data]": 2}
    out = pkg.T._normalize_stats(flat)
    assert out["lane_depth"] == [1, 0, 5]
    assert out["wire_tx_bytes"] == {"allreduce": 10, "allgather": 3}
    assert out["link_reconnects"] == {"ctrl": 1, "data": 2}
    dec = {"lane_depth": [1, 2], "cycles": 3}
    assert pkg.T._normalize_stats(dec) == dec


def test_build_snapshot_compact_and_counters(pkg):
    snap = pkg.T.build_snapshot(0, "h0", _diag(negotiations=NEG,
                                               links=LINKS), STATS)
    tel = snap["telemetry"]
    assert tel["queue_depth"] == 2 and tel["pending"] == 1
    assert tel["links"]["reconnecting"] == [2]
    assert tel["links"]["healthy"] == 1
    assert tel["bytes"] == {"ctrl_tx": 100, "ctrl_rx": 60,
                            "wire_tx": 40, "ef_residual": 8}
    assert [n["tensor"] for n in tel["negotiations"]] == ["x"]
    assert "stats" not in snap
    assert pkg.M.counter_total(snap["metrics"],
                               "hvt_ctrl_tx_bytes_total") == 100


class _FakeStore:
    """The store duck type StatuszBuilder reads, with fixed ages."""

    def __init__(self, entries):
        self.entries = entries      # {(scope, key): (bytes, age)}

    def keys(self, scope):
        return [k for s, k in self.entries if s == scope]

    def get(self, scope, key):
        return self.entries[(scope, key)][0]

    def age(self, scope, key, now=None):
        return self.entries[(scope, key)][1]


def test_json_is_byte_identical_across_packages():
    """The same inputs through both packages' snapshot, counter frame,
    compact record, host frame and /statusz fold give the same JSON."""
    from horovod_tpu.metrics import telemetry as jT
    from horovod_tpu_torch.metrics import telemetry as tT

    def run(T):
        snaps = {r: T.build_snapshot(r, "h0", _diag(
            rank=r, queue=r, negotiations=NEG, links=LINKS), STATS)
            for r in range(3)}
        frame = T.build_host_frame("h0", 0, snaps, {0: 0.1, 1: 0.2, 2: 0.3},
                                   1.0)
        direct = T.build_snapshot(3, "h1", _diag(rank=3), {})
        store = _FakeStore({
            ("telemetry", "host/h0"): (json.dumps(frame).encode(), 0.5),
            ("debugz", "3"): (json.dumps(direct).encode(), 9.0),
            ("serving", "0"): (json.dumps({"rank": 0, "replica": 0,
                                           "inflight": 4, "shed": 1,
                                           "p99_ms": 2.5}).encode(), 0.1),
            ("recovery", "h0/0"): (json.dumps(
                {"phase": "rebuild", "outcome": "ok", "seconds": 0.4,
                 "round": 2}).encode(), 1.0)})
        builder = T.StatuszBuilder(T.HealthEngine(alert_counter=False))
        docs = [builder.build(store, {"size": 5, "hosts": ["h0", "h1"]}, 2,
                              now=100.0 + 2 * i) for i in range(3)]
        return [snaps, frame, T.counters_frame(0, STATS),
                T.compact_rank(snaps[0]), docs]

    assert json.dumps(run(jT)) == json.dumps(run(tT))


def test_port_counter_frame_adds_the_collective_families():
    from horovod_tpu_torch.metrics import merge as M
    from horovod_tpu_torch.metrics import telemetry as tT

    assert "hvt_collective_bytes_total" not in \
        tT.counters_frame(0, STATS)["metrics"]
    fr = tT.counters_frame(0, dict(STATS, collective_bytes={
        "allreduce": 64, "grouped_allreduce": 4096},
        collective_count={"allreduce": 2}))
    fams = fr["metrics"]
    assert M.counter_total(fr, "hvt_collective_bytes_total") == 4160
    assert [s["labels"] for s in fams["hvt_collectives_total"]["samples"]] \
        == [{"op": "allreduce"}]


def test_host_frame_merge_is_sum_identical(pkg):
    T = pkg.T
    members, ages = {}, {}
    for r, ctrl in ((0, 100), (1, 250), (2, 13)):
        members[r] = T.build_snapshot(r, "h0", _diag(rank=r),
                                      {"ctrl_tx_bytes": ctrl})
        ages[r] = 0.1 * r
    frame = T.build_host_frame("h0", 0, members, ages, 5.0)
    assert sorted(int(r) for r in frame["ranks"]) == [0, 1, 2]
    assert pkg.M.counter_total(frame["metrics"],
                               "hvt_ctrl_tx_bytes_total") == 363
    assert frame["metrics"]["ranks"] == [0, 1, 2]


def test_host_aggregator_http_ingest(pkg):
    agg = pkg.T.HostAggregator()
    port = agg.start()
    try:
        pkg.client.put_bytes(f"127.0.0.1:{port}", "/push/3",
                             json.dumps({"rank": 3, "x": 1}).encode(),
                             retries=0)
        snaps, ages = agg.members()
        assert snaps[3]["x"] == 1 and ages[3] < 5
        req = urllib.request.Request(f"http://127.0.0.1:{port}/push/4",
                                     data=b"{nope", method="PUT")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(req, timeout=5)
        snaps, _ = agg.members(now=time.monotonic() + 1e4, max_age_sec=60)
        assert snaps == {}
    finally:
        agg.stop()


def test_pusher_direct_and_leader_member_roundtrip(pkg):
    T = pkg.T
    server, addr = _server(pkg, np_=3)
    stop = threading.Event()
    leader = None
    try:
        snap_of = lambda r: (lambda: T.build_snapshot(  # noqa: E731
            r, "h0", _diag(rank=r), {"ctrl_tx_bytes": 10 * (r + 1)}))
        leader = T.TelemetryPusher(addr, 0, snap_of(0), stop, host="h0",
                                   role="leader", period_sec=0.2)
        assert leader.step()
        ep = json.loads(server.store.get("telemetry", "ep/h0"))
        assert ep["rank"] == 0 and ep["addr"].startswith("127.0.0.1:")
        member = T.TelemetryPusher(addr, 1, snap_of(1), stop, host="h0",
                                   role="member", period_sec=0.2)
        assert member.step()
        assert leader.step()
        frame = json.loads(server.store.get("telemetry", "host/h0"))
        assert sorted(frame["ranks"]) == ["0", "1"]
        assert pkg.M.counter_total(frame["metrics"],
                                   "hvt_ctrl_tx_bytes_total") == 30
        direct = T.TelemetryPusher(addr, 2, snap_of(2), stop, host="h0",
                                   role="direct", period_sec=0.2)
        assert direct.step()
        assert server.store.get("debugz", "2") is not None
    finally:
        stop.set()
        if leader is not None:
            leader.close()
        server.stop()


def test_member_falls_back_to_direct_when_leader_dies(pkg):
    T = pkg.T
    server, addr = _server(pkg, np_=2)
    stop = threading.Event()
    try:
        member = T.TelemetryPusher(
            addr, 1, lambda: T.build_snapshot(1, "h0", _diag(rank=1), {}),
            stop, host="h0", role="member", period_sec=0.1)
        for _ in range(member._FALLBACK_AFTER - 1):
            assert not member.step()
        assert member.step()
        assert server.store.get("debugz", "1") is not None
    finally:
        stop.set()
        server.stop()


# ------------------------------------------------------------------ relay

def test_relay_put_direct_when_disabled(pkg, monkeypatch):
    monkeypatch.setenv("HVT_KV_RELAY", "0")
    server, addr = _server(pkg, np_=1)
    try:
        assert pkg.T.relay_put(addr, "failure", "h0/0", {"round": 1})
        assert json.loads(server.store.get("failure", "h0/0")) == \
            {"round": 1}
        assert server.store.ingest_stats()["put_requests"]["failure"] == 1
    finally:
        server.stop()


def test_relay_routes_through_leader_and_kvbulk(pkg, monkeypatch):
    T = pkg.T
    monkeypatch.setenv("HVT_KV_RELAY", "1")
    monkeypatch.setenv("HVT_TOPO_HOST", "h0")
    T._relay_ep_cache.clear()
    server, addr = _server(pkg, np_=2)
    stop = threading.Event()
    leader = T.TelemetryPusher(addr, 0, lambda: {"rank": 0}, stop,
                               host="h0", role="leader", period_sec=0.2)
    try:
        leader.step()
        hook_hits = []
        server.set_put_hook(lambda scope, key, val:
                            hook_hits.append((scope, key)))
        assert T.relay_put(addr, "failure", "h0/0", {"failed_ranks": [1]},
                           urgent=True)
        assert T.relay_put(addr, "state", "h0/0",
                           {"state": "READY", "round": 1}, urgent=True)
        deadline = time.monotonic() + 5
        while server.store.get("state", "h0/0") is None:
            assert time.monotonic() < deadline, "bulk flush never landed"
            time.sleep(0.02)
        assert json.loads(server.store.get("failure", "h0/0")) == \
            {"failed_ranks": [1]}
        assert ("failure", "h0/0") in hook_hits
        assert ("state", "h0/0") in hook_hits
        reqs = server.store.ingest_stats()["put_requests"]
        assert reqs.get("failure", 0) == 1 and reqs.get("state", 0) == 1
        assert T.relay_put(addr, "recovery", "h0/0",
                           {"phase": "rebuild", "outcome": "ok"})
        assert server.store.get("recovery", "h0/0") is None
        leader.step()
        assert server.store.get("recovery", "h0/0") is not None
    finally:
        stop.set()
        leader.close()
        server.stop()
        T._relay_ep_cache.clear()


def test_relay_falls_back_to_direct_without_leader(pkg, monkeypatch):
    T = pkg.T
    monkeypatch.setenv("HVT_KV_RELAY", "1")
    monkeypatch.setenv("HVT_TOPO_HOST", "h9")
    T._relay_ep_cache.clear()
    server, addr = _server(pkg, np_=1)
    try:
        assert T.relay_put(addr, "failure", "h9/0", {"round": 2},
                           urgent=True)
        assert json.loads(server.store.get("failure", "h9/0")) == \
            {"round": 2}
    finally:
        server.stop()
        T._relay_ep_cache.clear()


def test_kvbulk_endpoint_validates_and_counts(pkg):
    server, addr = _server(pkg, np_=1)
    try:
        envs = [{"scope": "serving", "key": str(i),
                 "value_b64": base64.b64encode(
                     json.dumps({"i": i}).encode()).decode()}
                for i in range(5)]
        pkg.client.put_bytes(addr, "/kvbulk", json.dumps(envs).encode(),
                             retries=0)
        assert sorted(server.store.keys("serving")) == \
            sorted(str(i) for i in range(5))
        assert server.store.ingest_stats()["put_requests"]["serving"] == 1
        req = urllib.request.Request(f"http://{addr}/kvbulk",
                                     data=b"{not-a-list", method="PUT")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(req, timeout=5)
        mixed = [{"nope": 1}, {"scope": "serving", "key": "ok",
                               "value_b64": base64.b64encode(
                                   b"1").decode()}]
        pkg.client.put_bytes(addr, "/kvbulk", json.dumps(mixed).encode(),
                             retries=0)
        assert server.store.get("serving", "ok") == b"1"
    finally:
        server.stop()


# ------------------------------------------------------------ the store

def test_statusz_recovery_rows(pkg):
    server, addr = _server(pkg, np_=1)
    try:
        server.store.put("recovery", "h0/0", json.dumps(
            {"phase": "rebuild", "outcome": "peer", "seconds": 0.4,
             "round": 2}).encode())
        server.store.put("recovery", "h1/0", json.dumps(
            {"phase": "recovered", "outcome": "ok", "seconds": 2.2,
             "round": 2}).encode())
        rec = server.statusz_snapshot()["recovery"]
        assert rec["reports"] == 2
        assert rec["by_phase"] == {"rebuild": 1, "recovered": 1}
        assert rec["by_outcome"] == {"peer": 1, "ok": 1}
        assert rec["max_seconds"] == 2.2
        assert rec["ranks"]["h0/0"]["phase"] == "rebuild"
    finally:
        server.stop()


def test_store_timestamps_and_ttl_sweep(pkg):
    st = pkg.http._Store()
    st.put("debugz", "0", b"x" * 10, now=100.0)
    st.put("telemetry", "host/h0", b"y" * 20, now=150.0)
    st.put("timeline", "0", b"shard", now=0.0)
    assert st.age("debugz", "0", now=103.0) == 3.0
    assert st.age("debugz", "missing") is None
    assert st.ingest_stats()["put_bytes"] == {
        "debugz": 10, "telemetry": 20, "timeline": 5}
    assert st.sweep(60.0, now=170.0) == [("debugz", "0")]
    assert st.get("debugz", "0") is None
    assert st.get("telemetry", "host/h0") is not None
    assert st.sweep(0.001, now=1e9,
                    scopes=("serving", "debugz", "telemetry")) == [
        ("telemetry", "host/h0")]
    assert st.get("timeline", "0") == b"shard"
    st.put("debugz", "1", b"z", now=0.0)
    assert st.sweep(0, now=1e9) == []


def test_clear_keeps_meta_in_sync_and_rounds_keep_telemetry(pkg):
    st = pkg.http._Store()
    st.put("debugz", "0", b"x", now=1.0)
    st.put("scratch", "k", b"y", now=1.0)
    st.clear(keep_scopes=("debugz",))
    assert st.age("debugz", "0", now=2.0) == 1.0
    assert st.age("scratch", "k") is None
    assert set(pkg.http.KEEP_SCOPES) == {
        "workers", "timeline", "debugz", "serving", "telemetry",
        "recovery"}
    assert pkg.http.SWEEP_SCOPES == ("serving", "debugz", "telemetry",
                                     "recovery")


def test_statusz_stale_records_feed_no_straggler_evidence(pkg, monkeypatch):
    T = pkg.T
    monkeypatch.setenv("HVT_KV_TTL_SEC", "1000")
    server, addr = _server(pkg, np_=2)
    try:
        neg = [{"tensor": "x", "waiting_sec": 0.9, "missing_ranks": [1],
                "arrived_ranks": [0]}]
        snap = T.build_snapshot(0, "h0", _diag(rank=0, negotiations=neg),
                                {})
        base = 1000.0
        server.store.put("debugz", "0", json.dumps(snap).encode(),
                         now=base - 100)
        builder = T.StatuszBuilder(T.HealthEngine(straggler_windows=1,
                                                  alert_counter=False))
        for i in range(3):
            doc = builder.build(server.store, {"size": 2}, 1,
                                now=base + 10 * i)
        assert doc["stragglers"] == []
        assert not any(a["rule"] == "straggler" for a in doc["alerts"])
        server.store.put("debugz", "0", json.dumps(snap).encode(),
                         now=base + 30)
        doc = builder.build(server.store, {"size": 2}, 1, now=base + 30)
        assert any(a["rule"] == "straggler" for a in doc["alerts"])
    finally:
        server.stop()


def test_statusz_marks_stale_before_ttl_drops(pkg, monkeypatch):
    monkeypatch.setenv("HVT_KV_TTL_SEC", "1000")
    server, addr = _server(pkg, np_=1)
    try:
        snap = pkg.T.build_snapshot(0, "h0", _diag(rank=0), {})
        server.store.put("debugz", "0", json.dumps(snap).encode(),
                         now=time.monotonic() - 100)
        doc = server.statusz_snapshot()
        assert doc["ranks"]["0"]["stale"] is True
        assert any(a["rule"] == "push_stale" for a in doc["alerts"])
    finally:
        server.stop()


def test_statusz_serving_excludes_ghost_lanes(pkg, monkeypatch):
    T = pkg.T
    monkeypatch.setenv("HVT_KV_TTL_SEC", "1000")
    server, addr = _server(pkg, np_=2)
    try:
        base = 1000.0
        for key, body, age in (
                ("0", {"rank": 0, "replica": 0, "inflight": 2, "shed": 1,
                       "p99_ms": 3.0}, 1),
                ("1", {"rank": 1, "replica": 1, "inflight": 99, "shed": 50,
                       "p99_ms": 9.0}, 500),
                ("7", {"rank": 7, "replica": 3, "inflight": 88, "shed": 10,
                       "p99_ms": 9.0}, 1)):
            server.store.put("serving", key, json.dumps(body).encode(),
                             now=base - age)
        builder = T.StatuszBuilder(T.HealthEngine(alert_counter=False))
        serving = builder.build(server.store, {"size": 2}, 1,
                                now=base)["serving"]
        assert serving["ranks"] == 1 and serving["stale_ranks"] == 2
        assert serving["inflight_max"] == 2 and serving["shed_total"] == 1
        assert set(serving["lanes"]) == {"0"}
        assert serving["lanes"]["0"]["p99_ms_max"] == 3.0
    finally:
        server.stop()


# ---------------------------------------------------------- health engine

def test_health_rules_fire_and_clear(pkg):
    he = pkg.T.HealthEngine(straggler_windows=2, reconnect_storm=2,
                            stale_intervals=3, backlog_windows=2,
                            alert_counter=False)
    base = {"interval_sec": 1.0, "reconnect_total": 0,
            "rank_ages": {0: 0.1}, "backlog": 0}
    assert he.observe(dict(base), now=0.0) == []
    a = he.observe(dict(base, reconnect_total=3, backlog=1,
                        stragglers={2: ["t"]}), now=1.0)
    assert [x["rule"] for x in a] == ["reconnect_storm"]
    a = he.observe(dict(base, reconnect_total=3, backlog=2,
                        rank_ages={0: 0.1, 1: 9.9},
                        stragglers={2: ["t"]}), now=2.0)
    assert sorted(x["rule"] for x in a) == [
        "push_stale", "reconnect_storm", "serving_backlog", "straggler"]
    straggler = next(x for x in a if x["rule"] == "straggler")
    assert straggler["subject"] == "rank 2" and straggler["windows"] == 2
    a2 = he.observe(dict(base, reconnect_total=99), now=2.05)
    assert a2 == a and he.windows == 3
    for i in range(4):
        a = he.observe(dict(base, reconnect_total=3), now=3.0 + i)
    assert a == []
    assert he.straggler_ranking()[0] == {
        "rank": 2, "windows": 2, "consecutive": 0, "tensors": ["t"]}


def test_health_alert_counter_increments_once_per_activation(pkg):
    fired = []

    class FakeCounter:
        def labels(self, rule):
            fired.append(rule)
            return self

        def inc(self):
            pass

    he = pkg.T.HealthEngine(straggler_windows=1, reconnect_storm=1,
                            stale_intervals=3, backlog_windows=2,
                            alert_counter=FakeCounter())
    for now in (0.0, 1.0):
        he.observe({"interval_sec": 1.0, "stragglers": {1: ["t"]}},
                   now=now)
    assert fired == ["straggler"]


def test_health_alerts_reach_the_port_registry():
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.metrics import telemetry as tT

    he = tT.HealthEngine(straggler_windows=1)
    before = metrics.counter("hvt_health_alerts_total", "",
                             ("rule",)).labels(rule="straggler").value
    he.observe({"interval_sec": 1.0, "stragglers": {1: ["t"]}}, now=0.0)
    assert metrics.counter("hvt_health_alerts_total", "", ("rule",)).labels(
        rule="straggler").value == before + 1


# ----------------------------------------------------------- statusz modes

def _put_frame(pkg, server, host, members, now=None):
    T = pkg.T
    frame = T.build_host_frame(
        host, min(members),
        {r: T.build_snapshot(r, host, _diag(rank=r), {"ctrl_tx_bytes": 100})
         for r in members}, {r: 0.0 for r in members}, 1.0)
    server.store.put("telemetry", f"host/{host}", json.dumps(frame).encode(),
                     now=now if now is not None else time.monotonic())


def test_statusz_leader_direct_and_mixed_modes(pkg):
    server, addr = _server(pkg, np_=5, hosts=2)
    try:
        _put_frame(pkg, server, "h0", [0, 1])
        doc = server.statusz_snapshot()
        assert doc["mode"] == "leader" and doc["ranks_covered"] == 2
        assert doc["missing_ranks"] == [2, 3, 4]
        snap = pkg.T.build_snapshot(4, "h1", _diag(rank=4), {})
        server.store.put("debugz", "4", json.dumps(snap).encode())
        doc = server.statusz_snapshot()
        assert doc["mode"] == "mixed" and doc["ranks_covered"] == 3
        assert doc["hosts"]["h0"]["ranks"] == [0, 1]
        assert doc["totals"]["ctrl_bytes"] == 200
    finally:
        server.stop()


def test_statusz_rates_from_successive_builds(pkg):
    T = pkg.T
    server, addr = _server(pkg, np_=2, hosts=1)
    try:
        now = time.monotonic()
        _put_frame(pkg, server, "h0", [0, 1], now=now)
        server.statusz_snapshot(now=now)
        frame = T.build_host_frame(
            "h0", 0, {r: T.build_snapshot(r, "h0", _diag(rank=r),
                                          {"ctrl_tx_bytes": 600})
                      for r in (0, 1)}, {0: 0.0, 1: 0.0}, 1.0)
        server.store.put("telemetry", "host/h0", json.dumps(frame).encode(),
                         now=now + 10)
        doc = server.statusz_snapshot(now=now + 10)
        assert doc["rates"]["window_sec"] == 10.0
        assert doc["rates"]["ctrl_bytes_per_sec"] == 100.0
    finally:
        server.stop()


def test_statusz_http_route_and_ingest_accounting(pkg):
    server, addr = _server(pkg, np_=1)
    try:
        snap = pkg.T.build_snapshot(0, "h0", _diag(rank=0), {})
        pkg.client.put_bytes(addr, "/kv/debugz/0", json.dumps(snap).encode(),
                             retries=0)
        doc = pkg.client.get_json(addr, "/statusz", retries=0)
        assert doc["schema"] == "hvt-statusz-r1"
        assert doc["ranks_covered"] == 1 and doc["mode"] == "direct"
        assert doc["ingest"]["put_count"]["debugz"] == 1
        assert doc["ingest"]["put_bytes"]["debugz"] == len(
            json.dumps(snap).encode())
        dz = pkg.client.get_json(addr, "/debugz", retries=0)
        assert "telemetry_hosts" in dz and dz["ranks"]["0"]
        assert dz["world"]["size"] == 1 and dz["round"] == 1
    finally:
        server.stop()


# ------------------------------------------------------- autoscaler feeds

def test_autoscaler_reads_backlog_from_host_frames(pkg):
    T, A = pkg.T, pkg.auto
    server, addr = _server(pkg, np_=4, hosts=1)
    try:
        frame = T.build_host_frame(
            "h0", 0, {r: T.build_snapshot(r, "h0", _diag(rank=r, queue=5 + r),
                                          {}) for r in range(4)},
            {r: 0.0 for r in range(4)}, 1.0)
        server.store.put("telemetry", "host/h0", json.dumps(frame).encode())

        class Driver:
            def __init__(self, size):
                self.size = size

            def world_size(self):
                return self.size

        sc = A.Autoscaler(Driver(4), server, policy=A.AutoscalePolicy(
            backlog_threshold=8, sustain_sec=10, cooldown_sec=0,
            interval_sec=1))
        assert sc.read_backlog() == 8.0
        assert A.Autoscaler(Driver(2), server).read_backlog() == 6.0
    finally:
        server.stop()


def test_autoscaler_serving_backlog_alert_bypasses_sustain(pkg):
    A = pkg.auto
    notified = []

    class Driver:
        def world_size(self):
            return 2

        def _worker_notify_addrs(self):
            return ["w0"]

        def _notify_workers_host_changes(self):
            notified.append(1)

        class host_manager:
            class current_hosts:
                @staticmethod
                def count_available_slots():
                    return 4

    class Rdv:
        def __init__(self, store, alerts):
            self.store, self._alerts = store, alerts

        def statusz_snapshot(self):
            return {"alerts": self._alerts}

    st = pkg.http._Store()
    st.put("serving", "0", json.dumps({"inflight": 99}).encode())
    alert = [{"rule": "serving_backlog", "severity": "warn",
              "detail": "grew"}]
    policy = A.AutoscalePolicy(backlog_threshold=8, sustain_sec=1e6,
                               cooldown_sec=0, interval_sec=1)
    A.Autoscaler(Driver(), Rdv(st, alert), policy=policy).step(now=0.0)
    assert notified
    notified.clear()
    A.Autoscaler(Driver(), Rdv(st, []), policy=policy).step(now=0.0)
    assert not notified


def test_autoscaler_starts_only_under_hvt_autoscale(pkg, monkeypatch):
    monkeypatch.delenv("HVT_AUTOSCALE", raising=False)
    assert pkg.auto.maybe_start_autoscaler(object(), object()) is None
    monkeypatch.setenv("HVT_AUTOSCALE", "1")

    class Driver:
        def finished(self):
            return True

    scaler = pkg.auto.maybe_start_autoscaler(Driver(), object())
    try:
        assert isinstance(scaler, pkg.auto.Autoscaler)
    finally:
        scaler.stop()


# ------------------------------------------------------ the port's worker

@pytest.fixture()
def world_of_one(monkeypatch):
    import horovod_tpu_torch as hvt

    for var in ("HVT_DIAG_ADDR", "HVT_RENDEZVOUS_ADDR", "HVT_NUM_PROCESSES",
                "HVT_WIRE_COMPRESSION", "HVT_TIMELINE_SHARD",
                "HVT_METRICS_PORT"):
        monkeypatch.delenv(var, raising=False)
    yield hvt
    hvt.shutdown()


def test_port_snapshot_reads_the_registry(world_of_one):
    import torch

    from horovod_tpu_torch.common import basics

    hvt = world_of_one
    hvt.init(device="cpu")
    hvt.allreduce(torch.ones(8), name="x")
    hvt.grouped_allreduce([torch.ones(3), torch.ones(5)])
    stats = basics._telemetry_stats()
    assert stats["collective_bytes"]["allreduce"] >= 32
    assert stats["collective_bytes"]["grouped_allreduce"] >= 32
    snap = basics._telemetry_snapshot(0)
    assert snap["engine"]["wire"] == {"intra": "none", "inter": "none",
                                      "auto": False}
    assert snap["telemetry"]["queue_depth"] == len(snap["pending"])
    fams = snap["metrics"]["metrics"]
    ops = {s["labels"]["op"] for s in
           fams["hvt_collective_bytes_total"]["samples"]}
    assert {"allreduce", "grouped_allreduce"} <= ops
    json.dumps(snap)


def test_port_push_loop_runs_from_init_to_shutdown(world_of_one,
                                                   monkeypatch):
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    hvt = world_of_one
    server = RendezvousServer(lambda s, r: 0)
    server.init([_Slot("h0", 0, 0, 1, 1, 1)])
    port = server.start(0)
    try:
        monkeypatch.setenv("HVT_DIAG_ADDR", f"127.0.0.1:{port}")
        monkeypatch.setenv("HVT_DEBUGZ_INTERVAL_MS", "100")
        monkeypatch.delenv("HVT_TELEMETRY_AGG", raising=False)
        hvt.init(device="cpu")
        thread = basics._world().push_thread
        deadline = time.monotonic() + 10
        while server.store.get("debugz", "0") is None:
            assert time.monotonic() < deadline, "no push arrived"
            time.sleep(0.05)
        doc = server.statusz_snapshot()
        assert doc["mode"] == "direct" and doc["alerts"] == []
        assert doc["ranks"]["0"]["stale"] is False
        hvt.shutdown()
        assert not thread.is_alive()
    finally:
        server.stop()


def test_port_push_loop_survives_a_dead_server(world_of_one, monkeypatch):
    import torch

    from horovod_tpu_torch.common import basics

    hvt = world_of_one
    monkeypatch.setenv("HVT_DIAG_ADDR", f"127.0.0.1:{EW.free_port()}")
    monkeypatch.setenv("HVT_DEBUGZ_INTERVAL_MS", "50")
    hvt.init(device="cpu")
    time.sleep(0.3)
    assert basics._world().push_thread.is_alive()
    assert hvt.allreduce(torch.ones(2), op=hvt.Sum).tolist() == [1.0, 1.0]


def test_port_elastic_reports_relay_through_the_leader(monkeypatch):
    import importlib as il

    from horovod_tpu_torch.metrics import telemetry as tT
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    erun = il.import_module("horovod_tpu_torch.elastic.run")
    server = RendezvousServer(lambda s, r: 0)
    server.init([_Slot("h0", 0, 0, 1, 1, 1)])
    addr = f"127.0.0.1:{server.start(0)}"
    monkeypatch.setenv("HVT_RENDEZVOUS_ADDR", addr)
    monkeypatch.setenv("HVT_KV_RELAY", "1")
    monkeypatch.setenv("HVT_TOPO_HOST", "h0")
    monkeypatch.setattr(erun, "_identity", ("h0", "0"))
    tT._relay_ep_cache.clear()
    stop = threading.Event()
    leader = tT.TelemetryPusher(addr, 0, lambda: {"rank": 0}, stop,
                                host="h0", role="leader", period_sec=0.2)
    try:
        # no leader yet: the direct fallback lands every report
        erun._report_failure(1, RuntimeError("peer lost"))
        assert json.loads(server.store.get("failure", "h0/0"))[
            "failed_ranks"] == []
        assert server.store.ingest_stats()["put_requests"]["failure"] == 1
        leader.step()
        erun._report_state("READY", 2)
        erun._report_recovery({"phase": "rebuild", "outcome": "ok"})
        deadline = time.monotonic() + 5
        while server.store.get("state", "h0/0") is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        leader.step()       # the recovery row rides the next tick
        assert json.loads(server.store.get("recovery", "h0/0"))[
            "phase"] == "rebuild"
        assert server.store.ingest_stats()["put_requests"] == {
            "failure": 1, "telemetry": 4, "state": 1, "recovery": 1}
    finally:
        stop.set()
        leader.close()
        server.stop()
        tT._relay_ep_cache.clear()


def test_autoscaler_grows_a_launched_elastic_gang(tmp_path):
    """An elastic launch of two gloo workers (-np 2 --max-np 3) whose
    discovery offers three slots from the start; rank 0 PUTs a serving
    backlog of 16 each step while the world has two. With HVT_AUTOSCALE=1
    the launcher's autoscaler (threshold 4, sustained 1 s) notifies the
    workers, which re-rendezvous into a world of three that takes the
    rest of the steps."""
    import os

    env = dict(os.environ, HVT_AUTOSCALE="1", HVT_AUTOSCALE_BACKLOG="4",
               HVT_AUTOSCALE_SUSTAIN_SEC="1", HVT_AUTOSCALE_COOLDOWN_SEC="0",
               HVT_AUTOSCALE_INTERVAL_SEC="0.2")
    job = EW.ElasticLaunch(2, str(tmp_path / "res"), {
        "device": "cpu", "gpt": dict(vocab_size=64, n_layers=2, d_model=32,
                                     n_heads=2, d_ff=64, max_seq_len=16),
        "rows": 4000, "batch": 1, "steps": 40, "sleep": 0.1,
        "backlog": {"inflight": 16, "until_size": 3}},
        min_np=2, max_np=3, slots=3, env=env, launcher_args=("--verbose",),
        timeout=180)
    lives, rounds, _ = job.results()
    with open(job.log) as f:
        log = f.read()
    assert [r["size"] for r in rounds] == [2, 3], rounds
    assert "[autoscaler] scale_out" in log
    assert sorted(life["slot"] for life in lives) == [0, 1, 2]
    done = [e for life in lives for e in life["events"]
            if e["kind"] == "done"]
    assert len(done) == 3 and {e["size"] for e in done} == {3}
    assert len({e["digest"] for e in done}) == 1
    backlog = [(e["inflight"], e["size"]) for e in lives[0]["events"]
               if e["kind"] == "backlog"]
    assert backlog == [(16, 2), (0, 3)]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
