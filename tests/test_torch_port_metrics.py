"""horovod_tpu_torch.metrics against the JAX package's horovod_tpu.metrics:
the JAX package's registry, exposition and merge cases
(``tests/test_metrics.py``, leaving out the engine-stats and wall-clock
ones), each run on both packages' modules; the same calls give the same
Prometheus text and JSON snapshot byte for byte, and equal merged frames.
Then the port's own surfaces: the launcher's rendezvous server's
``/metrics`` and ``/clock``, ``--metrics-port``'s plumbing, and a 2-process
gloo gang whose eager dispatch counts and bytes equal those of the same
calls on the JAX package, every worker serving ``/metrics`` at base port +
rank."""

import importlib
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

# the packages' ``metrics.registry`` is a function; the modules by name
jax_registry, jax_exposition, jax_merge, port_registry, port_exposition, \
    port_merge = (importlib.import_module(f"{pkg}.metrics.{mod}")
                  for pkg in ("horovod_tpu", "horovod_tpu_torch")
                  for mod in ("registry", "exposition", "merge"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_port_observe_worker as W  # noqa: E402

PKGS = {"jax": (jax_registry, jax_exposition, jax_merge),
        "port": (port_registry, port_exposition, port_merge)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """(registry module, exposition module, merge module) of one
    package."""
    return PKGS[request.param]


# ------------------------------------------------------------------ registry

def test_counter_inc_and_negative_rejected(pkg):
    R, _, _ = pkg
    c = R.MetricRegistry().counter("c_total", "help")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(R.MetricError):
        c.inc(-1)


def test_gauge_set_inc_dec(pkg):
    R, _, _ = pkg
    g = R.MetricRegistry().gauge("g", "help")
    g.set(10)
    g.inc(5)
    g.dec(2)
    assert g.value == 13


def test_labels_distinct_children_and_validation(pkg):
    R, _, _ = pkg
    c = R.MetricRegistry().counter("req_total", "help", ("op", "process_set"))
    c.labels(op="allreduce", process_set="global").inc(3)
    c.labels("allreduce", "0,1").inc(1)
    assert c.labels(op="allreduce", process_set="global").value == 3
    assert c.labels(op="allreduce", process_set="0,1").value == 1
    with pytest.raises(R.MetricError):
        c.labels(op="allreduce")
    with pytest.raises(R.MetricError):
        c.labels(op="allreduce", process_set="global", extra="x")
    with pytest.raises(R.MetricError):
        c.inc()


def test_registry_get_or_create_and_schema_conflict(pkg):
    R, _, _ = pkg
    reg = R.MetricRegistry()
    a = reg.counter("x_total", "help")
    assert reg.counter("x_total") is a
    for bad in (lambda: reg.gauge("x_total"),
                lambda: reg.counter("x_total", labelnames=("op",)),
                lambda: reg.counter("9bad"),
                lambda: reg.counter("bad-name")):
        with pytest.raises(R.MetricError):
            bad()


def test_histogram_bucket_assignment(pkg):
    R, _, _ = pkg
    h = R.MetricRegistry().histogram("lat_seconds", "help",
                                     buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    cum, s, c = h.labels().snapshot()
    assert cum == [1, 3, 4, 5]
    assert c == 5
    assert s == pytest.approx(56.05)


def test_default_latency_buckets_are_log_scale(pkg):
    R, _, _ = pkg
    bs = R.DEFAULT_LATENCY_BUCKETS
    assert bs == jax_registry.DEFAULT_LATENCY_BUCKETS
    assert bs[0] == pytest.approx(1e-6)
    assert {round(b2 / b1, 6) for b1, b2 in zip(bs, bs[1:])} == {4.0}
    assert bs[-1] > 60


def test_concurrent_increments_are_exact(pkg):
    R, _, _ = pkg
    reg = R.MetricRegistry()
    c = reg.counter("n_total", "help")
    h = reg.histogram("h_seconds", "help")
    n_threads, per_thread = 8, 500

    def hammer():
        for _ in range(per_thread):
            c.inc()
            h.observe(1e-5)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per_thread
    assert h.labels().snapshot()[2] == n_threads * per_thread


# ---------------------------------------------------------------- exposition

def _golden_registry(R):
    reg = R.MetricRegistry()
    reg.counter("hvt_demo_total", "demo counter", ("op",)).labels(
        op="allreduce").inc(3)
    reg.gauge("hvt_demo_gauge", 'help with "quotes" and \\slash').set(2.5)
    h = reg.histogram("hvt_demo_seconds", "demo latency",
                      buckets=(0.001, 1.0))
    for v in (0.0009765625, 0.5, 2.0):
        h.observe(v)
    return reg


def test_prometheus_text_golden(pkg):
    R, E, _ = pkg
    assert E.prometheus_text(_golden_registry(R)) == textwrap.dedent("""\
        # HELP hvt_demo_total demo counter
        # TYPE hvt_demo_total counter
        hvt_demo_total{op="allreduce"} 3
        # HELP hvt_demo_gauge help with "quotes" and \\\\slash
        # TYPE hvt_demo_gauge gauge
        hvt_demo_gauge 2.5
        # HELP hvt_demo_seconds demo latency
        # TYPE hvt_demo_seconds histogram
        hvt_demo_seconds_bucket{le="0.001"} 1
        hvt_demo_seconds_bucket{le="1"} 2
        hvt_demo_seconds_bucket{le="+Inf"} 3
        hvt_demo_seconds_sum 2.5009765625
        hvt_demo_seconds_count 3
        """)


def test_json_snapshot_golden(pkg):
    R, E, _ = pkg
    snap = E.json_snapshot(_golden_registry(R))
    assert snap["hvt_demo_total"]["samples"] == [
        {"labels": {"op": "allreduce"}, "value": 3.0}]
    hist = snap["hvt_demo_seconds"]["samples"][0]
    assert hist["buckets"] == {"0.001": 1, "1": 2, "+Inf": 3}
    assert hist["count"] == 3
    json.dumps(snap)


def test_label_value_escaping(pkg):
    R, E, _ = pkg
    reg = R.MetricRegistry()
    reg.counter("e_total", "h", ("k",)).labels(k='a"b\\c\nd').inc()
    assert r'e_total{k="a\"b\\c\nd"} 1' in E.prometheus_text(reg)


def _seeded_calls(R, seed):
    """A registry fed a seeded mix of every metric type, labels and
    values."""
    rng = np.random.RandomState(seed)
    reg = R.MetricRegistry()
    c = reg.counter("hvt_collective_bytes_total", "payload bytes",
                    ("op", "process_set"))
    h = reg.histogram("hvt_collective_latency_seconds", "latency",
                      ("op", "process_set"))
    g = reg.gauge("hvt_elastic_world_size", "slots")
    ops = ("allreduce", "allgather", "broadcast", "alltoall")
    for _ in range(200):
        op, ps = ops[rng.randint(4)], ("global", "0,1")[rng.randint(2)]
        c.labels(op=op, process_set=ps).inc(int(rng.randint(1, 1 << 20)))
        h.labels(op=op, process_set=ps).observe(float(10.0 **
                                                      rng.uniform(-6, 1)))
        g.set(int(rng.randint(1, 9)))
    reg.gauge("odd", 'q"uote\\slash\nline').set(float("inf"))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_calls_same_text_and_snapshot(seed):
    """Byte for byte: one dashboard reads both packages."""
    jax_reg, port_reg = (_seeded_calls(R, seed)
                         for R in (jax_registry, port_registry))
    assert port_exposition.prometheus_text(port_reg) == \
        jax_exposition.prometheus_text(jax_reg)
    assert json.dumps(port_exposition.json_snapshot(port_reg)) == \
        json.dumps(jax_exposition.json_snapshot(jax_reg))
    frames = {name: M.merge(*(M.frame(r, E.json_snapshot(_seeded_calls(
        R, seed + 10 * r))) for r in range(3)))
        for name, (R, E, M) in PKGS.items()}
    assert frames["port"] == frames["jax"]
    assert port_merge.counter_total(frames["port"],
                                    "hvt_collective_bytes_total") == \
        jax_merge.counter_total(frames["jax"], "hvt_collective_bytes_total")


def test_exposition_help_and_type_for_every_family(pkg):
    R, E, _ = pkg
    reg = R.MetricRegistry()
    reg.counter("conf_total", "a counter", ("op",)).labels(
        op="allreduce").inc(2)
    h = reg.histogram("conf_seconds", "a histogram")
    for v in (1e-6, 1e-3, 5.0, 1e9):
        h.observe(v)
    reg.gauge("conf_gauge", "line1\nline2").set(1)
    text = E.prometheus_text(reg)
    for name, mtype in (("conf_total", "counter"),
                        ("conf_seconds", "histogram"),
                        ("conf_gauge", "gauge")):
        assert text.index(f"# HELP {name}") < text.index(
            f"# TYPE {name} {mtype}") < text.index(f"\n{name}")
    assert r"line1\nline2" in text and "line1\nline2" not in text
    bounds, counts = [], []
    for line in text.splitlines():
        if line.startswith("conf_seconds_bucket"):
            bounds.append(line.split('le="', 1)[1].split('"', 1)[0])
            counts.append(int(line.rsplit(" ", 1)[1]))
    assert bounds[-1] == "+Inf"
    finite = [float(b) for b in bounds[:-1]]
    assert finite == sorted(finite) and counts == sorted(counts)
    assert counts[-1] == 4 and "conf_seconds_count 4" in text


# ------------------------------------------------------------- merge algebra

def _frame_of(R, E, M, rank, ctrl=0, depth=0, lat=()):
    reg = R.MetricRegistry()
    reg.counter("m_ctrl_total", "c").inc(ctrl)
    reg.gauge("m_depth", "g", ("lane",)).labels(lane="0").set(depth)
    h = reg.histogram("m_lat_seconds", "h", buckets=(0.001, 1.0))
    for v in lat:
        h.observe(v)
    return M.frame(rank, E.json_snapshot(reg))


def test_merge_semantics_per_type(pkg):
    R, E, M = pkg
    m = M.merge(_frame_of(R, E, M, 0, ctrl=100, depth=3, lat=(0.0005,)),
                _frame_of(R, E, M, 1, ctrl=40, depth=7, lat=(0.5, 2.0)))
    assert m["ranks"] == [0, 1]
    assert M.counter_total(m, "m_ctrl_total") == 140
    depth = m["metrics"]["m_depth"]["samples"][0]
    assert depth["labels"] == {"lane": "0"} and depth["value"] == 7
    hist = m["metrics"]["m_lat_seconds"]["samples"][0]
    assert hist["buckets"] == {"0.001": 1, "1": 2, "+Inf": 3}
    assert hist["count"] == 3


def test_merge_associative_and_commutative(pkg):
    R, E, M = pkg
    a = _frame_of(R, E, M, 0, ctrl=1, lat=(0.0009765625, 0.5))
    b = _frame_of(R, E, M, 1, ctrl=2, lat=(2.0,))
    c = _frame_of(R, E, M, 2, ctrl=4, lat=(0.5, 0.5, 8.0))
    assert M.merge(a, M.merge(b, c)) == M.merge(M.merge(a, b), c)
    assert M.merge(a, b) == M.merge(b, a)


def test_merge_histogram_layout_mismatch_raises(pkg):
    R, E, M = pkg

    def hist_frame(rank, bounds, obs):
        reg = R.MetricRegistry()
        h = reg.histogram("hm_seconds", "h", buckets=bounds)
        for v in obs:
            h.observe(v)
        return M.frame(rank, E.json_snapshot(reg))

    a = hist_frame(0, (0.001, 1.0), (0.5,))
    with pytest.raises(R.MetricError):
        M.merge(a, hist_frame(1, (1.0,), (0.5,)))
    assert M.merge(a, hist_frame(2, (0.001, 1.0), (2.0,)))["metrics"][
        "hm_seconds"]["samples"][0]["buckets"] == {"0.001": 0, "1": 1,
                                                   "+Inf": 2}


def test_merge_type_conflict_raises(pkg):
    R, _, M = pkg
    a = M.frame(0, {"x": {"type": "counter", "help": "",
                          "samples": [{"labels": {}, "value": 1}]}})
    b = M.frame(1, {"x": {"type": "gauge", "help": "",
                          "samples": [{"labels": {}, "value": 1}]}})
    with pytest.raises(R.MetricError):
        M.merge(a, b)


def test_merge_does_not_mutate_inputs(pkg):
    R, E, M = pkg
    a = _frame_of(R, E, M, 0, ctrl=5, lat=(0.5,))
    b = _frame_of(R, E, M, 1, ctrl=7, lat=(0.5,))
    before = json.dumps([a, b], sort_keys=True)
    M.merge(a, b)
    M.merge(M.merge(a, b), a)
    assert json.dumps([a, b], sort_keys=True) == before


# ------------------------------------------------------------------ endpoints

def test_standalone_serve_routes(pkg):
    R, E, _ = pkg
    reg = R.MetricRegistry()
    reg.counter("served_total", "h").inc(7)
    srv = E.MetricsServer(reg)
    try:
        port = srv.start(0, addr="127.0.0.1")
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5)
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert b"served_total 7" in resp.read()
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=5).read())
        assert snap["served_total"]["samples"][0]["value"] == 7
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=5)
    finally:
        srv.stop()


def test_serve_raises_when_the_port_is_taken():
    """No silent fallback: a port that cannot be bound raises."""
    from horovod_tpu_torch import metrics

    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        s.listen()
        metrics.stop_server()
        with pytest.raises(OSError):
            metrics.serve(s.getsockname()[1])
    assert metrics.server_port() is None


def test_rendezvous_server_metrics_and_clock_routes():
    """The launcher's server exposes its process's registry and the clock
    the timeline's handshake samples, and keeps timeline shards across a
    round reset."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.runner.http_client import get_json, put_bytes
    from horovod_tpu_torch.runner.http_server import RendezvousServer
    from horovod_tpu_torch.utils import timeline

    metrics.counter("hvt_rdv_probe_total", "probe").inc(3)
    srv = RendezvousServer(lambda slots, round_: 0)
    port = srv.start()
    addr = f"127.0.0.1:{port}"
    try:
        text = urllib.request.urlopen(f"http://{addr}/metrics",
                                      timeout=5).read().decode()
        assert "hvt_rdv_probe_total 3" in text
        snap = json.loads(urllib.request.urlopen(
            f"http://{addr}/metrics.json", timeout=5).read())
        assert snap["hvt_rdv_probe_total"]["samples"][0]["value"] == 3
        t0 = time.time_ns() // 1000
        clock = get_json(addr, "/clock")["epoch_us"]
        assert abs(clock - t0) < 5e6
        assert abs(timeline.measure_clock_offset_us(addr)) < 5e5
        put_bytes(addr, "/kv/timeline/0", b"[]")
        put_bytes(addr, "/kv/other/0", b"x")
        urllib.request.urlopen(urllib.request.Request(
            f"http://{addr}/rendezvous", method="DELETE"), timeout=5)
        assert srv.store.get("timeline", "0") == b"[]"
        assert srv.store.get("other", "0") is None
    finally:
        srv.stop()


def test_metrics_port_and_timeline_env_plumbing(tmp_path):
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)
    from horovod_tpu_torch.runner.launch import (build_commands,
                                                 parse_args, slot_env)

    slots = get_host_assignments(parse_hosts("localhost:2"), 2)
    args = parse_args(["-np", "2", "--metrics-port", "9090", "--timeline",
                       "/tmp/t.json", "true"])
    env = slot_env({}, slots[1], args, "127.0.0.1")
    assert env["HVT_METRICS_PORT"] == "9090"
    assert env["HVT_TIMELINE_SHARD"] == "/tmp/t.json"
    cmds = build_commands(args, slots, "127.0.0.1", base_env={},
                          diag_port=4242)
    assert [c[1]["HVT_DIAG_ADDR"] for c in cmds] == ["127.0.0.1:4242"] * 2
    args = parse_args(["-np", "1", "true"])
    env = slot_env({}, slots[0], args, "127.0.0.1")
    assert "HVT_METRICS_PORT" not in env and "HVT_TIMELINE_SHARD" not in env
    cfg = tmp_path / "c.yaml"
    cfg.write_text("metrics-port: 7000\ntimeline: /tmp/x.json\n")
    args = parse_args(["-np", "1", "--config-file", str(cfg), "true"])
    assert (args.metrics_port, args.timeline) == (7000, "/tmp/x.json")


def test_elastic_driver_families_match_the_jax_driver():
    """The driver's families have the JAX driver's names, types and
    help, so one dashboard reads both."""
    from horovod_tpu.runner.elastic import driver as jax_driver
    from horovod_tpu_torch.runner.elastic import driver as port_driver

    describe = [[(m.name, m.type, m.help, m.labelnames) for m in
                 mod._elastic_metrics()]
                for mod in (jax_driver, port_driver)]
    assert describe[0] == describe[1]


# ---------------------------------------------------------------- the gang

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """A 2-process gloo job of torch_port_observe_worker.py metrics with
    --metrics-port, started while the JAX side runs its calls."""
    out = str(tmp_path_factory.mktemp("metrics_gang") / "res")
    metrics_base = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--master-port", str(_free_port()), "--metrics-port",
         str(metrics_base), sys.executable,
         os.path.join(REPO, "tests", "torch_port_observe_worker.py"),
         "metrics", out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = proc.communicate(timeout=180)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-4000:]
    results = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            results.append(json.load(f))
    return metrics_base, results


def _dispatch_totals(snap):
    """{(op, process_set): (bytes, latency count)} of a JSON snapshot."""
    out = {}
    for s in snap["hvt_collective_bytes_total"]["samples"]:
        key = (s["labels"]["op"], s["labels"]["process_set"])
        out[key] = [s["value"], 0]
    for s in snap["hvt_collective_latency_seconds"]["samples"]:
        key = (s["labels"]["op"], s["labels"]["process_set"])
        out.setdefault(key, [0.0, 0])[1] = s["count"]
    return out


def test_gang_dispatch_counts_and_bytes_match_the_jax_package(gang):
    """The same calls give the same dispatch counts and bytes per (op,
    process set) on the port's gloo gang and on the JAX package (its
    single-process eager path, counted the same way)."""
    import horovod_tpu as jhvt
    from horovod_tpu import metrics as jax_metrics

    before = _dispatch_totals(jax_metrics.json_snapshot()) \
        if jax_metrics.registry().get("hvt_collective_bytes_total") else {}
    jhvt.init()
    W.dispatch_sequence(jhvt, lambda a: a)
    after = _dispatch_totals(jax_metrics.json_snapshot())
    want = {k: [v[0] - before.get(k, [0, 0])[0],
                v[1] - before.get(k, [0, 0])[1]] for k, v in after.items()}
    want = {k: v for k, v in want.items() if v != [0, 0]}
    _, results = gang
    for r, res in enumerate(results):
        got = _dispatch_totals(res["snapshot"])
        assert got == want, (r, got, want)
        # the latency buckets of every series are the JAX package's
        hist = res["snapshot"]["hvt_collective_latency_seconds"]
        assert list(hist["samples"][0]["buckets"]) == [
            "%g" % b for b in jax_registry.DEFAULT_LATENCY_BUCKETS] + \
            ["+Inf"]


def test_gang_every_worker_serves_metrics_at_base_plus_rank(gang):
    base, results = gang
    for r, res in enumerate(results):
        assert res["env"]["HVT_METRICS_PORT"] == str(base)
        assert res["port"] == base + r
        for peer, (ctype, text) in enumerate(res["scraped"]):
            assert ctype.startswith("text/plain; version=0.0.4")
            assert 'hvt_collective_latency_seconds_count{op="allreduce",' \
                   'process_set="global"} 2' in text, (r, peer)
            assert 'hvt_collective_bytes_total{op="grouped_allreduce",' \
                   'process_set="global"} 32' in text


def test_bench_record_carries_engine_metrics():
    """The harness's record embeds the registry's snapshot, with the
    allreduce of the last loss in it, as the JAX bench's does."""
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import bench

    hvt.init(device="cpu")
    hist = "hvt_collective_latency_seconds"
    before = hvt.metrics.json_snapshot().get(hist, {"samples": []})
    count = sum(s["count"] for s in before["samples"]
                if s["labels"]["op"] == "allreduce")
    try:
        snap = bench.final_metrics({"eager": {"losses": [2.5, 2.25]}})
    finally:
        hvt.shutdown()
    json.dumps(snap)
    assert sum(s["count"] for s in snap[hist]["samples"]
               if s["labels"]["op"] == "allreduce") == count + 1


def test_dispatch_instrumentation_from_many_threads_loses_nothing():
    """Collectives are issued from several threads (an async checkpoint's
    writer, the training loop): counting and timing from 16 threads at a
    short switch interval loses no count, no observation and leaves no
    collective in flight."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import collective_ops as C

    hvt.init(device="cpu")
    threads_n, calls = 16, 200
    x = torch.zeros(3)
    fam = C._metric_handles()
    hist = fam[0].labels(op="stress", process_set="global")
    nbytes = fam[1].labels(op="stress", process_set="global")
    before = (hist.snapshot()[2], nbytes.value)

    def hammer():
        for _ in range(calls):
            C._end(C._begin("stress", hvt.global_process_set, x))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        hvt.shutdown()
    assert hist.snapshot()[2] - before[0] == threads_n * calls
    assert nbytes.value - before[1] == threads_n * calls * 12
    assert not [p for p in C.pending() if p["op"] == "stress"]
