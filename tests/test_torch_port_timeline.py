"""horovod_tpu_torch.utils.timeline against the JAX package's timeline: the
cases of ``tests/test_timeline.py`` that need no engine, run on both
modules; a merge of shards written by both; the port's own additions (the
torch.profiler session, a shard extended across an elastic reset, RECOVERY
events, the merge CLI, the launcher's fallback to a killed worker's local
shard); and a launched 2-process gloo job with ``--timeline`` whose merged
trace has both ranks and the port's activity names. The device spans of
CUDA collectives are checked on the card (``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``)."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from horovod_tpu.utils import timeline as jax_tl
from horovod_tpu_torch.utils import timeline as port_tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = {"jax": jax_tl, "port": port_tl}


@pytest.fixture(params=sorted(MODS))
def tl(request):
    return MODS[request.param]


def _start(T, path, **kw):
    """``start`` without a profiler session on either package."""
    off = {"xla_profiler": False} if T is jax_tl else {"profiler": False}
    T.start(path, **off, **kw)


def _balanced(events):
    for tid in {e["tid"] for e in events if e.get("ph") in ("B", "E")}:
        b = sum(1 for e in events if e.get("tid") == tid and e["ph"] == "B")
        e_ = sum(1 for e in events if e.get("tid") == tid and e["ph"] == "E")
        if b != e_:
            return False
    return True


def test_timeline_produces_valid_chrome_trace(tl, tmp_path):
    path = str(tmp_path / "timeline.json")
    _start(tl, path, mark_cycles=True)
    tl.negotiate_start("grad/w", "ALLREDUCE")
    tl.negotiate_end("grad/w")
    tl.activity_start("grad/w", "MEMCPY_IN_FUSION_BUFFER")
    tl.activity_end("grad/w")
    tl.activity_start("grad/b", "NCCL_ALLREDUCE")
    tl.activity_end("grad/b")
    tl.mark_cycle()
    tl.stop()
    with open(path) as f:
        events = json.load(f)
    names = {e.get("args", {}).get("name") for e in events
             if e.get("ph") == "M"}
    assert {"grad/w", "grad/b"} <= names
    assert any(e.get("name") == "NEGOTIATE_ALLREDUCE" for e in events)
    assert any(e.get("name") == "CYCLE_START" for e in events)
    assert _balanced(events)


def test_mark_cycle_dedicated_lane(tl, tmp_path):
    path = str(tmp_path / "cyc.json")
    _start(tl, path, mark_cycles=True, pid=3)
    tl.activity_start("tensor0", "WORK")
    tl.activity_end("tensor0")
    tl.mark_cycle()
    tl.stop()
    with open(path) as f:
        events = json.load(f)
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    cycle = [e for e in events if e.get("name") == "CYCLE_START"]
    work = [e for e in events if e.get("name") == "WORK"]
    assert lanes[cycle[0]["tid"]] == "CYCLE"
    assert lanes[work[0]["tid"]] == "tensor0"
    assert {e["pid"] for e in events} == {3}
    assert any(e.get("name") == "process_name"
               and e["args"]["name"] == "rank 3" for e in events)


def test_timeline_flushes_before_close(tl, tmp_path):
    path = str(tmp_path / "flush.json")
    _start(tl, path)
    tl.activity_start("t", "STEP")
    tl.activity_end("t")
    deadline, events = time.time() + 5, []
    while time.time() < deadline:
        with open(path) as f:
            events = tl.parse_trace(f.read())
        if any(e.get("name") == "STEP" for e in events):
            break
        time.sleep(0.05)
    tl.stop()
    assert any(e.get("name") == "STEP" for e in events), events


def test_timeline_start_stop_idempotent(tl, tmp_path):
    path = str(tmp_path / "t2.json")
    _start(tl, path)
    _start(tl, path)
    tl.stop()
    tl.stop()
    assert not tl.active()


def test_parse_trace_repairs_a_truncated_shard(tl):
    text = '[\n{"ph": "M", "pid": 1, "name": "process_name", ' \
           '"args": {"name": "rank 1"}},\n{"ph": "B", "pid": 1, "ts": 5},\n' \
           '{"ph": "E", "pid": 1, "t'
    events = tl.parse_trace(text)
    assert [e["ph"] for e in events] == ["M", "B"]
    assert tl.parse_trace(text.rsplit(",", 1)[0]) == events


def test_merge_of_shards_from_both_packages(tmp_path):
    """One viewer reads both: a JAX shard and a port shard merge into one
    trace, metadata first, each pid named."""
    paths = []
    for pid, T in ((0, jax_tl), (1, port_tl)):
        path = str(tmp_path / f"shard{pid}.json")
        _start(T, path, pid=pid)
        T.activity_start("grad/w", "EAGER_ALLREDUCE")
        T.activity_end("grad/w")
        T.stop()
        paths.append(path)
    for T in (jax_tl, port_tl):
        out = str(tmp_path / f"merged_{T.__name__}.json")
        n = T.merge_files(paths, out)
        with open(out) as f:
            merged = json.load(f)
        assert len(merged) == n
        assert {e["pid"] for e in merged} == {0, 1}
        phases = [e.get("ph") for e in merged]
        assert phases.index("B") > max(i for i, p in enumerate(phases)
                                       if p == "M")
        assert {e["args"]["name"] for e in merged
                if e.get("name") == "process_name"} == {"rank 0", "rank 1"}
        ts = [e["ts"] for e in merged if e.get("ph") != "M"]
        assert ts == sorted(ts)
    assert json.load(open(str(tmp_path / "merged_horovod_tpu.utils."
                                         "timeline.json"))) == \
        json.load(open(str(tmp_path / "merged_horovod_tpu_torch.utils."
                                      "timeline.json")))


def test_profiler_session_writes_beside_the_trace(tmp_path):
    """The counterpart of the JAX package's XLA profiler session: a
    torch.profiler Chrome trace at <path>.profiler.json."""
    path = str(tmp_path / "tl.json")
    port_tl.start(path, profiler=True)
    x = torch.randn(64, 64)
    (x @ x).sum()
    port_tl.stop()
    with open(path) as f:
        json.load(f)
    with open(port_tl.profiler_trace_path(path)) as f:
        prof = json.load(f)
    names = {e.get("name") for e in prof["traceEvents"]}
    assert any(n and "mm" in n for n in names), sorted(n for n in names
                                                       if n)[:40]


def test_shard_extends_across_a_restart_and_records_recovery(tmp_path):
    """An elastic reset stops the timeline and reinit starts it again on
    the same shard: the second round's events extend the array, lanes keep
    their ids, and recovery phases land as RECOVERY events."""
    path = str(tmp_path / "shard.json")
    port_tl.start(path, profiler=False, pid=2, meta={
        "clock_sync": {"server": "x:1", "error": "OSError: refused"}})
    port_tl.activity_start("grad/w", "A")
    port_tl.activity_end("grad/w")
    port_tl.stop()
    port_tl.start(path, profiler=False, pid=2, append=True)
    port_tl.activity_start("grad/b", "B")
    port_tl.activity_end("grad/b")
    port_tl.activity_start("grad/w", "A2")
    port_tl.activity_end("grad/w")
    port_tl.record_recovery("rendezvous", "ok", 0.25)
    port_tl.stop()
    with open(path) as f:
        events = json.load(f)
    by_name = {e.get("name"): e for e in events}
    assert by_name["A"]["tid"] == by_name["A2"]["tid"] != by_name["B"]["tid"]
    rec = by_name["RECOVERY(rendezvous, ok)"]
    assert rec["args"] == {"phase": "rendezvous", "outcome": "ok",
                           "duration_us": 250000}
    assert by_name["clock_sync"]["args"]["error"] == "OSError: refused"
    lanes = [e for e in events if e.get("name") == "thread_name"]
    assert len({e["tid"] for e in lanes}) == len(lanes) == 3
    assert _balanced(events)


def test_merge_cli_and_killed_worker_fallback(tmp_path):
    from horovod_tpu_torch.runner.http_server import _Store
    from horovod_tpu_torch.runner.launch import merge_timeline_shards

    base = str(tmp_path / "job.json")
    _start(port_tl, base + ".rank0", pid=0)
    port_tl.activity_start("x", "EAGER_ALLREDUCE")
    port_tl.activity_end("x")
    port_tl.stop()
    # rank 1 was killed mid-write: no closing bracket, a torn last event
    with open(base + ".rank1", "w") as f:
        f.write('[\n{"name": "process_name", "ph": "M", "pid": 1, "args": '
                '{"name": "rank 1"}},\n{"ph": "B", "pid": 1, "tid": 0, '
                '"ts": 1.0, "name": "EAGER_ALLGATHER"},\n{"ph": "E", "p')
    store = _Store()
    with open(base + ".rank0", "rb") as f:
        store.put("timeline", "0", f.read())
    assert merge_timeline_shards(base, store, expected_ranks=range(3)) == 2
    with open(base) as f:
        merged = json.load(f)
    assert {e["pid"] for e in merged} == {0, 1}
    out = str(tmp_path / "cli.json")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.utils.timeline", "merge",
         base + ".rank0", base + ".rank1", "-o", out], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "merged 2 shard(s)" in proc.stdout
    with open(out) as f:
        assert json.load(f) == merged


def test_init_records_the_shard_and_reinit_extends_it(tmp_path,
                                                      monkeypatch):
    """In one process: HVT_TIMELINE_SHARD and HVT_METRICS_PORT start both
    at init; shutdown stops both; reinit brings both back on the same
    shard and the same port."""
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.common import basics

    base = str(tmp_path / "w.json")
    monkeypatch.setenv("HVT_TIMELINE_SHARD", base)
    monkeypatch.setenv("HVT_METRICS_PORT", "0")
    monkeypatch.setattr(basics, "_observe",
                        {"metrics_port": None, "shard": None})
    hvt.shutdown()
    hvt.init(device="cpu")
    try:
        port = metrics.server_port()
        assert port and port_tl.active()
        hvt.allreduce(torch.ones(3), name="round1")
        hvt.shutdown()
        assert not port_tl.active() and metrics.server_port() is None
        basics.reinit()
        assert metrics.server_port() == port
        hvt.allreduce(torch.ones(3), name="round2")
        diag = hvt.diagnostics()
        assert diag["timeline_active"] and diag["pending"] == []
        assert diag["engine"] == {"running": False} and not diag["joined"]
    finally:
        hvt.shutdown()
    with open(base + ".rank0") as f:
        events = json.load(f)
    spans = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert spans["GLOO_ALLREDUCE"]["args"]["clock"] == "host"
    lanes = {e["args"]["name"] for e in events
             if e.get("name") == "thread_name"}
    assert {"round1", "round2"} <= lanes


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``launch -np 2 --timeline T`` of torch_port_observe_worker.py."""
    d = tmp_path_factory.mktemp("timeline_job")
    trace, out = str(d / "trace.json"), str(d / "res")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--master-port", str(_free_port()), "--timeline", trace,
         sys.executable,
         os.path.join(REPO, "tests", "torch_port_observe_worker.py"),
         "timeline", out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(trace) as f:
        merged = json.load(f)
    res = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            res.append(json.load(f))
    return merged, res, proc.stderr


def test_launched_job_merges_one_trace_with_a_pid_per_rank(launched):
    merged, res, stderr = launched
    assert "timeline: merged 2 shard(s)" in stderr
    assert {e["pid"] for e in merged} == {0, 1}
    for r in range(2):
        assert res[r]["env"]["HVT_TIMELINE_SHARD"].endswith("trace.json")
        assert res[r]["env"]["HVT_DIAG_ADDR"].startswith("127.0.0.1:")
        mine = [e for e in merged if e["pid"] == r]
        names = {e.get("name") for e in mine}
        assert {"GLOO_ALLREDUCE", "GLOO_ALLGATHER", "GLOO_BARRIER"} <= names
        lanes = {e["args"]["name"] for e in mine
                 if e.get("name") == "thread_name"}
        assert {"grad/w", "rows", "allreduce", "barrier"} <= lanes
        sync = [e for e in mine if e.get("name") == "clock_sync"]
        assert sync and "offset_us" in sync[0]["args"], sync
        assert res[r]["diagnostics"]["pending"] == []


def test_launched_job_spans_carry_bytes_and_process_set(launched):
    merged, _, _ = launched
    spans = [e for e in merged if e.get("name") == "GLOO_ALLGATHER"]
    assert sorted(e["args"]["bytes"] for e in spans) == [8, 16]
    assert all(e["args"]["process_set"] == "global" and e["dur"] >= 0
               for e in spans)


def test_recovery_episode_feeds_the_timeline_and_the_metrics(tmp_path,
                                                             monkeypatch):
    """An elastic recovery, as the JAX package's ``_Recovery.finish``
    reports it: every phase as a RECOVERY event, then the episode in
    ``hvt_recovery_rounds_total{trigger}`` and
    ``hvt_recovery_end_to_end_seconds`` (the JAX families' names)."""
    import importlib

    from horovod_tpu_torch import metrics

    # the package's ``elastic.run`` is the decorator; the module by name
    run = importlib.import_module("horovod_tpu_torch.elastic.run")
    monkeypatch.delenv("HVT_RENDEZVOUS_ADDR", raising=False)
    rounds = metrics.counter("hvt_recovery_rounds_total",
                             "completed elastic recovery episodes by "
                             "trigger", ("trigger",)).labels(
        trigger="failure")
    before = rounds.value
    path = str(tmp_path / "rec.json")
    port_tl.start(path, profiler=False, pid=1)
    rec = run._Recovery("failure")
    rec.phase("restore", 0.5)
    rec.phase("rebuild", 0.25, outcome="peer")
    rec.finish(2)
    port_tl.stop()
    assert rounds.value == before + 1
    assert metrics.registry().get(
        "hvt_recovery_end_to_end_seconds").value > 0
    with open(path) as f:
        names = [e["name"] for e in json.load(f)
                 if e.get("name", "").startswith("RECOVERY")]
    assert names == ["RECOVERY(restore, ok)", "RECOVERY(rebuild, peer)",
                     "RECOVERY(recovered, ok)"]
