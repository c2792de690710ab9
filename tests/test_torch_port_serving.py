"""horovod_tpu_torch.serving held against the JAX package's
``horovod_tpu/serving``.

- The JAX ``ReplicaGang`` and the port's, driven through one recording
  engine (the pattern of ``tests/test_serving.py:131``) by seeded call
  histories of submits (op changes among them), reaps, flushes, syncs and
  drains, under several partitions, windows and batch sizes: identical
  decision logs, slot names, batch boundaries, reap results and snapshot
  counts.
- ``partition_replicas``, ``_percentile`` and the ``ReplicaStats``
  reservoir bit for bit on the same inputs; ``validate_artifact`` and
  ``build_artifact`` on the same snapshots.
- The port's default engine registers every replica's set and then the
  sync set, on every rank, in one order.
- One 4-process gloo gang of the port's loadgen
  (``tests/torch_port_serve_worker.py``, started when this module loads)
  replaying ``tests/test_serving.py:968``'s config: a valid artifact, every
  result exact, the members of each replica with identical counts and
  decision logs, equal to the JAX ``ReplicaGang``'s on the same program,
  and the same sets registered on every rank.
"""

import copy
import random

import numpy as np
import pytest
import torch

import torch_port_serve_worker as S
from horovod_tpu.ops import collective_ops as jco
from horovod_tpu.serving import loadgen as jlg
from horovod_tpu.serving import replica_gang as jrg
from horovod_tpu_torch.ops import collective_ops as tco
from horovod_tpu_torch.serving import loadgen as tlg
from horovod_tpu_torch.serving import replica_gang as trg


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The loadgen gang, started before the JAX side computes."""
    out = str(tmp_path_factory.mktemp("serve") / "res")
    job = S.ServeLaunch(4, out, S.GANG_ARGV + ["--device", "cpu"])
    yield job
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.wait()


class _RecordingEngine:
    """An engine seam recording every submission (name, tensors, op,
    members); handles complete at once with their inputs."""

    def __init__(self, rank=0, size=1):
        self._rank, self._size = rank, size
        self.submits = []

    def rank(self):
        return self._rank

    def size(self):
        return self._size

    def submit(self, name, tensor, members, op="sum"):
        self.submits.append((name, 1, op, list(members)))
        return [tensor]

    def submit_batch(self, name, tensors, members, op="sum"):
        self.submits.append((name, len(tensors), op, list(members)))
        return list(tensors)

    def wait(self, handle, timeout=None):
        return handle if len(handle) > 1 else handle[0]


OPS = (None, "sum", "avg", "max", "min", "prod", "Average", "Max")
COUNTS = ("admitted", "shed", "completed", "deadline_miss", "batches",
          "rank", "replica", "inflight", "max_backlog", "batch_window",
          "admission_ms")


def _history(seed, n=400):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.55:
            out.append(("submit", rng.choice(OPS)))
        elif u < 0.8:
            out.append(("reap",))
        elif u < 0.87:
            out.append(("flush",))
        elif u < 0.95:
            out.append(("sync", rng.choice((None, "sum", "max"))))
        else:
            out.append(("drain",))
    return out


def _op(co, op):
    """A ReduceOp instance of the package (``co``) for a capitalized name,
    else the string."""
    return getattr(co, op) if op and op[0].isupper() else op


def _replay(rg, co, cfg, actions):
    eng = _RecordingEngine(cfg["rank"], cfg["world"])
    gang = rg.ReplicaGang(cfg["replicas"], admission_timeout=cfg["admit"],
                          max_backlog=cfg["backlog"],
                          batch_window=cfg["batch"], engine=eng,
                          partition=cfg.get("partition"), name="p")
    x = np.ones(4, np.float32)
    outs = []
    for a in actions:
        if a[0] == "submit":
            h = gang.submit_request(x, op=_op(co, a[1]))
            outs.append("shed" if h is None else
                        "queued" if h is True else "submitted")
        elif a[0] == "reap":
            out = gang.reap()
            outs.append(None if out is None else
                        len(out) if isinstance(out, list) else 1)
        elif a[0] == "flush":
            outs.append(gang.flush() is not None)
        elif a[0] == "sync":
            outs.append(float(np.asarray(gang.sync(x, op=a[1]))[0]))
        else:
            gang.drain()
            outs.append(gang.backlog())
    snap = gang.snapshot()
    return {"decisions": gang.decisions, "submits": eng.submits,
            "outs": outs, "counts": {k: snap[k] for k in COUNTS},
            "lanes": (gang.member_lists, gang.sync_members,
                      gang.replica_id, gang.my_members),
            "observed": len(gang.stats.latencies_ms)}


CONFIGS = [
    dict(world=1, rank=0, replicas=1, batch=1, backlog=4, admit=10.0),
    dict(world=4, rank=1, replicas=2, batch=4, backlog=8, admit=10.0),
    dict(world=4, rank=2, replicas=2, batch=1, backlog=3, admit=0.0),
    dict(world=5, rank=4, replicas=2, batch=3, backlog=6, admit=10.0),
    dict(world=4, rank=3, replicas=2, batch=2, backlog=4, admit=10.0,
         partition=[[0, 2], [1, 3]]),
    dict(world=4, rank=0, replicas=4, batch=2, backlog=2, admit=10.0),
]


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "w{world}r{rank}"
                         "x{replicas}b{batch}k{backlog}".format(**c))
def test_replica_gang_matches_the_jax_gang_on_one_call_history(cfg, seed):
    actions = _history(seed)
    want = _replay(jrg, jco, cfg, actions)
    got = _replay(trg, tco, cfg, actions)
    assert got["decisions"] == want["decisions"]
    assert got["submits"] == want["submits"]       # slot names, batches
    assert got["outs"] == want["outs"]
    assert got["counts"] == want["counts"]
    assert got["lanes"] == want["lanes"]
    assert got["observed"] == want["observed"]
    assert any(d[0] == "batch" for d in got["decisions"])
    if cfg["admit"] == 0.0:
        assert got["counts"]["deadline_miss"] == got["counts"]["completed"]


def test_opname_maps_the_ports_reduce_ops_and_rejects_unknown():
    gang = trg.ReplicaGang(1, admission_timeout=1.0, max_backlog=4,
                           engine=_RecordingEngine())
    for name in ("Average", "Sum", "Min", "Max", "Product", "Adasum"):
        assert gang._opname(getattr(tco, name)) == \
            jrg.ReplicaGang._opname(gang, getattr(jco, name))
    with pytest.raises(ValueError, match="unsupported"):
        gang._opname("xor")


@pytest.mark.parametrize("world,replicas", [(4, 2), (5, 2), (4, 4), (3, 1),
                                            (7, 3), (2, 3), (2, 0)])
def test_partition_replicas_matches(world, replicas):
    try:
        want = jrg.partition_replicas(world, replicas)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            trg.partition_replicas(world, replicas)
        return
    assert trg.partition_replicas(world, replicas) == want


def test_percentile_and_reservoir_match_bit_for_bit():
    rng = np.random.RandomState(3)
    for n in (0, 1, 2, 7, 100, 1001):
        vals = list(rng.exponential(2.0, n))
        for q in (0, 1, 50, 90, 99, 99.9, 100):
            assert trg._percentile(vals, q) == jrg._percentile(vals, q)
    js, ts = jrg.ReplicaStats(max_samples=64), trg.ReplicaStats(
        max_samples=64)
    for i, lat in enumerate(rng.exponential(3.0, 5000)):
        met = bool(i % 7)
        js.observe(float(lat), met)
        ts.observe(float(lat), met)
    assert ts.latencies_ms == js.latencies_ms
    assert (ts.completed, ts.deadline_miss) == (js.completed,
                                                js.deadline_miss)
    for q in (50, 99):
        assert ts.percentile(q) == js.percentile(q)


def _snaps():
    return {
        "baseline": [
            {"rank": r, "replica": r // 2, "admitted": 10, "shed": 2,
             "completed": 10, "deadline_miss": 1, "p50_ms": 1.0 + r,
             "p99_ms": 2.0 + r, "throughput_rps": 5.0} for r in range(4)],
        "contended": [
            {"rank": r, "replica": r // 2, "admitted": 10, "shed": 4,
             "completed": 10, "deadline_miss": 2, "p50_ms": 1.1,
             "p99_ms": 2.2 * (r + 1), "throughput_rps": 5.0}
            for r in range(4)],
    }


@pytest.mark.parametrize("config", [{"saturate_replica": 0},
                                    {"saturate_replica": 1},
                                    {"saturate_replica": None}, {}])
def test_build_and_validate_artifact_match(config):
    want = jlg.build_artifact(dict(config), copy.deepcopy(_snaps()))
    got = tlg.build_artifact(dict(config), copy.deepcopy(_snaps()))
    want.pop("created_unix")
    got.pop("created_unix")
    assert got == want
    assert tlg.validate_artifact(got) == jlg.validate_artifact(want) == []
    broken = [copy.deepcopy(got) for _ in range(5)]
    broken[0].pop("phases")
    broken[1]["schema"] = "x"
    del broken[2]["phases"]["baseline"]["ranks"][1]["p99_ms"]
    del broken[3]["phases"]["contended"]["replicas"]["0"]["shed"]
    broken[4]["isolation"] = {"ratio": 1.0}
    for doc in broken + [[], {"phases": {"a": 3}}]:
        assert tlg.validate_artifact(doc) == jlg.validate_artifact(doc)
        assert tlg.validate_artifact(doc)


def test_loadgen_check_cli(tmp_path):
    import json

    doc = tlg.build_artifact({"saturate_replica": 0}, _snaps())
    p = tmp_path / "art.json"
    p.write_text(json.dumps(doc))
    assert tlg.main(["--check", str(p)]) == 0
    doc.pop("phases")
    p.write_text(json.dumps(doc))
    assert tlg.main(["--check", str(p)]) == 1


def test_check_results_finds_a_wrong_result():
    payload = torch.arange(6, dtype=torch.float32) / 3
    ks = [0, 2, 5]
    results = [(payload + k) * 2 for k in ks[:2]] + [[(payload + 5) * 2]]
    assert tlg.check_results(results, ks, payload, 2) == {
        "checked": 3, "wrong": 0, "max_abs_err": 0.0}
    results[1] = results[1].clone()
    results[1][4] += 1e-6
    assert tlg.check_results(results, ks, payload, 2)["wrong"] == 1
    assert tlg.check_results(results[:2], ks, payload, 2)["wrong"] == 3


@pytest.mark.parametrize("rank", range(4))
def test_default_engine_registers_every_lane_on_every_rank(monkeypatch,
                                                           rank):
    """Members or not, every rank registers the replicas' sets and then
    the sync set, in one order (new_group is collective)."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import process_sets

    calls = []
    monkeypatch.setattr(basics, "rank", lambda: rank)
    monkeypatch.setattr(basics, "size", lambda: 4)
    monkeypatch.setattr(process_sets, "add_process_set",
                        lambda ranks: calls.append(list(ranks)) or ranks)
    gang = trg.ReplicaGang(2, partition=[[1, 3], [0, 2]])
    assert calls == [[1, 3], [0, 2], [0, 1]]
    assert gang.sync_members == [0, 1]
    calls.clear()
    trg.ReplicaGang(2)
    assert calls == [[0, 1], [2, 3], [0, 2]]
    calls.clear()
    trg.ReplicaGang(1)      # one replica: its set is the sync set
    assert calls == [[0, 1, 2, 3]]


def _jax_program_digest(argv, world, rank, phase):
    """The decision log's hash of the JAX ReplicaGang playing the loadgen's
    program (``loadgen.run_phase``) for ``rank`` in ``phase``, through the
    recording engine."""
    args = jlg._parser().parse_args(argv)
    eng = _RecordingEngine(rank, world)
    gang = jrg.ReplicaGang(args.replicas, admission_timeout=10.0,
                           max_backlog=args.window, engine=eng)
    saturated = phase == "contended" and \
        gang.replica_id == args.saturate_replica
    my_burst = args.burst * (args.saturate_factor if saturated else 1)
    watermark = max(0, gang.max_backlog - min(my_burst, gang.max_backlog))
    x = np.ones(4, np.float32)
    k = 0
    while k < args.requests:
        for _ in range(min(my_burst, args.requests - k)):
            gang.submit_request(x)
            k += 1
            if args.sync_every and k % args.sync_every == 0:
                gang.sync(x)
        while gang.backlog() > watermark:
            gang.reap()
    gang.drain()
    return tlg.decisions_digest(gang.decisions)


def test_loadgen_gang_of_four_on_gloo(gang):
    res = gang.results()
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    # global, both replicas' sets, the leaders' sync set: on every rank
    for r in res:
        assert r["sets"] == [None, [0, 1], [2, 3], [0, 2]]
    doc = res[0]["artifact"]
    assert all(r["artifact"] is None for r in res[1:])
    assert S.problems(doc, members=[[0, 1], [2, 3]]) == []
    assert set(doc["phases"]) == {"baseline", "contended"}
    assert sum(s["shed"] for p in doc["phases"].values()
               for s in p["ranks"]) > 0, "burst 6 > window 4 must shed"
    for pname, phase in doc["phases"].items():
        for s in phase["ranks"]:
            assert s["checked"] == s["admitted"] > 0
            assert s["max_abs_err"] == 0.0
            assert s["decisions_sha256"] == _jax_program_digest(
                S.GANG_ARGV, 4, s["rank"], pname), (pname, s["rank"])
    iso = doc["isolation"]
    assert iso["idle_p99_ms"] > 0 and iso["contended_p99_ms"] > 0
    assert doc["config"]["device"] == "cpu"
