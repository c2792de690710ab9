"""horovod_tpu_torch.elastic held against the JAX package's elastic modules
(``horovod_tpu/elastic``, ``horovod_tpu/torch/elastic``) on the same inputs:
the ElasticSampler's order, padding and resharding; the replica groups and
shard framing; the ReplicatedState scenarios of tests/test_elastic_state.py
over a thread world of collectives; the recovery loop's calls under the
same failure schedules; and a small GPT trained by the JAX package's
JaxState loop and the port's TorchState loop, each with one injected
failure (losses within 1e-4, the tolerance of test_torch_port_model.py).
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvt
import horovod_tpu_torch as hvt
from horovod_tpu.elastic import state as jstate
from horovod_tpu.torch.elastic import sampler as jsampler
from horovod_tpu_torch.elastic import sampler as psampler
from horovod_tpu_torch.elastic import state as pstate

# -------------------------------------------------------------- sampler

SAMPLER_CASES = [
    # (dataset size, world size, rank, epoch, batches recorded, batch size,
    #  shuffle)
    (10, 1, 0, 0, 0, 2, True),
    (10, 3, 1, 0, 1, 2, True),
    (17, 4, 3, 2, 2, 3, True),
    (17, 4, 0, 1, 1, 3, False),
    (64, 3, 2, 5, 4, 4, True),
    (5, 8, 7, 0, 0, 1, True),      # fewer rows than ranks: padding wraps
]


def _sampler(mod, monkeypatch, n, size, rank, shuffle, seed=0):
    monkeypatch.setattr(mod, "process_size", lambda: size)
    monkeypatch.setattr(mod, "process_rank", lambda: rank)
    return mod.ElasticSampler(list(range(n)), shuffle=shuffle, seed=seed)


def _view(s):
    return {"indices": list(s.indices), "len": len(s),
            "total_size": s.total_size, "remaining": list(s.remaining_indices),
            "state": s.state_dict()}


@pytest.mark.parametrize("case", SAMPLER_CASES,
                         ids=[f"n{c[0]}-w{c[1]}-r{c[2]}-e{c[3]}-b{c[4]}"
                              for c in SAMPLER_CASES])
def test_sampler_matches_reference(monkeypatch, case):
    n, size, rank, epoch, recorded, bsz, shuffle = case
    views = []
    for mod in (jsampler, psampler):
        s = _sampler(mod, monkeypatch, n, size, rank, shuffle, seed=3)
        steps = [_view(s)]
        s.set_epoch(epoch)
        steps.append(_view(s))
        for b in range(recorded):
            s.record_batch(b, bsz)
        steps.append(_view(s))
        # the world changes: one rank fewer (or the same world of one)
        monkeypatch.setattr(mod, "process_size", lambda: max(1, size - 1))
        monkeypatch.setattr(mod, "process_rank",
                            lambda: min(rank, max(0, size - 2)))
        s.reset()
        steps.append(_view(s))
        steps.append(list(iter(s)))
        fresh = _sampler(mod, monkeypatch, n, size, rank, shuffle, seed=3)
        fresh.load_state_dict(s.state_dict())
        steps.append(_view(fresh))
        views.append(steps)
    assert views[0] == views[1]
    if recorded:
        assert views[1][2]["state"]["processed_indices"]


# ------------------------------------------------- replica groups, shards

HOST_TABLES = {
    "flat_balanced": ["h0", "h0", "h1", "h1", "h2", "h2", "h3", "h3"],
    "racks": ["r0/h0", "r0/h0", "r0/h1", "r0/h1",
              "r1/h2", "r1/h2", "r1/h3", "r1/h3"],
    "rack_one_host": ["r0/h0", "r0/h0", "r1/h1", "r1/h1"],
    "skewed_racks": ["r0/h0", "r0/h0", "r0/h0", "r0/h1",
                     "r1/h2", "r1/h2", "r1/h3", "r1/h3"],
    "skewed_flat": ["h0", "h0", "h0", "h1"],
    "one_host": ["h0"] * 4,
    "remainder": ["h0", "h1", "h2", "h0", "h1"],
    "two": ["h0", "h1"],
    "mixed": ["r0/a", "b", "r0/c", "b", "r0/a", "d", "r0/c"],
}


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("table", sorted(HOST_TABLES))
def test_build_replica_groups_matches_reference(table, k):
    hosts = HOST_TABLES[table]
    got = pstate.build_replica_groups(hosts, k)
    assert got == jstate.build_replica_groups(hosts, k)
    assert sorted(r for g in got for r in g) == list(range(len(hosts)))


@pytest.mark.parametrize("owner,version,size", [(0, 1, 0), (7, 42, 1500),
                                                (3, 2 ** 40, 17)])
def test_shards_match_reference(owner, version, size):
    payload = np.random.RandomState(size).bytes(size)
    blob = pstate.encode_shard(owner, version, payload)
    assert blob == jstate.encode_shard(owner, version, payload)
    assert pstate.decode_shard(blob) == jstate.decode_shard(blob) == \
        (owner, version, payload)
    bad = [blob[:10], b"X" * len(blob), blob + b"extra"]
    if size:
        flipped = bytearray(blob)
        flipped[-1] ^= 0x40
        bad.append(bytes(flipped))
    for b in bad:
        with pytest.raises(pstate.ShardCorruptError) as got:
            pstate.decode_shard(b)
        with pytest.raises(jstate.ShardCorruptError) as want:
            jstate.decode_shard(b)
        assert str(got.value) == str(want.value)


def test_replica_env_switches_match_reference(monkeypatch):
    for k, rep, part in (("", "1", "1"), ("3", "0", "0"), ("x", "off", "1")):
        monkeypatch.setenv("HVT_REPLICA_GROUP_SIZE", k)
        monkeypatch.setenv("HVT_STATE_REPLICATION", rep)
        monkeypatch.setenv("HVT_PARTIAL_FALLBACK", part)
        for name in ("replica_group_size", "replication_enabled",
                     "partial_fallback_enabled"):
            assert getattr(pstate, name)() == getattr(jstate, name)()


# ----------------------------------------- ReplicatedState over threads

class _ThreadWorld:
    """Barrier-based allgather shared by n in-process ranks: the
    collectives tests/test_elastic_state.py drives ReplicatedState with."""

    def __init__(self, n):
        self.n = n
        self.cond = threading.Condition()
        self.boxes = {}
        self.seqs = {}

    def collectives(self, rank, host):
        return _ThreadCollectives(self, rank, host)


class _ThreadCollectives:
    def __init__(self, world, rank, host):
        self.w, self._rank, self._host = world, rank, host

    def rank(self):
        return self._rank

    def size(self):
        return self.w.n

    def host(self):
        return self._host

    def allgather(self, obj, name, ranks=None):
        ranks = sorted(ranks) if ranks is not None else list(range(self.w.n))
        seq = self.w.seqs.get((self._rank, name), 0)
        self.w.seqs[(self._rank, name)] = seq + 1
        key = (name, seq, tuple(ranks))
        with self.w.cond:
            self.w.boxes.setdefault(key, {})[self._rank] = obj
            self.w.cond.notify_all()
            while len(self.w.boxes[key]) < len(ranks):
                if not self.w.cond.wait(10.0):
                    raise RuntimeError(f"allgather {key} timed out")
        return [self.w.boxes[key][r] for r in ranks]


_HOSTS4 = ["h0", "h0", "h1", "h1"]


def _gang(fn, n):
    errs = []

    def body(r):
        try:
            fn(r)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append((r, e))

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return sorted((r, type(e).__name__) for r, e in errs)


def _committed(mod, steps=3, n=4):
    w = _ThreadWorld(n)
    states = [None] * n

    def run_rank(r):
        s = mod.ReplicatedState(collectives=w.collectives(r, _HOSTS4[r]),
                                x=0, series=[])
        states[r] = s
        for step in range(steps):
            s.x = step
            s.series.append((r, step))
            s.commit()

    assert _gang(run_rank, n) == []
    return states


def _resync(states, world, hosts=_HOSTS4, fresh=None):
    """Move ``states`` (and fresh ones, by rank) into ``world`` and sync."""
    fresh = fresh or {}

    def body(r):
        s = fresh.get(r) or states[r]
        if r not in fresh:
            s._collectives = world.collectives(r, hosts[r])
        s.sync()

    return _gang(body, world.n)


def _outcome(s):
    rec = dict(s.last_recovery)
    rec.pop("seconds", None)
    return {"x": s.x, "series": getattr(s, "series", None), "owner": s.owner,
            "version": s.version, "recovery": rec,
            "adopted": copy.deepcopy(s.adopted),
            "held": s.replica_info()["held"],
            "group": s.replica_info()["group"]}


def _corrupt(states, owners):
    for s in states:
        for owner in owners:
            gens = s._peer_shards.get(owner)
            if gens:
                s._peer_shards[owner] = [
                    (v, b[:-1] + bytes([b[-1] ^ 0xFF])) for v, b in gens]


def scenario_commit(mod):
    return [_outcome(s) for s in _committed(mod)]


def scenario_shrink_adopts_orphan(mod):
    states = _committed(mod)
    errs = _resync(states[:3], _ThreadWorld(3))
    return errs, [_outcome(s) for s in states[:3]]


def scenario_orphans_retire(mod):
    states = _committed(mod)
    _resync(states[:3], _ThreadWorld(3))

    def more(r):
        for step in range(5):
            states[r].x = 100 + step
            states[r].commit()

    errs = _gang(more, 3)
    errs += _resync(states[:3], _ThreadWorld(3))
    return errs, [_outcome(s) for s in states[:3]]


def scenario_fresh_rank_new_lineage(mod):
    states = _committed(mod, steps=2)
    w2 = _ThreadWorld(4)
    survivors = states[1:]
    fresh = mod.ReplicatedState(collectives=w2.collectives(3, _HOSTS4[3]),
                                x=0, series=[])
    errs = _resync(survivors + [None], w2, fresh={3: fresh})
    return errs, [_outcome(s) for s in survivors + [fresh]]


def scenario_version_skew_rollback(mod):
    w = _ThreadWorld(4)
    states = [None] * 4

    def run_rank(r):
        s = mod.ReplicatedState(collectives=w.collectives(r, _HOSTS4[r]),
                                x=0)
        states[r] = s
        for step in range(2 + (1 if r in (0, 2) else 0)):
            s.x = step
            s.commit()

    errs = _gang(run_rank, 4)
    errs += _resync(states[:3], _ThreadWorld(3))
    return errs, [_outcome(s) for s in states[:3]]


def scenario_respawn_from_peer(mod):
    states = _committed(mod, steps=2)
    w2 = _ThreadWorld(4)
    fresh = mod.ReplicatedState(collectives=w2.collectives(3, _HOSTS4[3]),
                                x=0, series=[])
    errs = _resync(states, w2, fresh={3: fresh})
    return errs, [_outcome(s) for s in states[:3] + [fresh]]


def scenario_stale_shard_rejected(mod):
    s = _committed(mod)[0]
    peer = [o for o in s.replica_info()["held"] if o != 0][0]
    s._ingest(mod.encode_shard(peer, 1, b"ancient"))
    bad = bytearray(mod.encode_shard(peer, 9, b"corrupt"))
    bad[-1] ^= 0xFF
    s._ingest(bytes(bad))
    return _outcome(s)


def _fallback_scenario(mod, lost):
    states = _committed(mod, steps=3 if len(lost) > 1 else 2)
    _corrupt(states, lost)
    w2 = _ThreadWorld(4)
    fellback = []

    def fallback(st):
        fellback.append(True)
        st.x = 99
        st.series = ["from-checkpoint"]

    fresh = {r: mod.ReplicatedState(collectives=w2.collectives(r, _HOSTS4[r]),
                                    fallback=fallback, x=0, series=[])
             for r in lost}
    for s in states:
        s._fallback = fallback
    errs = _resync(states, w2, fresh=fresh)
    final = [fresh.get(r) or states[r] for r in range(4)]
    return errs, len(fellback), [_outcome(s) for s in final]


def scenario_crc_fallback_per_lineage(mod):
    return _fallback_scenario(mod, [3])


def scenario_partial_loss_two_lineages(mod):
    return _fallback_scenario(mod, [2, 3])


def scenario_gang_wide_fallback_when_disabled(mod, monkeypatch):
    monkeypatch.setenv("HVT_PARTIAL_FALLBACK", "0")
    return _fallback_scenario(mod, [3])


def scenario_replica_unavailable_raises(mod):
    states = _committed(mod, steps=2)
    _corrupt(states, [3])
    w2 = _ThreadWorld(4)
    fresh = mod.ReplicatedState(collectives=w2.collectives(3, _HOSTS4[3]),
                                x=0, series=[])
    return _resync(states, w2, fresh={3: fresh})


def scenario_grow_bootstraps(mod):
    states = _committed(mod, steps=2, n=2)
    hosts3 = ["h0", "h0", "h1"]
    w2 = _ThreadWorld(3)
    new = mod.ReplicatedState(collectives=w2.collectives(2, hosts3[2]), x=0,
                              series=[])
    errs = _resync(states + [None], w2, hosts=hosts3, fresh={2: new})
    return errs, [_outcome(s) for s in states + [new]]


def scenario_replication_disabled(mod, monkeypatch):
    monkeypatch.setenv("HVT_STATE_REPLICATION", "0")
    calls = []

    class NoCollectives:
        def rank(self):
            return 0

        def size(self):
            return 4

        def host(self):
            return "h0"

        def allgather(self, obj, name, ranks=None):
            calls.append(name)
            raise AssertionError("disabled replication must not exchange")

    s = mod.ReplicatedState(collectives=NoCollectives(), x=1)
    s.commit()
    return calls, s.version


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replicated_state_scenario_matches_reference(name, monkeypatch):
    fn = SCENARIOS[name]
    takes_env = fn.__code__.co_argcount == 2
    got, want = ((fn(mod, monkeypatch) if takes_env else fn(mod))
                 for mod in (pstate, jstate))
    assert got == want


# ----------------------------------------------------- the recovery loop

@pytest.fixture()
def cpu_world():
    hvt.init(device="cpu")
    yield
    hvt.shutdown()


def _loop(pkg, state_cls, schedule):
    """Run ``pkg.elastic.run`` over a recording ObjectState for four steps,
    with ``schedule`` {step: "error" | "update" | "update_skip_sync"} raised
    once each; returns the calls made and the final state."""
    calls = []

    class Recording(state_cls):
        def restore(self):
            calls.append(("restore", self.batch))
            super().restore()

        def sync(self):
            calls.append(("sync", self.batch))
            super().sync()

        def reset(self):
            calls.append(("reset", self.batch))

    pending = dict(schedule)

    @pkg.elastic.run
    def train(state):
        calls.append(("enter", state.batch))
        while state.batch < 4:
            state.batch += 1
            state.log.append(state.batch)
            what = pending.pop(state.batch, None)
            if what == "error":
                raise pkg.HorovodInternalError("injected")
            if what == "update_skip_sync":
                state.commit()
                raise pkg.HostsUpdatedInterrupt(skip_sync=True)
            if what == "update":
                state.on_hosts_updated(1.0, 0)
            state.commit()
        return state.batch

    state = Recording(batch=0, log=[])
    result = train(state)
    return calls, result, state.batch, state.log


SCHEDULES = {
    "error_at_2": {2: "error"},
    "update_at_3": {3: "update"},
    "update_skip_sync_at_1": {1: "update_skip_sync"},
    "error_then_update": {2: "error", 4: "update"},
    "update_then_error": {1: "update", 3: "error"},
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_recovery_loop_calls_match_reference(cpu_world, schedule):
    from horovod_tpu.elastic import ObjectState as JObjectState

    got = _loop(hvt, hvt.elastic.ObjectState, SCHEDULES[schedule])
    want = _loop(jhvt, JObjectState, SCHEDULES[schedule])
    assert got == want
    assert hvt.device().type == "cpu"      # re-initialized on the CPU


def test_host_update_is_consumed_and_cleared_on_reset(cpu_world):
    s = hvt.elastic.ObjectState(epoch=0)
    s.on_hosts_updated(1.0, 1)
    with pytest.raises(hvt.HostsUpdatedInterrupt):
        s.commit()
    s.commit()                          # consumed
    s.on_hosts_updated(2.0, 1)
    s.on_reset()                        # the reset absorbed it
    s.commit()


def test_commit_after_abort_raises_and_keeps_the_last_commit(cpu_world):
    s = hvt.elastic.ObjectState(step=1)
    s.step = 2
    hvt.common.basics.abort("a peer died")
    with pytest.raises(hvt.HorovodInternalError, match="a peer died"):
        s.commit()
    with pytest.raises(hvt.HorovodInternalError, match="aborted"):
        hvt.allgather(torch.ones(2))
    s.restore()
    assert s.step == 1
    hvt.shutdown()
    hvt.common.basics.reinit()
    assert hvt.is_initialized() and hvt.device().type == "cpu"
    assert float(hvt.allreduce(torch.ones(2)).sum()) == 2.0


def test_torch_state_restores_model_optimizer_sampler(cpu_world):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   backward_passes_per_step=2)
    sampler = hvt.elastic.ElasticSampler(list(range(8)), seed=1)
    state = hvt.elastic.TorchState(model=model, optimizer=opt,
                                   sampler=sampler, epoch=0)

    def update():
        for _ in range(2):
            model(torch.ones(4, 3)).sum().backward()
            opt.step()

    update()
    sampler.record_batch(0, 2)
    state.epoch = 1
    state.commit()
    saved = ({k: v.clone() for k, v in model.state_dict().items()},
             copy.deepcopy(opt.state_dict()), sampler.state_dict())
    update()
    model(torch.ones(4, 3)).sum().backward()
    opt.step()                   # one pass of the next update held
    sampler.record_batch(1, 2)
    state.epoch = 2
    state.restore()
    assert state.epoch == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[0][k])
    assert sampler.state_dict() == saved[2]
    assert opt._hvt_acc == {} and opt._hvt_passes == 0
    got = opt.state_dict()["state"]
    for i, s in saved[1]["state"].items():
        for k, v in s.items():
            assert torch.equal(got[i][k], v), (i, k)
    # the restored state does not alias the snapshot
    update()
    state.restore()
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[0][k])
    state.sync()
    assert sampler.state_dict() == saved[2]


def test_replicated_torch_state_snapshots_to_host(cpu_world):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    s = hvt.elastic.ReplicatedTorchState(model=model, optimizer=opt, step=0)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    s.step = 1
    s.commit()
    assert s.version == 1
    snap = s._saved_state
    assert set(snap) == {"model", "optimizer", "step"}
    assert all(t.device.type == "cpu" for t in snap["model"].values())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.weight.add_(1.0)
    s.step = 5
    s.restore()
    assert s.step == 1
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


# ------------------------------------------- the slice: a small GPT loop

GPT_SMALL = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
                 max_seq_len=16)
GPT_STEPS, GPT_FAIL_AT, GPT_TOL = 5, 3, 1e-4


def _tokens():
    return np.random.RandomState(5).randint(0, 64, (GPT_STEPS, 2, 16))


def _jax_elastic_losses():
    from horovod_tpu.models import GPT as JaxGPT
    from horovod_tpu.models import GPTConfig as JaxGPTConfig

    data = jnp.asarray(_tokens())
    model = JaxGPT(JaxGPTConfig(**GPT_SMALL, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0), data[0])["params"]
    tx = jhvt.DistributedOptimizer(optax.adamw(1e-3), axis_name=None)

    def loss(p, tokens):
        logits = model.apply({"params": p}, tokens)
        targets = jnp.roll(tokens, -1, axis=-1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], targets[:, :-1]).mean()

    @jax.jit
    def step(p, s, tokens):
        value, grads = jax.value_and_grad(loss)(p, tokens)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, value

    start = jax.tree.map(np.asarray, params)
    state = jhvt.elastic.JaxState(params=params, opt_state=tx.init(params),
                                  batch=0)
    losses, failed = {}, []

    @jhvt.elastic.run
    def train(state):
        while state.batch < GPT_STEPS:
            p, s, value = step(state.params, state.opt_state,
                               data[state.batch])
            if state.batch + 1 == GPT_FAIL_AT and not failed:
                failed.append(float(value))
                raise jhvt.HorovodInternalError("injected")
            state.params, state.opt_state = p, s
            state.batch += 1
            losses[state.batch] = float(value)
            state.commit()

    train(state)
    return start, [losses[i + 1] for i in range(GPT_STEPS)], failed


def test_small_gpt_elastic_loop_matches_reference(cpu_world):
    """The same weights (models/convert.py) and tokens: the JAX package's
    JaxState loop and the port's TorchState loop, each failing once at
    step 3 after its update and before its commit, give the same losses."""
    from horovod_tpu_torch.models import GPT, GPTConfig
    from horovod_tpu_torch.models.convert import params_from_flax
    from horovod_tpu_torch.train import make_train_step

    start, want, jax_failed = _jax_elastic_losses()
    data = torch.from_numpy(_tokens())
    model = GPT(GPTConfig(**GPT_SMALL, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_flax(start))
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    step = make_train_step(model, opt)
    state = hvt.elastic.TorchState(model=model, optimizer=opt, batch=0)
    losses, failed = {}, []

    @hvt.elastic.run
    def train(state):
        while state.batch < GPT_STEPS:
            value = float(step(data[state.batch]))
            if state.batch + 1 == GPT_FAIL_AT and not failed:
                failed.append(value)
                raise hvt.HorovodInternalError("injected")
            state.batch += 1
            losses[state.batch] = value
            state.commit()

    train(state)
    got = [losses[i + 1] for i in range(GPT_STEPS)]
    np.testing.assert_allclose(got, want, rtol=GPT_TOL, atol=GPT_TOL)
    np.testing.assert_allclose(failed, jax_failed, rtol=GPT_TOL,
                               atol=GPT_TOL)
    assert failed == [got[GPT_FAIL_AT - 1]]    # the redone step, same bits
    assert hvt.device().type == "cpu"
