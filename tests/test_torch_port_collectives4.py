"""horovod_tpu_torch's collective surface on a 4-process gloo gang, held
against the JAX package.

One gang (tests/torch_port_gang.py) runs every call once: ranks 0,1 on
"host" 0 and ranks 2,3 on "host" 1 (HVT_LOCAL_SIZE=2). Calls with even
shapes are held against the JAX package's traced ops under jax.shard_map on
4 CPU devices with the same per-rank inputs; over a process set only the
members' results are compared, since the traced path also reduces the
complement (common/process_sets.py). Calls whose semantics the traced path
cannot express (ragged allgather, alltoall with uneven splits, async
handles, non-members, sparse rows) are held against numpy, as the JAX
docstrings state the engine's semantics.

Tolerances: fp32 rtol 1e-5 / atol 1e-6 (the same sums in another order);
Adasum rtol 1e-5 / atol 1e-6 (the JAX path rebuilds the partner's vector as
(a + b) - mine, the port receives it whole); integers and the bf16 cases,
which hold small integers, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvt
import horovod_tpu_torch as hvt
import torch_port_gang as G
from horovod_tpu.ops.adasum import adasum_reduce as jax_adasum_reduce
from horovod_tpu.ops.hierarchical import (
    hierarchical_allgather as jax_hierarchical_allgather,
    hierarchical_allreduce as jax_hierarchical_allreduce)
from horovod_tpu_torch.models import GPTConfig
from horovod_tpu_torch.train import train

N, LOCAL = 4, 2
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gang4") / "res")
    return G.run_gang(N, LOCAL, "cpu", out), out


def _shard(fn, *stacked, axes=("x",), n_out=1):
    """Run ``fn`` on N CPU devices, device i taking row block i of each
    stacked input; returns each output as [N, ...] (device i's result)."""
    devices = np.array(jax.devices()[:N])
    mesh = Mesh(devices.reshape(2, 2) if len(axes) == 2 else devices, axes)
    spec = P(axes if len(axes) == 2 else axes[0])
    f = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * len(stacked),
                      out_specs=(spec,) * n_out if n_out > 1 else spec)
    outs = jax.jit(f)(*[jnp.asarray(a.reshape((-1,) + a.shape[2:]))
                        for a in stacked])
    outs = outs if n_out > 1 else (outs,)
    return [np.asarray(o).reshape((N, -1) + o.shape[1:]) for o in outs]


def _members(k):
    return G.sets(N)[k]


def _jax_cases():
    d = G.inputs(N)
    x = d["x"]
    sets = [jhvt.ProcessSet(s) for s in G.sets(N)]

    def groups(k):
        return [list(s) for s in (G.sets(N)[k],)] + [
            [r] for r in range(N) if r not in G.sets(N)[k]]

    cases = {
        "allgather": lambda: _shard(
            lambda t: jhvt.allgather(t, axis_name="x"), x),
        "alltoall": lambda: _shard(
            lambda t: jhvt.alltoall(t, axis_name="x"), x),
        "reducescatter_avg": lambda: _shard(
            lambda t: jhvt.reducescatter(t, axis_name="x"), x),
        "reducescatter_sum_scaled": lambda: _shard(
            lambda t: jhvt.reducescatter(t, op=jhvt.Sum, axis_name="x",
                                         prescale_factor=0.5,
                                         postscale_factor=3.0), x),
        "grouped_allreduce": lambda: _shard(
            lambda a, b, c: tuple(jhvt.grouped_allreduce([a, b, c],
                                                         axis_name="x")),
            x, d["y"][:, None], d["z"][:, None], n_out=3),
        "hier_sum": lambda: _shard(
            lambda t: jax_hierarchical_allreduce(t), d["hier"],
            axes=("hvt_cross", "hvt_local")),
        "hier_avg": lambda: _shard(
            lambda t: jax_hierarchical_allreduce(t, average=True), d["hier"],
            axes=("hvt_cross", "hvt_local")),
        "hier_allgather": lambda: _shard(
            lambda t: jax_hierarchical_allgather(t), d["hier"][:, :2],
            axes=("hvt_cross", "hvt_local")),
    }
    for k in (0, 1):
        for op in ("avg", "sum"):
            cases[f"set{k}_{op}"] = lambda k=k, op=op: _shard(
                lambda t: jhvt.allreduce(
                    t, op=jhvt.Average if op == "avg" else jhvt.Sum,
                    axis_name="x", process_set=sets[k]), x)
    for lvl in (1, 2):
        cases[f"adasum_world_l{lvl}"] = lambda lvl=lvl: _shard(
            lambda t: jax_adasum_reduce(t, "x", start_level=lvl), d["ada"])
        cases[f"adasum_set0_l{lvl}"] = lambda lvl=lvl: _shard(
            lambda t: jax_adasum_reduce(t, "x", axis_index_groups=groups(0),
                                        start_level=lvl), d["ada"])
    return cases


JAX_CASES = sorted(_jax_cases())


@pytest.mark.parametrize("key", JAX_CASES)
def test_even_collectives_match_jax_traced(gang, key):
    results, _ = gang
    want = _jax_cases()[key]()
    k = 0 if key.startswith(("set0", "adasum_set0")) else 1
    ranks = _members(k) if key.startswith(("set", "adasum_set")) \
        else range(N)
    for r in ranks:
        got = G.decode(results[r][key])
        got = got if isinstance(got, list) else [got]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w[r].reshape(g.shape), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{key} rank {r}")


NUMPY_CASES = ["allgather_ragged", "allgather_int", "allgather_bf16",
               "alltoall_splits", "alltoall_recv_splits",
               "grouped_reducescatter", "allreduce_bf16", "set1_broadcast",
               "adasum_allreduce", "adasum_grouped", "async_allreduce",
               "async_grouped", "async_allgather", "async_broadcast",
               "async_alltoall", "timeout", "sparse_avg1", "sparse_avg0",
               "set0_predivide"]


@pytest.mark.parametrize("key", NUMPY_CASES)
def test_engine_semantics_match_numpy(gang, key):
    results, _ = gang
    assert not G.mismatches(results, N, LOCAL, [key])


def test_dtypes_and_grouped_allgather(gang):
    results, _ = gang
    want = G.expected(N, LOCAL)
    for res in results:
        assert res["allgather_int"]["dtype"] == "torch.int32"
        assert res["allgather_bf16"]["dtype"] == "torch.bfloat16"
        # the integer mean is float, as the JAX package's pmean gives
        assert res["grouped_allreduce"][2]["dtype"] == "torch.float32"
        assert res["poll_types"] == ["bool"]
        assert all(res[k + "_again"] for k in want if k.startswith("async"))
        got = G.decode(res["grouped_allgather"])
        np.testing.assert_array_equal(got[0], want["allgather"][0])
        np.testing.assert_array_equal(got[1], want["allgather_ragged"][0])


def test_process_sets_and_non_members(gang):
    results, _ = gang
    for r, res in enumerate(results):
        assert res["topology"] == [r % LOCAL, LOCAL, r // LOCAL, N // LOCAL]
        assert res["set_ids"] == [1, 2] and res["set_again"] == 1
        assert res["set_ranks"] == G.sets(N)
        assert res["included"] == [r in s for s in G.sets(N)]
        for k, s in enumerate(G.sets(N)):
            assert res.get(f"set{k}_nonmember") == (
                None if r in s else "ValueError")
        assert res["broadcast_root_not_member"] == "ValueError"
        assert res["reducescatter_bad"] == "ValueError"
        assert res.get("adasum_not_pow2") == (
            "ValueError" if r in G.sets(N)[1] else None)
        assert res.get("set0_optimizer_nonmember") == (
            None if r < 2 else "ValueError")


def test_objects_and_parameters_across_ranks(gang):
    results, _ = gang
    for r, res in enumerate(results):
        assert res["allgather_object"] == [{"rank": i, "pad": "x" * i}
                                           for i in range(N)]
        assert res["broadcast_object"] == {"root": 1, "arr": [1, 2, 1]}
        assert res["broadcast_object_fn"] == f"from {N - 1}"
    torch.manual_seed(0)
    root = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    want = [p.detach().numpy() for _, p in sorted(root.state_dict().items())]
    for key in ("broadcast_parameters", "broadcast_named"):
        first = G.decode(results[0][key])
        for res in results:
            got = G.decode(res[key])
            for g, f in zip(got, first):
                np.testing.assert_array_equal(g, f)
    for g, w in zip(G.decode(results[0]["broadcast_parameters"]), want):
        np.testing.assert_array_equal(g, w)
    states = [res["broadcast_optimizer_state"] for res in results]
    assert all(s["lr"] == 0.01 for s in states)        # rank 0's lr
    assert all(s["state"] == states[0]["state"] for s in states)


def test_adasum_optimizer_coefficients_are_per_tensor(gang):
    results, _ = gang
    want = G.expected(N, LOCAL)["adasum_grouped"][0]
    whole = G.adasum_np([np.concatenate([a.ravel(), b]) for a, b in zip(
        G.inputs(N)["ada"], G.inputs(N)["ada2"])])
    assert not np.allclose(whole[:20].reshape(5, 4), want[0], rtol=1e-3)
    for res in results:
        for g, w in zip(G.decode(res["adasum_optimizer"]), want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_partial_optimizer_keeps_local_layers_local(gang):
    _, out = gang
    states = [torch.load(f"{out}.partial.{r}.pt") for r in range(N)]
    local = [n for n in states[0] if ".attn.q" in n]
    assert local == [f"blocks.{i}.attn.q" for i in range(2)]
    for name in states[0]:
        same = all(torch.equal(s[name], states[0][name]) for s in states)
        assert same == (name not in local), name


def test_accumulation_dp_step_equals_full_batch_step(gang):
    """Two passes of one row per rank and update, averaged over passes and
    ranks, make the same AdamW updates as one process on the whole batch
    (tolerances of test_torch_port_train.py)."""
    results, out = gang
    hvt.init(device="cpu")
    try:
        one = train(GPTConfig(**G.ENTRY, dtype=torch.float32),
                    G.ACC_UPDATES, N * G.ACC_ROWS, G.ACC_SEQ, device="cpu",
                    lr=1e-3)
    finally:
        hvt.shutdown()
    losses = np.mean([r["acc_losses"] for r in results], axis=(0, 2))
    np.testing.assert_allclose(losses, one["loss"], rtol=1e-4, atol=1e-5)
    acc_state = torch.load(out + ".acc.pt")
    for name, want in one["model"].state_dict().items():
        np.testing.assert_allclose(acc_state[name].numpy(), want.numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", ["random", "a_zero", "both_zero", "bf16"])
def test_pairwise_adasum_matches_jax(case):
    """The pairwise combine with its zero-norm guards; fp32 rtol 1e-5,
    bf16 at one bf16 ulp (both round the fp32 result to bf16)."""
    from horovod_tpu.ops.adasum import pairwise_adasum as jax_pairwise

    rs = np.random.RandomState(2)
    a, b = rs.normal(size=(2, 6, 5)).astype(np.float32)
    if case in ("a_zero", "both_zero"):
        a[:] = 0
    if case == "both_zero":
        b[:] = 0
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
                else (jnp.float32, torch.float32))
    want = np.asarray(jax_pairwise(jnp.asarray(a, jdt), jnp.asarray(b, jdt)),
                      np.float32)
    got = hvt.pairwise_adasum(torch.from_numpy(a).to(tdt),
                              torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    tol = 2 ** -8 if case == "bf16" else RTOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_adasum_start_level_env(monkeypatch):
    from horovod_tpu_torch.ops.adasum import start_level_from_env

    hvt.init(device="cpu")
    try:
        for raw, want in ((None, 1), ("3", 3), ("local", hvt.local_size())):
            if raw is None:
                monkeypatch.delenv("HVT_ADASUM_START_LEVEL", raising=False)
            else:
                monkeypatch.setenv("HVT_ADASUM_START_LEVEL", raw)
            assert start_level_from_env() == want
        monkeypatch.setenv("HVT_ADASUM_START_LEVEL", "host")
        with pytest.raises(ValueError, match="HVT_ADASUM_START_LEVEL"):
            start_level_from_env()
    finally:
        hvt.shutdown()


def test_init_registers_process_sets():
    hvt.init(device="cpu", process_sets=[[0], hvt.ProcessSet([0])])
    try:
        assert hvt.global_process_set.process_set_id == 0
        assert hvt.process_set_included_ranks(0) == [0]
        assert hvt.process_set_included_ranks(1) == [0]
        with pytest.raises(KeyError):
            hvt.process_set_included_ranks(2)   # the duplicate was merged
        with pytest.raises(ValueError, match="distinct"):
            hvt.add_process_set([0, 0])
        hvt.remove_process_set(hvt.global_process_set)
        assert hvt.global_process_set.process_set_id == 0
    finally:
        hvt.shutdown()
    assert hvt.global_process_set.process_set_id is None
