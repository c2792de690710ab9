"""horovod_tpu_torch's multi-process entry point on a 4-process gloo gang,
held against the JAX package on 4 CPU devices with the same numpy inputs:
meshes, the differentiable collectives, ring and Ulysses attention, tensor
parallelism, and the sharded GPT step of ``dryrun_multichip``.

One gang (tests/torch_port_parallel_gang.py, no JAX) runs every case once
and writes each rank's results; it starts before the JAX side computes its
references and is collected by the first test that needs it.

Tolerances are the JAX tests' own: ring and Ulysses outputs rtol 1e-5 /
atol 1e-5 (einsum) and 2e-5 (flash; on the CPU the port's flash route runs
the kernels' plain versions through the same autograd Function), their
gradients against the dense computation rtol 1e-4 / atol 1e-5
(tests/test_sequence_parallel.py:259-282); the sharded step against the
replicated one loss rtol 1e-4 / atol 1e-5 and parameters rtol 1e-3 / atol
1e-4 (__graft_entry__.py:219-229). The collectives move fp32 values or sum
them in another order: rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__
import horovod_tpu as jhvt
import torch_port_parallel_gang as G
from horovod_tpu.models import GPT as JaxGPT
from horovod_tpu.models import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import \
    param_partition_spec as jax_param_partition_spec
from horovod_tpu.parallel.mesh import make_parallel_mesh as jax_mesh
from horovod_tpu.parallel.sequence import (ring_attention as jax_ring,
                                           ulysses_attention as jax_ulysses)
from horovod_tpu_torch.models import GPT
from horovod_tpu_torch.models.convert import (flax_path,
                                              gather_state_dict,
                                              params_from_flax,
                                              shard_state_dict)
from horovod_tpu_torch.models.transformer import param_partition_spec
from horovod_tpu_torch.parallel.mesh import mesh_factors, mesh_layout
from horovod_tpu_torch.train import gpt_config, make_train_step

N = G.N
ENTRY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4, d_ff=512,
             max_seq_len=128)
STEP_BATCH = (4, 32)        # the dryrun's batch at dp 1 and dp 2
RTOL, ATOL = 1e-5, 1e-6


def _jax_start():
    """The entry GPT's initial fp32 params (numpy tree) and its model."""
    model = JaxGPT(JaxGPTConfig(**ENTRY, dtype=jnp.float32))
    tokens = np.random.RandomState(0).randint(0, 512, STEP_BATCH)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    _, start = _jax_start()
    g = G.Gang("parallel", str(tmp_path_factory.mktemp("par") / "res"),
               inputs={"gpt": params_from_flax(start)})
    yield g
    g.kill()


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axes", G.MESHES, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_mesh_layout_matches_jax(gang, axes):
    jmesh = jax_mesh(devices=jax.devices()[:N], **axes)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    got = gang.results()[0]["meshes"][G.MESHES.index(axes)]
    assert got["axis_names"] == list(jmesh.axis_names)
    assert got["devices"] == ids.tolist()
    for r in range(N):
        mine = gang.results()[r]["meshes"][G.MESHES.index(axes)]
        where = [int(i) for i in np.argwhere(ids == r)[0]]
        assert list(mine["coords"].values()) == where
        for dim, axis in enumerate(jmesh.axis_names):
            line = ids[tuple(slice(None) if d == dim else where[d]
                             for d in range(ids.ndim))]
            assert mine["sets"][axis] == sorted(line.tolist()), axis


def test_global_and_hierarchical_meshes(gang):
    """The GLOBAL mesh is every rank on hvt_world; the hierarchical one is
    (hosts, ranks per host) from the launcher's cross/local ranks, here two
    fake hosts of two ranks, host-major as the JAX function's rows of
    each process's chips."""
    for r, res in enumerate(gang.results()):
        assert res["global_mesh"] == {"devices": list(range(N)),
                                      "axis_names": ["hvt_world"],
                                      "sets": {"hvt_world": list(range(N))}}
        host, local = divmod(r, G.LOCAL)
        assert res["hierarchical_mesh"] == {
            "devices": [[0, 1], [2, 3]],
            "axis_names": ["hvt_cross", "hvt_local"],
            "sets": {"hvt_cross": [local, local + G.LOCAL],
                     "hvt_local": [host * G.LOCAL, host * G.LOCAL + 1]}}


@pytest.mark.parametrize("axes", [dict(dp=-1, tp=-1), dict(dp=3, tp=-1),
                                  dict(dp=2, tp=4)],
                         ids=["two-minus-one", "indivisible", "too-many"])
def test_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as want:
        jax_mesh(devices=jax.devices()[:N], **axes)
    with pytest.raises(ValueError) as got:
        mesh_layout(N, axes)
    assert str(got.value) == str(want.value)


def test_mesh_factors_match_graft_entry():
    for n in range(1, 17):
        assert mesh_factors(n) == __graft_entry__._mesh_factors(n)


# --------------------------------------------------------------------------
# differentiable collectives, against the same computation in one process
# --------------------------------------------------------------------------

def _prims():
    return {k: torch.from_numpy(v) for k, v in G.prim_inputs(N).items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_ring_shift_and_its_gradient(gang):
    p = _prims()
    x, y = (p[k].clone().requires_grad_() for k in ("x", "y"))
    prev = [(r - 1) % N for r in range(N)]
    loss = sum((x[prev[r]] * p["wx"][r]).sum() + (y[prev[r]] * p["wy"][r])
               .sum() for r in range(N))
    loss.backward()
    for r, res in enumerate(gang.results()):
        sx, sy, gx, gy = res["ring_shift"]
        # two same-shaped tensors, each arrives as itself
        _close(sx, p["x"][prev[r]])
        _close(sy, p["y"][prev[r]])
        _close(gx, x.grad[r])
        _close(gy, y.grad[r])
        _close(res["ring_shift_back"], p["x"][(r + 1) % N])


def test_ring_pass_runs_every_reverse_shift(gang):
    """Rank r uses steps 0..r only, as a causal ring uses its blocks; the
    gradient still reaches every rank's input."""
    p = _prims()
    x = p["x"].clone().requires_grad_()
    loss = sum((x[(r - t) % N] * p["wx"][r] * (t + 1)).sum()
               for r in range(N) for t in range(r + 1))
    loss.backward()
    for r, res in enumerate(gang.results()):
        steps, grad = res["ring_pass"]
        _close(steps, torch.stack([p["x"][(r - t) % N] for t in range(N)]))
        _close(grad, x.grad[r])


def test_all_to_all_and_its_gradient(gang):
    p = _prims()
    a = p["a2a"].clone().requires_grad_()            # [rank, B, S/n, H, D]
    whole = torch.cat(list(a), dim=1)                # [B, S, H, D]
    h = whole.shape[2] // N
    outs = [whole[:, :, r * h:(r + 1) * h] for r in range(N)]
    sum((o * p["a2a_w"][r]).sum() for r, o in enumerate(outs)).backward()
    for r, res in enumerate(gang.results()):
        got, grad = res["all_to_all"]
        _close(got, outs[r])
        _close(grad, a.grad[r])


def test_copy_to_and_reduce_from(gang):
    p = _prims()
    for r, res in enumerate(gang.results()):
        line = res["tp_members"]
        assert r in line and len(line) == 2
        summed, grad = res["reduce_from"]
        _close(summed, p["red"][line].sum(0))
        _close(grad, p["red_w"][r])                  # identity backward
        _close(res["copy_to"], p["red_w"][line].sum(0))


# --------------------------------------------------------------------------
# ring and Ulysses attention
# --------------------------------------------------------------------------

def _jax_dense(q, k, v, causal):
    """tests/test_sequence_parallel.py's dense reference (K/V repeated)."""
    group = q.shape[2] // k.shape[2]
    k, v = (jnp.repeat(t, group, axis=2) for t in (k, v))
    s, d = q.shape[1], q.shape[3]
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * d ** -0.5
    if causal:
        pos = jnp.arange(s)
        scores = jnp.where((pos[None, :] <= pos[:, None])[None, None],
                           scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", probs.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _gathered(results, key):
    """Each output of ``key``, concatenated over the ranks' sequence
    shards."""
    return [np.concatenate([_np(res[key][i]) for res in results], axis=1)
            for i in range(4)]


def _sharded(mesh, *arrays):
    spec = NamedSharding(mesh, P(None, "sp", None, None))
    return [jax.device_put(jnp.asarray(a), spec) for a in arrays]


def _dense_grads(arrays, causal):
    def loss(q, k, v):
        return (_jax_dense(q, k, v, causal).astype(jnp.float32) ** 2).mean()

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))


RING_CASES = [(shape, flash, causal) for shape in (G.RING, G.RING_GQA)
              for flash in (False, True) for causal in (True, False)] + [
    (G.RING_WIDE, True, causal) for causal in (True, False)]


@pytest.mark.parametrize("shape,flash,causal", RING_CASES, ids=[
    f"{'wide-' if s[4] > 128 else ''}{'gqa' if s[2] != s[3] else 'mha'}-"
    f"{'flash' if f else 'einsum'}-{'causal' if c else 'full'}"
    for s, f, c in RING_CASES])
def test_ring_attention_matches_jax(gang, shape, flash, causal):
    arrays = G.qkv(shape)
    mesh = jax_mesh(devices=jax.devices()[:N], sp=N)
    want = jax_ring(*_sharded(mesh, *arrays), mesh=mesh, causal=causal,
                    use_flash=flash)
    o, *grads = _gathered(gang.results(), ("ring", shape, flash, causal))
    tol = 2e-5 if flash else 1e-5
    np.testing.assert_allclose(o, np.asarray(want), rtol=tol, atol=tol)
    for got, ref in zip(grads, _dense_grads(arrays, causal)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("shape,flash", [
    (s, f) for s in (G.ULYSSES, G.ULYSSES_GQA) for f in (False, True)],
    ids=["mha-einsum", "mha-flash", "gqa-einsum", "gqa-flash"])
def test_ulysses_attention_matches_jax(gang, shape, flash):
    arrays = G.qkv(shape)
    mesh = jax_mesh(devices=jax.devices()[:N], sp=N)
    want = jax_ulysses(*_sharded(mesh, *arrays), mesh=mesh, causal=True,
                       use_flash=flash)
    o, *grads = _gathered(gang.results(), ("ulysses", shape, flash))
    np.testing.assert_allclose(o, np.asarray(want), rtol=2e-5, atol=2e-5)
    # the port's gradients are of the sum of o**2: scale the mean's
    scale = o.size
    for got, ref in zip(grads, _dense_grads(arrays, True)):
        np.testing.assert_allclose(got / scale, np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


def test_ulysses_errors_match_jax(gang):
    mesh = jax_mesh(devices=jax.devices()[:N], sp=N)
    b, s, h, _, d = G.ULYSSES
    want = []
    for heads, kv_heads in ((6, 6), (h, 2)):
        q = jnp.zeros((b, s, heads, d))
        k = jnp.zeros((b, s, kv_heads, d))
        with pytest.raises(ValueError) as e:
            jax_ulysses(q, k, k, mesh=mesh)
        want.append(f"ValueError: {e.value}")
    for res in gang.results():
        assert res["ulysses_errors"] == want


# --------------------------------------------------------------------------
# tensor parallelism and the sharded step
# --------------------------------------------------------------------------

def test_param_partition_spec_matches_jax():
    for n_kv, tp in ((None, 2), (2, 2), (1, 2), (2, 4)):
        model = JaxGPT(JaxGPTConfig(**ENTRY, n_kv_heads=n_kv))
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
        want = {}

        def walk(tree, path):
            for key, value in tree.items():
                if isinstance(value, dict):
                    walk(value, path + (key,))
                else:
                    want[path + (key,)] = tuple(value)

        walk(jax_param_partition_spec(params, tp_size=tp), ())
        state = params_from_flax(jax.tree.map(np.asarray, params))
        got = param_partition_spec(state, tp_size=tp)
        assert {tuple(flax_path(k)): v for k, v in got.items()} == want


def test_shard_and_gather_state_dict_round_trip():
    _, start = _jax_start()
    full = params_from_flax(start)
    specs = param_partition_spec(full, tp_size=2)
    shards = [shard_state_dict(full, specs, {"tp": 2}, {"tp": i})
              for i in range(2)]
    assert shards[0]["embedding"].shape == (256, 128)
    assert shards[1]["blocks.0.attn.q"].shape == (128, 2, 32)
    assert shards[1]["blocks.0.attn.o"].shape == (2, 32, 128)
    assert shards[0]["blocks.0.mlp.down"].shape == (256, 128)
    back = gather_state_dict(shards, specs, "tp")
    assert back.keys() == full.keys()
    for name in full:
        assert torch.equal(back[name], full[name]), name


@pytest.fixture(scope="module")
def jax_trajectory():
    """Two steps of the JAX package's replicated train_step (the dryrun's
    own) from the gang's weights: (losses, final params)."""
    model, start = _jax_start()
    tokens = jnp.asarray(np.random.RandomState(0).randint(0, 512,
                                                          STEP_BATCH))
    tx = jhvt.DistributedOptimizer(optax.adamw(1e-3), axis_name=None)

    def loss_fn(params):
        logits = model.apply({"params": params}, tokens)
        targets = jnp.roll(tokens, -1, axis=-1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], targets[:, :-1]).mean()

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    params = jax.tree.map(jnp.asarray, start)
    state, losses = tx.init(params), []
    for _ in range(2):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses, params_from_flax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("axes", G.STEP_AXES,
                         ids=lambda a: "dp{}-sp{}-tp{}".format(*a))
def test_sharded_step_matches_jax_replicated_step(gang, jax_trajectory,
                                                  axes):
    want_losses, want_params = jax_trajectory
    dp, sp, tp = axes
    runs = [res[("dryrun", axes)] for res in gang.results()]
    for run in runs:
        assert run["mesh"] == {"dp": dp, "sp": sp, "tp": tp}
        np.testing.assert_allclose(run["losses"], want_losses, rtol=1e-4,
                                   atol=1e-5)
    specs = param_partition_spec(want_params, tp_size=tp)
    for d in range(dp):
        for s in range(sp):
            line = sorted((r["coords"]["tp"], r["params"]) for r in runs
                          if r["coords"]["dp"] == d
                          and r["coords"]["sp"] == s)
            got = gather_state_dict([p for _, p in line], specs, "tp")
            assert got.keys() == want_params.keys()
            for name, want in want_params.items():
                np.testing.assert_allclose(_np(got[name]), _np(want),
                                           rtol=1e-3, atol=1e-4,
                                           err_msg=name)


@pytest.mark.parametrize("name", list(G.STEPS))
def test_sharded_step_matches_one_process(gang, name):
    """Two steps on a mesh against two steps of one process of the port:
    MQA over tp 2 (K/V stay whole on both tp ranks and their partial
    gradients are summed over tp), the flash route in every ring block,
    GQA with flash over a ring of four, and SGD at dp 2 × sp 2, whose
    update shows a gradient summed over the wrong ranks or scaled
    wrongly, which AdamW's normalisation would hide."""
    overrides, axes = G.STEPS[name]
    model = GPT(gpt_config("entry", dtype=torch.float32, **overrides),
                device="cpu")
    step = make_train_step(model, G.step_optimizer(name,
                                                   model.parameters()))
    tokens = torch.from_numpy(G.step_tokens())
    losses = [float(step(tokens)) for _ in range(2)]
    want = model.state_dict()
    tp = axes.get("tp", 1)
    specs = param_partition_spec(want, tp_size=tp)
    if name == "mqa":
        assert specs["blocks.0.attn.k"] == ()
    for res in gang.results():
        run = res[("step", name)]
        np.testing.assert_allclose(run["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        mine = shard_state_dict(want, specs, {"tp": tp}, run["coords"])
        for key, w in mine.items():
            np.testing.assert_allclose(_np(run["params"][key]), _np(w),
                                       rtol=1e-3, atol=1e-4, err_msg=key)


def test_dryrun_subpaths_hold_on_every_rank(gang):
    """The dryrun's own checks passed on every rank (they raise
    otherwise); the values they checked agree across ranks, and the ring's
    matches the JAX package's ring attention with the flash kernels."""
    runs = [res[("dryrun", G.STEP_AXES[0])] for res in gang.results()]
    for key in ("ep", "pp", "sp_ring"):
        values = [run[key]["value"] for run in runs]
        np.testing.assert_allclose(values, values[0], rtol=1e-6)
    assert runs[0]["ep"]["mesh"] == {"dp": 2, "ep": 2}
    assert runs[0]["hier"]["local_size"] == 2
    b, s, h, h_kv, d = runs[0]["sp_ring"]["shape"]
    rng = np.random.RandomState(2)
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32)
               for n in (h, h_kv, h_kv))
    mesh = jax_mesh(devices=jax.devices()[:N], sp=N)
    o = jax_ring(*_sharded(mesh, q, k, v), mesh=mesh, causal=True,
                 use_flash=True)
    want = float((np.asarray(o, np.float32) ** 2).mean())
    np.testing.assert_allclose(runs[0]["sp_ring"]["value"], want, rtol=1e-5)
