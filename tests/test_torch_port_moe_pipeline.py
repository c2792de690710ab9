"""horovod_tpu_torch's MoE expert parallelism and GPipe pipeline on a
4-process gloo gang, held against the JAX package on CPU devices with the
same numpy inputs and weights, plus the format helpers that carry their
parameters (models/convert.py).

One gang (tests/torch_port_parallel_gang.py, no JAX) runs ``MoEMlp`` on a
dp 2 × ep 2 mesh from the JAX layer's weights, and the pipeline at
(n_stages, n_micro) = (4, 4) and (2, 6): the second as two pipelines of a
dp 2 × pp 2 mesh, six same-shaped microbatches with different values, so a
stage that paired its sends and receives in another order would pass one
microbatch's activation or gradient as another's.

Tolerances: MoE outputs atol 1e-4 (tests/test_moe.py:68), its gradients
rtol 1e-4 / atol 1e-4 (fp32 sums of up to 8 tokens in another order);
pipeline outputs rtol 1e-5 / atol 1e-5 and gradients rtol 1e-4 / atol
1e-5 (tests/test_pipeline.py:54-76).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parallel_gang as G
from horovod_tpu.models.moe import MoEMlp as JaxMoEMlp
from horovod_tpu.models.moe import \
    moe_param_partition_spec as jax_moe_param_partition_spec
from horovod_tpu.parallel.mesh import make_parallel_mesh as jax_mesh
from horovod_tpu.parallel.pipeline import pipeline as jax_pipeline
from horovod_tpu.parallel.pipeline import \
    split_microbatches as jax_split_microbatches
from horovod_tpu.parallel.pipeline import \
    stage_partition_spec as jax_stage_partition_spec
from horovod_tpu_torch.models.convert import (flax_path, gather_state_dict,
                                              params_from_flax,
                                              params_to_flax,
                                              shard_state_dict)
from horovod_tpu_torch.models.moe import moe_param_partition_spec
from horovod_tpu_torch.parallel.pipeline import (merge_microbatches,
                                                 split_microbatches,
                                                 stage_partition_spec)

N = G.N


def _jax_moe():
    moe = JaxMoEMlp(n_experts=G.MOE["n_experts"], d_ff=G.MOE["d_ff"],
                    capacity_factor=G.MOE["capacity_factor"],
                    dtype=jnp.float32)
    x = jnp.asarray(G.moe_x())
    params = moe.init(jax.random.PRNGKey(5), x)["params"]
    return moe, x, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    _, _, params = _jax_moe()
    g = G.Gang("moe_pipeline", str(tmp_path_factory.mktemp("moepp") / "res"),
               inputs={"moe": params_from_flax(params)})
    yield g
    g.kill()


def _np(t):
    return t.detach().cpu().numpy()


def test_moe_on_dp_ep_matches_jax(gang):
    moe, x, params = _jax_moe()

    def loss(p):
        out, aux = moe.apply({"params": p}, x)
        return out.sum() + 0.01 * aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    want_grads = params_from_flax(jax.tree.map(np.asarray, grads))
    runs = [res["moe"] for res in gang.results()]
    rows = G.MOE_X[0] // 2
    for run in runs:
        i = run["coords"]["dp"] * rows
        np.testing.assert_allclose(_np(run["out"]),
                                   np.asarray(out)[i:i + rows], atol=1e-4)
    # the batch's aux loss is the mean of the dp shards'
    np.testing.assert_allclose(
        np.mean([_np(r["aux"]) for r in runs if r["coords"]["ep"] == 0]),
        float(aux), rtol=1e-5)
    specs = {"wi": ("ep",), "wo": ("ep",)}
    line = sorted((r["coords"]["ep"], r["grads"]) for r in runs
                  if r["coords"]["dp"] == 0)
    got = gather_state_dict([g for _, g in line], specs, "ep")
    assert got.keys() == want_grads.keys()
    for name, want in want_grads.items():
        np.testing.assert_allclose(_np(got[name]), _np(want), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # both dp replicas of each expert shard hold the same summed gradient
    for r in runs:
        twin = next(o for o in runs if o["coords"]["ep"] == r["coords"]["ep"]
                    and o["coords"]["dp"] != r["coords"]["dp"])
        for name in r["grads"]:
            assert torch.equal(r["grads"][name], twin["grads"][name])


def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


@pytest.mark.parametrize("n_stages,n_micro", G.PIPELINES,
                         ids=lambda v: str(v))
def test_pipeline_matches_jax(gang, n_stages, n_micro):
    params, x = G.pipe_inputs(n_stages, n_micro)
    mesh = jax_mesh(devices=jax.devices()[:n_stages], pp=n_stages)

    def loss(p, xs):
        out = jax_pipeline(_jax_stage, p, xs, n_micro, mesh)
        return (out ** 2).mean(), out

    (_, out), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    runs = [res[("pipeline", n_stages, n_micro)] for res in gang.results()]
    for run in runs:
        s = run["coords"]["pp"]
        np.testing.assert_allclose(_np(run["out"]), np.asarray(out),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(run["x_grad"]), np.asarray(g_x),
                                   rtol=1e-4, atol=1e-5)
        for name, g in run["grads"].items():
            np.testing.assert_allclose(_np(g)[0],
                                       np.asarray(g_params[name])[s],
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_microbatches_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    mb = split_microbatches(torch.from_numpy(x), 4)
    assert mb.shape == (4, 3, 2)
    np.testing.assert_array_equal(_np(mb), np.asarray(
        jax_split_microbatches(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(_np(merge_microbatches(mb)), x)
    with pytest.raises(ValueError) as want:
        jax_split_microbatches(jnp.asarray(x), 5)
    with pytest.raises(ValueError) as got:
        split_microbatches(torch.from_numpy(x), 5)
    assert str(got.value) == str(want.value)


def _at(tree, name):
    """The leaf of a flax tree at a state_dict name's path."""
    for key in flax_path(name):
        tree = tree[key]
    return tree


def test_moe_params_convert_and_shard_round_trip():
    _, _, params = _jax_moe()
    state = params_from_flax(params)
    assert sorted(state) == ["router_block.router", "wi", "wo"]
    back = params_to_flax(state)
    for name, t in state.items():
        np.testing.assert_array_equal(_at(back, name), _np(t))
        np.testing.assert_array_equal(_at(params, name), _np(t))
    specs = moe_param_partition_spec(state)
    want = jax_moe_param_partition_spec(params)
    assert specs == {name: tuple(_at(want, name)) for name in state}
    shards = [shard_state_dict(state, specs, {"ep": 2}, {"ep": i})
              for i in range(2)]
    assert shards[1]["wi"].shape == (2, 16, 32)
    assert shards[1]["router_block.router"].shape == (16, 4)
    for name, t in gather_state_dict(shards, specs, "ep").items():
        assert torch.equal(t, state[name]), name


def test_stacked_stage_params_convert_and_shard_round_trip():
    params, _ = G.pipe_inputs(4, 4)
    state = params_from_flax(params)
    assert sorted(state) == ["b", "w"]
    for name, t in params_to_flax(state).items():
        np.testing.assert_array_equal(t, params[name])
    specs = stage_partition_spec(state)
    want = jax_stage_partition_spec(params)
    assert specs == {name: tuple(_at(want, name)) for name in state}
    shards = [shard_state_dict(state, specs, {"pp": 4}, {"pp": i})
              for i in range(4)]
    assert shards[3]["w"].shape == (1, G.PIPE_D, G.PIPE_D)
    for name, t in gather_state_dict(shards, specs, "pp").items():
        assert torch.equal(t, state[name]), name
