"""horovod_tpu_torch's FSDP (parallel/fsdp.py) held against the JAX
package's ``parallel/fsdp.py`` with the same numpy inputs.

- The spec map against ``fsdp_partition_spec``'s ``PartitionSpec`` s, leaf
  by leaf: tests/test_fsdp.py's cases, more shapes, and the GPT's
  parameters (the port's rule on the axis's size, ``_spec_map``).
- A 4-process gloo job started by the port's launcher
  (tests/torch_port_launch_worker.py, no JAX) trains the MLP of
  tests/test_fsdp.py for 5 AdamW steps under ``shard_module`` at fsdp 4
  and at dp 2 × fsdp 2, each rank on its own rows of the batch, against
  the JAX run on the same layout (``make_parallel_mesh(devices=...)``,
  sharded by ``shard_pytree``, moments by ``init_sharded_state``), whose
  loss is over the whole batch. Both are the replicated step's arithmetic
  summed in another order: losses and parameters within rtol 1e-5
  (atol 1e-6 for the parameters). A second reduction of the gradients
  would show as a drift here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_launch_worker as W
from horovod_tpu.models import GPT as JaxGPT
from horovod_tpu.models import GPTConfig as JaxGPTConfig
from horovod_tpu.parallel.fsdp import fsdp_partition_spec as jax_spec
from horovod_tpu.parallel.fsdp import init_sharded_state, shard_pytree
from horovod_tpu.parallel.mesh import make_parallel_mesh as jax_mesh
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.models.convert import flax_path
from horovod_tpu_torch.parallel.fsdp import _spec_map, placement_dim
from horovod_tpu_torch.parallel.fsdp import \
    init_sharded_state as torch_init_state

RTOL, ATOL = 1e-5, 1e-6
LAYOUT_IDS = ["-".join(f"{k}{v}" for k, v in layout.items())
              for layout in W.FSDP_LAYOUTS]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = W.Launch(4, "fsdp_mlp", str(tmp_path_factory.mktemp("fsdp") / "res"))
    yield g
    g.kill()


def _dim(spec):
    """The sharded dim of a JAX ``PartitionSpec``, or None."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    return dims[0] if dims else None


def _jax_map(shapes, n, min_shard):
    mesh = jax_mesh(devices=jax.devices()[:n], fsdp=n)
    tree = {name: jnp.zeros(shape, jnp.float32)
            for name, shape in shapes.items()}
    return {name: _dim(s) for name, s in
            jax_spec(tree, mesh, min_shard_elements=min_shard).items()}


SHAPES = {"dense.kernel": (32, 128), "dense.bias": (128,),
          "head.kernel": (128, 32), "head.scale": (), "odd": (7, 9000),
          "never": (7, 9001), "q": (768, 12, 64), "o": (12, 64, 768),
          "down": (3072, 768), "scale": (768,), "embedding": (32768, 768),
          "tie": (64, 64)}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("min_shard", [256, 1024])
def test_spec_map_equals_jax_partition_specs(n, min_shard):
    tensors = {k: torch.zeros(s) for k, s in SHAPES.items()}
    got = _spec_map(tensors, n, min_shard)
    assert got == _jax_map(SHAPES, n, min_shard)


def test_spec_cases_of_the_jax_tests():
    """tests/test_fsdp.py's expectations, at fsdp 8."""
    got = _spec_map({k: torch.zeros(s) for k, s in SHAPES.items()}, 8, 256)
    assert (got["dense.kernel"], got["head.kernel"]) == (1, 0)
    assert got["head.scale"] is None and got["dense.bias"] is None
    got = _spec_map({k: torch.zeros(s) for k, s in SHAPES.items()}, 8, 1024)
    assert got["odd"] == 1 and got["never"] is None


def test_gpt_spec_map_equals_jax_on_flax_params():
    """The port's GPT parameters against the JAX GPT's flax parameters,
    matched by name (models/convert.py's flax_path)."""
    kw = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=256,
              max_seq_len=16)
    model = GPT(GPTConfig(**kw), device="cpu")
    params = JaxGPT(JaxGPTConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"]
    mesh = jax_mesh(devices=jax.devices()[:4], fsdp=4)
    specs = jax_spec(params, mesh)
    for name, dim in _spec_map(model, 4, 1024).items():
        leaf = specs
        for key in flax_path(name):
            leaf = leaf[key]
        assert dim == _dim(leaf), name


def _jax_run(layout):
    """5 adamw steps of tests/test_fsdp.py's MLP on the layout: the losses
    and the final parameters in the port's names."""
    mesh = jax_mesh(devices=jax.devices()[:4], **layout)
    p = W.mlp_params()
    params = {"dense": {"kernel": jnp.asarray(p["dense.kernel"]),
                        "bias": jnp.asarray(p["dense.bias"])},
              "head": {"kernel": jnp.asarray(p["head.kernel"]),
                       "scale": jnp.asarray(p["head.scale"])}}
    x, y = (jnp.asarray(a) for a in W.mlp_data())
    tx = optax.adamw(W.MLP_LR, weight_decay=W.MLP_WD)

    def loss_fn(q):
        h = jnp.tanh(x @ q["dense"]["kernel"] + q["dense"]["bias"])
        return ((h @ q["head"]["kernel"] * q["head"]["scale"] - y) ** 2
                ).mean()

    @jax.jit
    def step(q, s):
        loss, g = jax.value_and_grad(loss_fn)(q)
        updates, s = tx.update(g, s, q)
        return optax.apply_updates(q, updates), s, loss

    specs = jax_spec(params, mesh, min_shard_elements=W.MLP_MIN_SHARD)
    q = shard_pytree(params, specs, mesh)
    losses = []
    with jax.set_mesh(mesh):
        s = init_sharded_state(tx, q, mesh)
        for _ in range(W.MLP_STEPS):
            q, s, loss = step(q, s)
            losses.append(float(loss))
    final = {f"{a}.{b}": np.asarray(v) for a in q for b, v in q[a].items()}
    spec_map = {f"{a}.{b}": _dim(v) for a in specs
                for b, v in specs[a].items()}
    return losses, final, spec_map


@pytest.mark.parametrize("layout", W.FSDP_LAYOUTS, ids=LAYOUT_IDS)
def test_fsdp_training_matches_jax_on_the_layout(gang, layout):
    tag = LAYOUT_IDS[W.FSDP_LAYOUTS.index(layout)]
    losses, final, spec_map = _jax_run(layout)
    for r, res in enumerate(gang.results()):
        got = res[tag]
        assert got["spec"] == spec_map
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
        for name, want in final.items():
            np.testing.assert_allclose(got["params"][name].numpy(), want,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("layout", W.FSDP_LAYOUTS, ids=LAYOUT_IDS)
def test_moments_are_sharded_like_their_parameters(gang, layout):
    """init_sharded_state: each moment's local shape is its parameter's,
    1/fsdp of the dim placement_dim gives (the map's; dim 0 for a leaf it
    keeps replicated, which FSDP2 cannot hold whole), and a 0-d leaf
    whole."""
    tag = LAYOUT_IDS[W.FSDP_LAYOUTS.index(layout)]
    n = layout["fsdp"]
    for res in gang.results():
        got = res[tag]
        for name, (param, mu, nu, whole) in got["shapes"].items():
            assert param == mu == nu, name
            dim = placement_dim(got["spec"][name], whole)
            want = list(whole)
            if dim is not None:
                want[dim] //= n
            assert param == tuple(want), name


def test_ranks_sit_on_the_jax_mesh_positions(gang):
    """Rank r's mesh coordinates are device r's on the JAX mesh of the same
    layout, so shard i of a line lives on the same member."""
    for layout, tag in zip(W.FSDP_LAYOUTS, LAYOUT_IDS):
        mesh = jax_mesh(devices=jax.devices()[:4], **layout)
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        for r, res in enumerate(gang.results()):
            where = dict(zip(mesh.axis_names,
                             map(int, np.argwhere(ids == r)[0])))
            assert res[tag]["coords"] == where


def test_placement_dim():
    assert placement_dim(1, (4, 8)) == 1
    assert placement_dim(None, (768,)) == 0
    assert placement_dim(None, ()) is None


def test_distributed_optimizer_refuses_a_sharded_module(gang):
    for res in gang.results():
        assert res["double_reduction"].startswith("ValueError"), \
            res["double_reduction"]


def test_init_sharded_state_is_the_fresh_state():
    """On a module that is not sharded, the state equals a fresh AdamW's
    first step: the same parameters after one step from it."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 3, generator=gen)
    g = torch.randn(4, 3, generator=gen)
    outs = []
    for pre in (False, True):
        p = torch.nn.Parameter(w.clone())
        opt = torch.optim.AdamW([p], lr=0.1, weight_decay=0.1)
        if pre:
            state = torch_init_state(opt)
            assert float(state[p]["step"]) == 0
            assert not state[p]["exp_avg"].any()
            assert torch.equal(p.detach(), w)
        p.grad = g.clone()
        opt.step()
        outs.append(p.detach().clone())
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(TypeError):
        torch_init_state(torch.optim.SGD([torch.nn.Parameter(w)], lr=0.1))
