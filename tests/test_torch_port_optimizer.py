"""horovod_tpu_torch's DistributedOptimizer options held against the JAX
package's DistributedGradientTransformation, in a world of one process.

- Gradient accumulation: the same numpy gradients go through
  hvt.DistributedOptimizer(optax.adamw(1e-3), backward_passes_per_step=2,
  average_aggregated_gradients=...) (axis_name=None) and through the port's
  DistributedOptimizer(AdamW(1e-3, weight_decay=1e-4), ...) for four calls,
  with zero_grad(set_to_none=True) before each, as make_train_step calls
  it; and the same with SGD(0.1). The parameters must match after every
  call, at the tolerances of test_torch_port_train.py (rtol 1e-3, atol
  1e-4).
- PartialDistributedOptimizer: with prescale 2 and SGD(lr 1), a reduced
  leaf moves by -2·g and a local one by -g, in both packages; the same
  local_layers must select the same GPT tensors (names through
  models/convert.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvt
import horovod_tpu_torch as hvt
from horovod_tpu.jax import PartialDistributedGradientTransformation
from horovod_tpu.models import GPT as JaxGPT
from horovod_tpu.models import GPTConfig as JaxGPTConfig
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.models.convert import params_from_flax

CALLS = 4
TINY = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
            max_seq_len=16)


@pytest.fixture(scope="module")
def world():
    hvt.init(device="cpu")
    yield
    hvt.shutdown()


def _grads():
    rs = np.random.RandomState(5)
    return [{"a": rs.normal(size=(3, 4)).astype(np.float32),
             "b": rs.normal(size=(5,)).astype(np.float32)}
            for _ in range(CALLS)]


# AdamW as the main path runs it, and SGD, whose update shows the scale of
# the accumulated gradient (AdamW's hardly does)
OPTIMIZERS = {
    "adamw": (lambda: optax.adamw(1e-3),
              lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-4)),
    "sgd": (lambda: optax.sgd(0.1), lambda p: torch.optim.SGD(p, lr=0.1)),
}


@pytest.mark.parametrize("average", [True, False],
                         ids=["average", "sum"])
@pytest.mark.parametrize("inner", sorted(OPTIMIZERS))
def test_accumulation_matches_jax(world, inner, average):
    rs = np.random.RandomState(4)
    start = {"a": rs.normal(size=(3, 4)).astype(np.float32),
             "b": rs.normal(size=(5,)).astype(np.float32)}
    jax_inner, torch_inner = OPTIMIZERS[inner]
    tx = jhvt.DistributedOptimizer(
        jax_inner(), backward_passes_per_step=2,
        average_aggregated_gradients=average)
    params = jax.tree.map(jnp.asarray, start)
    state = tx.init(params)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in start.items()}
    opt = hvt.DistributedOptimizer(
        torch_inner(tparams.values()), backward_passes_per_step=2,
        average_aggregated_gradients=average)

    for i, g in enumerate(_grads()):
        before = {k: p.detach().clone() for k, p in tparams.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad(set_to_none=True)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-3,
                                       atol=1e-4, err_msg=f"{k} call {i}")
            if i % 2 == 0:     # a held pass leaves the parameter as it was
                assert torch.equal(p.detach(), before[k])


@pytest.mark.parametrize("average", [True, False],
                         ids=["average", "sum"])
def test_accumulation_counts_each_pass_once_without_zero_grad(world,
                                                               average):
    """PyTorch's usual accumulation pattern: backward after backward with
    no zero_grad in between, step() after each. The update must hold each
    pass once, and the caller's gradient tensors must stay as they were."""
    rs = np.random.RandomState(6)
    start, *xs = (rs.normal(size=(4,)).astype(np.float32) for _ in range(5))
    w = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = hvt.DistributedOptimizer(
        torch.optim.SGD([w], lr=1.0), backward_passes_per_step=2,
        average_aggregated_gradients=average)
    want = start.copy()
    for i in range(0, len(xs), 2):
        held = []
        for x in xs[i:i + 2]:
            (w * torch.from_numpy(x)).sum().backward()
            held.append((w.grad, w.grad.clone()))
            opt.step()
        total = xs[i] + xs[i + 1]
        want -= total / 2 if average else total
        np.testing.assert_allclose(w.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=f"update {i // 2}")
        assert torch.equal(*held[0])    # the accumulator copied pass 1
        opt.zero_grad(set_to_none=True)


@pytest.mark.parametrize("local_layers", [("attn/q",), ("block_1",),
                                          ("ln",), ("embedding", "mlp/up")],
                         ids=lambda v: "+".join(v))
def test_partial_optimizer_selects_the_same_tensors_as_jax(world,
                                                           local_layers):
    tokens = np.zeros((1, 8), np.int32)
    jmodel = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
    jparams = jmodel.init(jax.random.PRNGKey(0), tokens)["params"]
    ones = jax.tree.map(jnp.ones_like, jparams)
    tx = PartialDistributedGradientTransformation(
        optax.sgd(1.0), local_layers=local_layers, prescale_factor=2.0)
    updates, _ = tx.update(ones, tx.init(jparams), jparams)
    jax_local = {name for name, u in params_from_flax(
        jax.tree.map(np.asarray, updates)).items()
        if torch.all(u == -1.0)}

    model = GPT(GPTConfig(**TINY, dtype=torch.float32), device="cpu")
    opt = hvt.PartialDistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1.0),
        model.named_parameters(), local_layers=local_layers, op=hvt.Sum,
        prescale_factor=2.0)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.synchronize()
    port_local = {name for name, p in model.named_parameters()
                  if torch.all(p.grad == 1.0)}
    assert port_local == jax_local
    assert port_local and len(port_local) < len(list(model.parameters()))


def test_reduce_filter_needs_names(world):
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="named_parameters"):
        hvt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 reduce_filter=lambda name: True)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        hvt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 backward_passes_per_step=0)
