"""horovod_tpu_torch GPT held against the JAX package's flax GPT: the same
weights (carried across by models/convert.py) and the same tokens give the
same logits.

Config: the ``entry()`` model (__graft_entry__.py:_flagship) in
fp32. Tolerance rtol/atol 1e-4: both sides run the same fp32 arithmetic,
but XLA and PyTorch sum the products and reductions in different orders,
and two layers plus a 512-way vocab projection grow those ~1e-7 rounding
differences to ~1e-5 at the logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import GPT as JaxGPT
from horovod_tpu.models import GPTConfig as JaxGPTConfig
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.models.convert import params_from_flax, params_to_flax
from horovod_tpu_torch.train import loss_fn

ENTRY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4, d_ff=512,
             max_seq_len=128)
TOL = 1e-4


def _pair(**overrides):
    """(flax model, flax params, port model with the same weights, tokens)"""
    jcfg = JaxGPTConfig(**ENTRY, dtype=jnp.float32, **overrides)
    tcfg = GPTConfig(**ENTRY, dtype=torch.float32, **overrides)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 64))
    jmodel = JaxGPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    tmodel = GPT(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, tokens


@pytest.mark.parametrize("overrides", [
    {},                                          # einsum attention
    {"use_flash": True},                         # flash attention
    {"n_kv_heads": 2},                           # GQA, einsum
    {"n_kv_heads": 2, "use_flash": True},        # GQA, flash
    {"remat": True},                             # recomputed blocks
], ids=["einsum", "flash", "gqa", "gqa-flash", "remat"])
def test_logits_match_flax(overrides):
    jmodel, params, tmodel, tokens = _pair(**overrides)
    want = jmodel.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_return_hidden_matches_flax():
    jmodel, params, tmodel, tokens = _pair()
    want = jmodel.apply({"params": params}, jnp.asarray(tokens),
                        return_hidden=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens), return_hidden=True)
    assert got.shape == (2, 64, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_convert_round_trip_keeps_flax_layouts():
    _, params, tmodel, _ = _pair(n_kv_heads=2)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back = params_to_flax(tmodel.state_dict())
    back_flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat] == [p for p, _ in back_flat]
    for (path, a), (_, b) in zip(flat, back_flat):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a), b)
    attn = tmodel.blocks[0].attn
    assert tuple(attn.q.shape) == (128, 4, 32)      # (d_model, heads, hd)
    assert tuple(attn.k.shape) == (128, 2, 32)
    assert tuple(attn.o.shape) == (4, 32, 128)      # (heads, hd, d_model)
    assert tuple(tmodel.blocks[0].mlp.up.shape) == (128, 512)  # (in, out)


def test_bf16_model_matches_fp32_within_bf16():
    """cfg.dtype casts each product; params stay fp32."""
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 512,
                                                               (2, 32)))
    f32 = GPT(GPTConfig(**ENTRY, dtype=torch.float32), device="cpu", seed=3)
    b16 = GPT(GPTConfig(**ENTRY, dtype=torch.bfloat16), device="cpu", seed=3)
    assert all(p.dtype == torch.float32 for p in b16.parameters())
    with torch.no_grad():
        torch.testing.assert_close(b16(tokens), f32(tokens), rtol=5e-2,
                                   atol=5e-2)


class _Mesh:
    """What GPT reads of a parallel.mesh.Mesh before it builds anything."""

    def __init__(self, **shape):
        self.shape = shape

    def axis_size(self, axis):
        return self.shape.get(axis, 1)


def test_unported_options_raise():
    """The options GPT refuses: ring_mesh (ported in slice 5) must be the
    mesh the model is built on, a mesh that splits the sequence needs it,
    and n_kv_heads must divide n_heads."""
    with pytest.raises(ValueError, match="ring_mesh"):
        GPT(GPTConfig(**ENTRY, ring_mesh=_Mesh(sp=2)), device="cpu",
            mesh=_Mesh(sp=2))
    with pytest.raises(ValueError, match="ring_mesh"):
        GPT(GPTConfig(**ENTRY), device="cpu", mesh=_Mesh(sp=2))
    with pytest.raises(ValueError, match="divide"):
        GPT(GPTConfig(**ENTRY, n_kv_heads=3), device="cpu")


# Gemma's attention widths cut to a small size: head_dim 256, one K/V head
WIDE = dict(vocab_size=512, n_layers=2, d_model=512, n_heads=2, n_kv_heads=1,
            d_ff=512, max_seq_len=128)


def _loss_and_grads_match_flax(config, dtype, tol, tokens):
    """The port's GPT with ``config`` in ``dtype`` and use_flash=True against
    the JAX GPT's (Pallas interpret mode) from the same weights and
    tokens: the loss within ``tol`` (relative) and every parameter's
    gradient within ``tol`` of its largest magnitude."""
    jcfg = JaxGPTConfig(**config, dtype=getattr(jnp, dtype), use_flash=True)
    jmodel = JaxGPT(jcfg)
    # the same parameters as the flash model's, without tracing its kernels
    params = jax.jit(JaxGPT(dataclasses.replace(jcfg, use_flash=False)).init)(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens))
        targets = jnp.roll(jnp.asarray(tokens), -1, axis=-1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], targets[:, :-1]).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    tmodel = GPT(GPTConfig(**config, dtype=getattr(torch, dtype),
                           use_flash=True), device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    loss = loss_fn(tmodel, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=tol)
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    for name, p in tmodel.named_parameters():
        w = want[name].float()
        scale = float(w.abs().max())
        torch.testing.assert_close(p.grad / scale, w / scale, rtol=tol,
                                   atol=tol, msg=name)
    return tmodel


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-4),
    ("bfloat16", 5e-2),
    ("float16", 1e-2),
])
def test_head_dim_256_gpt_loss_and_grads_match_flax(dtype, tol):
    """A GPT at head_dim 256 with one K/V head through the flash path
    (use_flash=True; on the CPU the kernels' plain versions, in bf16 and
    fp16 those of the head_dim-256 tensor-core kernels with their 2-byte
    operands): the loss and every parameter's gradient against the JAX
    GPT's (Pallas interpret mode) from the same weights and tokens.
    Tolerance: fp32 1e-4, relative to each gradient's largest magnitude
    (the module's: the same fp32 arithmetic summed in other orders); bf16
    5e-2, the bf16 flash tolerance of tests/test_torch_port_flash.py (the
    two sides round every product's output, p and, on the sm90 route, p and
    ds at different points); fp16 1e-2, that file's fp16 tolerance (fp16's
    ulp is 8x finer than bf16's)."""
    tokens = np.random.RandomState(2).randint(0, 512, (1, 128))
    tmodel = _loss_and_grads_match_flax(WIDE, dtype, tol, tokens)
    assert tmodel.blocks[0].attn.k.shape == (512, 1, 256)


# the widest heads cut to a small size: two heads of 512, one K/V head
WIDEST = dict(vocab_size=512, n_layers=2, d_model=1024, n_heads=2,
              n_kv_heads=1, d_ff=512, max_seq_len=128)


@pytest.mark.parametrize("dtype,tol", [
    ("bfloat16", 5e-2),
    ("float16", 1e-2),
])
def test_head_dim_512_gpt_loss_and_grads_match_flax(dtype, tol):
    """A GPT at head_dim 512 with one K/V head through the flash path
    (use_flash=True; on the CPU the plain versions of the padded-width-512
    tensor-core kernels with their 2-byte operands): the loss and every
    parameter's gradient against the JAX GPT's (Pallas interpret mode) from
    the same weights and tokens, at the tolerances of
    test_head_dim_256_gpt_loss_and_grads_match_flax."""
    tokens = np.random.RandomState(4).randint(0, 512, (1, 128))
    tmodel = _loss_and_grads_match_flax(WIDEST, dtype, tol, tokens)
    assert tmodel.blocks[0].attn.k.shape == (1024, 1, 512)


def test_fp16_flash_entry_gpt_loss_and_grads_match_flax():
    """The ENTRY GPT (head_dim 32) in fp16 with use_flash=True, as the JAX
    package's GPT runs fp16 (no loss scaler): on the CPU the plain versions
    of the fp16 tensor-core kernels (ds and p rounded to fp16 after dO is
    scaled by a power of two). The loss and every parameter's gradient
    within 1e-2 of the JAX GPT's, the fp16 flash tolerance."""
    tokens = np.random.RandomState(3).randint(0, 512, (2, 64))
    tmodel = _loss_and_grads_match_flax(ENTRY, "float16", 1e-2, tokens)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
