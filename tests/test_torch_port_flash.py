"""horovod_tpu_torch flash attention held against the JAX package's Pallas
flash attention (interpret mode on the CPU, as tests/test_flash_attention.py
runs it), on the same numpy inputs.

Tolerances: fp32 1e-5 forward and 1e-4 gradients, as
tests/test_flash_attention.py holds the Pallas kernels to a dense reference
(the two sides sum in different orders); bf16 5e-2, about six bf16 ulps at
the outputs' magnitude, because the two sides round p and o at different
points; fp16 1e-2 relative to each output's largest magnitude (fp16's ulp
is 8x finer than bf16's; the sides round p, o and, on the port's side, ds
and p before the backward products at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_reference,
                                                   flash_attention_with_lse,
                                                   resolve_flash)

FP32_FWD, FP32_GRAD, BF16, FP16 = 1e-5, 1e-4, 5e-2, 1e-2


def _inputs(b, s, h, h_kv, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    w = rng.normal(size=(b, s, h)).astype(np.float32)   # lse cotangent weights
    return q, k, v, w


def _loss_jax(q, k, v, w, causal, blocks):
    o, lse = jax_flash(q, k, v, causal=causal, block_q=blocks,
                       block_k=blocks)
    return jnp.sum(o * jnp.cos(o)) + jnp.sum(lse * w)


def _loss_torch(q, k, v, w, causal):
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    return (o * torch.cos(o)).sum() + (lse * w).sum()


@pytest.mark.parametrize("causal,s,h,h_kv,blocks", [
    (True, 128, 2, 2, 32),      # multi-block causal
    (False, 128, 2, 2, 32),     # non-causal
    (True, 96, 4, 2, 64),       # uneven S (JAX halves its blocks), GQA
    (False, 64, 4, 2, 32),      # GQA non-causal
])
def test_fp32_outputs_and_grads_match_jax(causal, s, h, h_kv, blocks):
    q, k, v, w = _inputs(2, s, h, h_kv, 32)
    fwd = jax.jit(lambda q, k, v: jax_flash(q, k, v, causal=causal,
                                            block_q=blocks, block_k=blocks))
    o_j, lse_j = fwd(q, k, v)
    g_j = jax.jit(jax.grad(_loss_jax, argnums=(0, 1, 2)),
                  static_argnums=(4, 5))(q, k, v, w, causal, blocks)

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o_t, lse_t = flash_attention_with_lse(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=FP32_FWD, atol=FP32_FWD)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j),
                               rtol=FP32_FWD, atol=FP32_FWD)
    g_t = torch.autograd.grad(_loss_torch(qt, kt, vt, torch.tensor(w),
                                          causal), (qt, kt, vt))
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FP32_GRAD,
                                   atol=FP32_GRAD, err_msg=name)


def test_bf16_forward_matches_jax():
    q, k, v, _ = _inputs(2, 128, 2, 2, 32)
    to_j = lambda x: jnp.asarray(x, jnp.bfloat16)
    to_t = lambda x: torch.tensor(x).to(torch.bfloat16)
    o_j = jax_flash(to_j(q), to_j(k), to_j(v), causal=True, block_q=32,
                    block_k=32)[0]
    o_t = flash_attention(to_t(q), to_t(k), to_t(v), causal=True)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)),
                               rtol=BF16, atol=BF16)


@pytest.mark.parametrize("causal,h,h_kv", [
    (True, 4, 4),       # causal
    (False, 4, 2),      # GQA, non-causal
    (True, 4, 1),       # GQA (one K/V head), causal
])
def test_fp16_outputs_and_grads_match_jax(causal, h, h_kv):
    """fp16 q/k/v at head_dim 32: o, lse and the gradients through both
    against the JAX package's flash attention in fp16 (Pallas interpret
    mode), each within FP16 of its largest magnitude. On the CPU the port
    runs the plain versions of the sm90 kernels with their fp16 operands:
    ds and p rounded to fp16 after dO is scaled by dout_scale."""
    q, k, v, w = _inputs(2, 128, h, h_kv, 32, seed=7)
    to_j = lambda x: jnp.asarray(x, jnp.float16)
    f16 = lambda x: torch.tensor(x).to(torch.float16)
    qj, kj, vj = to_j(q), to_j(k), to_j(v)
    o_j, lse_j = jax_flash(qj, kj, vj, causal=causal, block_q=32,
                           block_k=32)
    g_j = jax.grad(_loss_jax, argnums=(0, 1, 2))(qj, kj, vj, w, causal, 32)

    qt, kt, vt = (f16(x).requires_grad_() for x in (q, k, v))
    o_t, lse_t = flash_attention_with_lse(qt, kt, vt, causal=causal)
    assert o_t.dtype == torch.float16 and lse_t.dtype == torch.float32
    g_t = torch.autograd.grad(_loss_torch(qt, kt, vt, torch.tensor(w),
                                          causal), (qt, kt, vt))
    for name, got, want in [("o", o_t.detach(), o_j), ("lse", lse_t.detach(),
                                                       lse_j)] + list(
            zip(("dq", "dk", "dv"), g_t, g_j)):
        want = np.asarray(want.astype(jnp.float32))
        if name not in ("o", "lse"):
            assert got.dtype == torch.float16, name
        top = float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy() / top, want / top,
                                   rtol=FP16, atol=FP16, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernels_match_autograd_of_reference(causal):
    """The plain versions of the three kernels (what the CPU path runs)
    give the gradients that autograd gives through the dense reference."""
    q, k, v, w = (torch.tensor(x) for x in _inputs(2, 80, 4, 2, 16))
    scale = 16 ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_reference(*leaves, causal=causal)
    do = torch.cos(o.detach()) - o.detach() * torch.sin(o.detach())
    want = torch.autograd.grad(((o * torch.cos(o)).sum()
                                + (lse * w).sum()), leaves)

    o2, lse_bhs = _kernels.flash_fwd_plain(q, k, v, scale, causal,
                                           torch.float32)
    delta = ((do * o2).sum(-1) - w).transpose(1, 2).contiguous()
    dq = _kernels.flash_dq(q, k, v, do, lse_bhs, delta, scale, causal)
    dk, dv = _kernels.flash_dkv(q, k, v, do, lse_bhs, delta, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(a, b, rtol=FP32_GRAD, atol=FP32_GRAD,
                                   msg=name)
    assert dk.shape == k.shape and dv.shape == v.shape


def test_contract_errors_and_auto_policy():
    q = torch.zeros(1, 8, 3, 8)
    kv = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(q, kv, kv)
    route = (torch.bfloat16, 64)      # a shape the kernels take
    assert resolve_flash("auto", 255, *route) is False
    assert resolve_flash("auto", 256, *route) is True
    assert resolve_flash("auto", 1 << 20, *route) is True
    assert resolve_flash(True, 8, *route) is True
    with pytest.raises(ValueError):
        resolve_flash("always", 8, *route)



@pytest.mark.parametrize("bad,err,match", [
    (dict(q=(1, 16, 2, 12), k=(1, 16, 2, 12)), ValueError, "head_dim"),
    (dict(q=(1, 16, 2, 264), k=(1, 16, 2, 264)), ValueError, "head_dim"),
    (dict(k=(1, 16, 3, 16)), ValueError, "divisible"),
    (dict(k=(1, 8, 2, 16)), ValueError, "does not match"),
    (dict(dtype=torch.float64), TypeError, "fp32, bf16 or fp16"),
    (dict(out_dtype=torch.float16), TypeError, "o/dO"),
    (dict(dout=(1, 16, 2, 8)), ValueError, "dO"),
    (dict(lse=(1, 16, 2)), ValueError, "lse"),
    (dict(delta=(1, 2, 16), delta_dtype=torch.bfloat16), ValueError,
     "delta"),
    ({}, ValueError, "CUDA"),      # well formed, but not on a CUDA device
])
def test_kernel_wrappers_validate_before_launch(bad, err, match):
    """What the CUDA wrappers check before a pointer reaches a kernel."""
    dtype = bad.get("dtype", torch.float32)
    mk = lambda key, shape, dt=dtype: torch.zeros(bad.get(key, shape),
                                                  dtype=dt)
    q, k = mk("q", (1, 16, 2, 16)), mk("k", (1, 16, 2, 16))
    dout = mk("dout", tuple(q.shape))
    lse = mk("lse", (1, 2, 16), torch.float32)
    delta = mk("delta", (1, 2, 16), bad.get("delta_dtype", torch.float32))
    with pytest.raises(err, match=match):
        _kernels._check(q, k, k, bad.get("out_dtype", dtype), dout, lse,
                        delta)
