"""The routes that the tensor-core forward and dk/dv kernels took over from
the SIMT ones (fp32 at head_dim 32/64/96/128, bf16 at head_dim 32 and 96),
on the CPU: each wrapper runs the plain version of the kernel it would
launch on a CUDA tensor, and the port's flash attention on these routes is
held against the JAX package's (Pallas interpret mode, as
tests/test_flash_attention.py runs it) on the same numpy inputs.

Tolerances: bf16 5e-2 (tests/test_torch_port_flash.py's: the two sides
round p, o and, on the sm90 route, p and ds before the dk/dv products at
different points); fp32 1e-5 forward and 1e-4 gradients, as
tests/test_flash_attention.py holds the Pallas kernels to a dense
reference. On the card the fp32 route's products run as 3xTF32, within
about 2^-21 of fp32 products (tests/test_torch_port_cuda.py holds them to
these plain versions at 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops.flash_attention import flash_attention_with_lse

BF16, FP32_FWD, FP32_GRAD = 5e-2, 1e-5, 1e-4


def _inputs(b, s, h, h_kv, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, h_kv, h_kv, h)]


def _jax_side(q, k, v, do, causal, dtype, blocks):
    """o, lse and the (dq, dk, dv) of the cotangent do, from the JAX
    package's flash attention, as fp32 numpy."""
    to_j = lambda x: jnp.asarray(x, dtype)
    (o, lse), vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=blocks, block_k=blocks),
        to_j(q), to_j(k), to_j(v))
    grads = vjp((to_j(do), jnp.zeros_like(lse)))
    as_np = lambda x: np.asarray(x.astype(jnp.float32))
    return as_np(o), as_np(lse), [as_np(g) for g in grads]


def _torch_side(q, k, v, do, causal, dtype):
    leaves = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*leaves, causal=causal)
    o.backward(torch.tensor(do).to(dtype))
    return o.detach(), lse.detach(), [x.grad for x in leaves]


ROUTES = pytest.mark.parametrize("d,dtype,causal,s,h,h_kv", [
    (32, torch.bfloat16, True, 128, 4, 2),     # the entry model's head_dim
    (32, torch.bfloat16, False, 96, 2, 2),
    (96, torch.bfloat16, True, 96, 4, 1),      # MQA
    (96, torch.bfloat16, False, 64, 2, 2),
    (96, torch.float32, True, 128, 4, 2),
    (96, torch.float32, False, 64, 2, 1),
])


@ROUTES
def test_flash_on_the_new_routes_matches_jax(d, dtype, causal, s, h, h_kv):
    q, k, v, do = _inputs(2, s, h, h_kv, d)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    o_j, lse_j, g_j = _jax_side(q, k, v, do, causal, jdtype, 32)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, causal, dtype)
    fwd, grad = (BF16, BF16) if dtype == torch.bfloat16 else \
        (FP32_FWD, FP32_GRAD)
    assert o_t.dtype == dtype
    np.testing.assert_allclose(o_t.float().numpy(), o_j, rtol=fwd, atol=fwd)
    # lse is fp32 on both sides, scores summed in another order (from bf16
    # inputs, over a larger range: the gradients' tolerance)
    lse_tol = FP32_GRAD if dtype == torch.bfloat16 else FP32_FWD
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=lse_tol,
                               atol=lse_tol)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=grad,
                                   atol=grad, err_msg=name)


@ROUTES
def test_cpu_wrappers_run_the_plain_version_of_their_route(d, dtype, causal,
                                                          s, h, h_kv):
    """On a CPU tensor each wrapper runs the plain version of the kernel it
    would launch: dkv on bf16 rounds p and ds (flash_dkv_sm90's bf16
    operands), on fp32 keeps them (3xTF32 stands for fp32); dq keeps the
    SIMT route's fp32 ds at these head_dims."""
    q, k, v, do = (torch.tensor(x).to(dtype)
                   for x in _inputs(1, s, h, h_kv, d, seed=1))
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(q, k, v, scale, causal, dtype)
    assert _kernels._kernel("flash_fwd", q, None) == "flash_fwd_sm90"
    assert _kernels._kernel("flash_dkv", q, None) == "flash_dkv_sm90"
    assert _kernels._kernel("flash_dq", q, None) == "flash_dq"
    for got, want in zip((o, lse), _kernels.flash_fwd_plain(
            q, k, v, scale, causal, dtype)):
        assert torch.equal(got, want)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    bf16 = dtype == torch.bfloat16
    for got, want in zip(_kernels.flash_dkv(*args),
                         _kernels.flash_dkv_plain(*args,
                                                  round_operands=bf16)):
        assert torch.equal(got, want)
    if bf16:   # the rounding is real at these inputs: the routes differ
        assert not torch.equal(_kernels.flash_dkv(*args)[0],
                               _kernels.flash_dkv_plain(*args)[0])
    assert torch.equal(_kernels.flash_dq(*args),
                       _kernels.flash_dq_plain(*args))


def test_dq_keeps_its_route_and_refuses_sm90_where_it_has_none():
    """flash_dq_sm90 takes bf16 at head_dim 64 and 128 only: asked for on
    the routes this slice gave the fwd and dkv kernels, it raises."""
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32),
                     (torch.bfloat16, 96)):
        q = torch.zeros(1, 8, 2, d, dtype=dtype)
        lse = torch.zeros(1, 2, 8)
        with pytest.raises(ValueError, match="flash_dq_sm90 takes bfloat16 "
                                             "with head_dim 64, 128"):
            _kernels.flash_dq(q, q, q, q, lse, lse, 1.0, True,
                              variant="sm90")
        _kernels.flash_dkv(q, q, q, q, lse, lse, 1.0, True, variant="sm90")
        _kernels.flash_fwd(q, q, q, 1.0, True, dtype, variant="sm90")
