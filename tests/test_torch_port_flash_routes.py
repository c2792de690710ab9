"""The routes the tensor-core kernels took over from the SIMT ones, on the
CPU: the forward and dk/dv kernels' fp32 at head_dim 32/64/96/128 and bf16
at head_dim 32 and 96, then dq's fp32 and bf16 at every head_dim, the
forward's and dk/dv's head_dims off the 32-grid (8, 48, 80), the sequence
ring's bf16 q with an fp32 o and dO, bf16 at the wide heads (head_dim
136..256, padded to 192 or 256), the ring's fp32 o and dO at the wide heads
too, fp32 at the wide heads, bf16 and fp16 at the widest heads (head_dim
264..512, padded to 384 or 512, o in q's dtype), and head_dims off the
kernels' grid of 8 (1..7 and the rest), which the port's flash attention
zero-pads to the next multiple of 8. Each wrapper
runs the plain version of the kernel it would launch on a CUDA tensor, and
the port's flash attention on these routes is held against the JAX
package's (Pallas interpret mode, as tests/test_flash_attention.py runs it)
on the same numpy inputs. Then ``use_flash="auto"``: it takes the kernels
only where all three take the shape, and the model and the
sequence-parallel paths follow it.

Tolerances: bf16 5e-2 (tests/test_torch_port_flash.py's: the two sides
round p, o and, on the sm90 route, p and ds before the dk/dv products and
ds before ds k at different points); fp16 1e-2 relative to each output's
largest magnitude (that file's too: fp16's ulp is 8x finer than bf16's,
the sides round at the same different points); fp32 1e-5 forward and 1e-4
gradients,
as tests/test_flash_attention.py holds the Pallas kernels to a dense
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
from horovod_tpu_torch.models import transformer
from horovod_tpu_torch.models.transformer import Attention, GPTConfig
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops.flash_attention import (flash_attention_with_lse,
                                                   resolve_flash)
from horovod_tpu_torch.parallel import sequence

BF16, FP16, FP32_FWD, FP32_GRAD = 5e-2, 1e-2, 1e-5, 1e-4


def _inputs(b, s, h, h_kv, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, h_kv, h_kv, h)]


def _jax_side(q, k, v, do, causal, dtype, blocks, out_dtype=None):
    """o, lse and the (dq, dk, dv) of the cotangent do, from the JAX
    package's flash attention, as fp32 numpy."""
    to_j = lambda x: jnp.asarray(x, dtype)
    (o, lse), vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=blocks, block_k=blocks,
        out_dtype=out_dtype), to_j(q), to_j(k), to_j(v))
    grads = vjp((jnp.asarray(do, o.dtype), jnp.zeros_like(lse)))
    as_np = lambda x: np.asarray(x.astype(jnp.float32))
    return as_np(o), as_np(lse), [as_np(g) for g in grads]


def _torch_side(q, k, v, do, causal, dtype, out_dtype=None):
    leaves = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*leaves, causal=causal,
                                      out_dtype=out_dtype)
    o.backward(torch.tensor(do).to(o.dtype))
    return o.detach(), lse.detach(), [x.grad for x in leaves]


ROUTES = pytest.mark.parametrize("d,dtype,causal,s,h,h_kv", [
    (32, torch.bfloat16, True, 128, 4, 2),     # the entry model's head_dim
    (32, torch.bfloat16, False, 96, 2, 2),
    (96, torch.bfloat16, True, 96, 4, 1),      # MQA
    (96, torch.bfloat16, False, 64, 2, 2),
    (96, torch.float32, True, 128, 4, 2),
    (96, torch.float32, False, 64, 2, 1),
    # dq on the tensor cores: fp32 (3xTF32) at every head_dim, bf16 off
    # 64/128; all three kernels at head_dims off the 32-grid (padded)
    (32, torch.float32, True, 128, 4, 2),
    (48, torch.float32, True, 96, 4, 2),
    (64, torch.float32, False, 64, 2, 2),
    (128, torch.float32, True, 64, 2, 1),      # MQA
    (48, torch.bfloat16, True, 96, 4, 2),
    (80, torch.bfloat16, False, 64, 2, 2),
    (80, torch.float32, True, 64, 4, 2),
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
    would launch: all three take sm90 at every head_dim; on bf16 dkv carries
    dO as two bf16 terms and rounds p and ds (flash_dkv_sm90's bf16
    operands), dq carries dO as two bf16 terms and rounds ds, and on fp32
    both keep every operand (3xTF32 stands for fp32)."""
    q, k, v, do = (torch.tensor(x).to(dtype)
                   for x in _inputs(1, s, h, h_kv, d, seed=1))
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(q, k, v, scale, causal, dtype)
    for base in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert _kernels._kernel(base, q, None) == base + "_sm90"
    for got, want in zip((o, lse), _kernels.flash_fwd_plain(
            q, k, v, scale, causal, dtype)):
        assert torch.equal(got, want)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    bf16 = dtype == torch.bfloat16
    for got, want in zip(_kernels.flash_dkv(*args),
                         _kernels.flash_dkv_plain(*args, split_dout=bf16,
                                                  round_operands=bf16)):
        assert torch.equal(got, want)
    dq = _kernels.flash_dq(*args)
    assert torch.equal(dq, _kernels.flash_dq_plain(
        *args, split_dout=bf16, round_ds=bf16))
    if bf16:   # the rounding is real at these inputs: the routes differ
        assert not torch.equal(dq, _kernels.flash_dq_plain(*args))
        assert not torch.equal(_kernels.flash_dkv(*args)[0],
                               _kernels.flash_dkv_plain(*args)[0])


@pytest.mark.parametrize("causal", [True, False])
def test_ring_route_bf16_q_with_fp32_o_matches_jax(causal):
    """The sequence ring's blocks: bf16 q, k, v with an fp32 o, so an fp32
    dO (horovod_tpu_torch/parallel/sequence.py). Held against the JAX
    package with the same out_dtype at the bf16 tolerance; on the CPU the
    dq and dkv wrappers run flash_dq_sm90's and flash_dkv_sm90's plain
    versions, which carry dO as two bf16 terms, and that keeps dq closer to
    the fp32-operand version than one rounding does (dkv's own check is
    test_ring_route_dkv_carries_fp32_dout_as_two_terms)."""
    d, s, h, h_kv = 64, 128, 4, 2
    q, k, v, do = _inputs(2, s, h, h_kv, d, seed=2)
    o_j, lse_j, g_j = _jax_side(q, k, v, do, causal, jnp.bfloat16, 32,
                                out_dtype=jnp.float32)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, causal, torch.bfloat16,
                                  out_dtype=torch.float32)
    assert o_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), o_j, rtol=BF16, atol=BF16)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FP32_GRAD,
                               atol=FP32_GRAD)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16,
                                   atol=BF16, err_msg=name)

    qt, kt, vt = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    dot = torch.tensor(do)
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(qt, kt, vt, scale, causal, torch.float32)
    delta = (dot * o).sum(-1).transpose(1, 2).contiguous()
    args = (qt, kt, vt, dot, lse, delta, scale, causal)
    dq = _kernels.flash_dq(*args)
    assert torch.equal(dq, _kernels.flash_dq_plain(*args, split_dout=True,
                                                   round_ds=True))
    # dq in fp32 (before its final rounding to bf16), ds rounded on every
    # side: the two terms move it less from fp32 dO's than one rounding
    f32 = [x.float() for x in (qt, kt, vt)]
    want = _kernels.flash_dq_plain(*f32, dot, lse, delta, scale, causal,
                                   round_ds=True)
    two = _kernels.flash_dq_plain(*f32, dot, lse, delta, scale, causal,
                                  split_dout=True, round_ds=True)
    one = _kernels.flash_dq_plain(*f32, dot.to(torch.bfloat16), lse, delta,
                                  scale, causal, round_ds=True)
    assert (two - want).abs().max() < (one - want).abs().max()


@pytest.mark.parametrize("causal", [True, False])
def test_ring_route_dkv_carries_fp32_dout_as_two_terms(causal):
    """The sequence ring's blocks (bf16 q, k, v with an fp32 dO): on the CPU
    the dkv wrapper runs flash_dkv_sm90's plain version, which splits dO
    into two bf16 terms where the parent route rounded it to one. In fp32
    (before dk and dv's final rounding to bf16), p and ds rounded on every
    side, the two terms lie nearer the fp32-dO version than one rounding
    does."""
    d, s, h, h_kv = 64, 128, 4, 2
    q, k, v, do = _inputs(2, s, h, h_kv, d, seed=3)
    qt, kt, vt = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    dot = torch.tensor(do)
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(qt, kt, vt, scale, causal, torch.float32)
    delta = (dot * o).sum(-1).transpose(1, 2).contiguous()
    args = (qt, kt, vt, dot, lse, delta, scale, causal)
    for got, want in zip(_kernels.flash_dkv(*args),
                         _kernels.flash_dkv_plain(*args, split_dout=True,
                                                  round_operands=True)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)
    f32 = [x.float() for x in (qt, kt, vt)]
    rest = (lse, delta, scale, causal)
    want = _kernels.flash_dkv_plain(*f32, dot, *rest, round_operands=True)
    two = _kernels.flash_dkv_plain(*f32, dot, *rest, split_dout=True,
                                   round_operands=True)
    one = _kernels.flash_dkv_plain(*f32, dot.to(torch.bfloat16), *rest,
                                   round_operands=True)
    for name, w, t, o1 in zip(("dk", "dv"), want, two, one):
        assert (t - w).abs().max() < (o1 - w).abs().max(), name


def _fp16_ring_grads(q, k, v, do, m, rounds):
    """dq, dk, dv (fp32) of the plain versions at an fp16 ring block with
    the fp32 dO times ``m``: with the kernels' fp16 operands (``rounds``) or
    every operand fp32."""
    scale = q.shape[-1] ** -0.5
    o, lse = _kernels.flash_fwd_plain(q, k, v, scale, True, torch.float32)
    dom = do * m
    delta = (dom * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dom, lse, delta, scale, True)
    dq = _kernels.flash_dq_plain(*args, split_dout=rounds, round_ds=rounds)
    dk, dv = _kernels.flash_dkv_plain(*args, split_dout=rounds,
                                      round_operands=rounds)
    return [t.float() for t in (dq, dk, dv)]


@pytest.mark.parametrize("m", [2.0 ** -20, 1.0, 2.0 ** 12])
def test_fp16_split_of_fp32_dout_keeps_its_precision_at_any_magnitude(m):
    """fp16 q with the ring's fp32 dO, dO times 2^-20, 1 and 2^12: the plain
    versions of flash_dq_sm90 and flash_dkv_sm90 take dO times
    dout_scale(dO), the power of two that brings its largest magnitude
    into [0.5, 1), and split that into two fp16 terms. The scale follows
    the magnitude exactly, so the two terms are the same bits at every
    magnitude and carry the scaled dO within 2^-22 of its largest
    magnitude; unscaled, at 2^-20 they would lose dO's low bits to fp16's
    subnormals. dq, dk and dv then stay within twice their error at
    magnitude 1 against the fp32-operand plain version, relative to each
    output's largest magnitude, plus one step of fp16's subnormal grid
    (2^-24) relative to it: the fp16 output's own resolution."""
    q, k, v = (torch.tensor(x).to(torch.float16)
               for x in _inputs(1, 64, 4, 2, 32, seed=12)[:3])
    do = torch.tensor(_inputs(1, 64, 4, 2, 32, seed=13)[3])
    f16 = torch.float16
    s1, sm = _kernels.dout_scale(do), _kernels.dout_scale(do * m)
    top = float(do.abs().max()) * m
    assert 0.5 <= top * float(sm) < 1 and float(sm) * m == float(s1)
    terms = _kernels._terms(do * m * sm, f16)
    assert torch.equal(terms, _kernels._terms(do * s1, f16))
    assert float((terms - do * m * sm).abs().max()) <= 2.0 ** -22
    if m < 1:
        unscaled = _kernels._terms(do * m, f16)
        assert float((unscaled - do * m).abs().max()) / top > 2.0 ** -14
    for n, got, want, got1, want1 in zip(
            ("dq", "dk", "dv"), _fp16_ring_grads(q, k, v, do, m, True),
            _fp16_ring_grads(q, k, v, do, m, False),
            _fp16_ring_grads(q, k, v, do, 1.0, True),
            _fp16_ring_grads(q, k, v, do, 1.0, False)):
        assert bool(torch.isfinite(got).all()), n
        largest = float(want.abs().max())
        err = float((got - want).abs().max()) / largest
        err1 = float((got1 - want1).abs().max()) / float(want1.abs().max())
        assert err <= 2 * err1 + 2.0 ** -24 / largest, (n, err, err1)


def test_dout_scale_is_an_exact_power_of_two():
    """dout_scale: 2^e with max |dO| 2^e in [0.5, 1), e within +-120, and 1
    for an all-zero or non-finite dO, as the kernels compute it from the
    magnitude the wrappers pass (dout_amax)."""
    for top in (1e-5, 0.75, 1.0, 3.0, 65504.0, 2.0 ** -130, 3e38):
        x = torch.tensor([top, -top / 3], dtype=torch.float32)
        s = float(_kernels.dout_scale(x))
        assert s == 2.0 ** round(np.log2(s))
        if 2.0 ** -120 <= top <= 2.0 ** 120:
            assert 0.5 <= top * s < 1
        else:
            assert s in (2.0 ** 120, 2.0 ** -120)
    for x in (torch.zeros(4), torch.tensor([1.0, float("inf")]),
              torch.tensor([float("nan")])):
        assert float(_kernels.dout_scale(x)) == 1.0
    half = torch.tensor([[6e-5, -2.0]], dtype=torch.float16)
    assert float(_kernels.dout_amax(half)) == 2.0
    assert float(_kernels.dout_scale(half)) == 0.25


def test_dq_and_fwd_take_sm90_on_every_route_and_dkv_refuses_it_off_the_grid():
    """flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90 take bf16 and fp32
    at every head_dim 1..256 (off the kernels' grid of 8 zero-padded to it),
    so no route reaches a SIMT kernel, and each works asked for by name at a
    padded head_dim (48) and at one off the grid (44); off the routes' grid
    of head_dims (fp32 above 256) dkv's tensor-core kernel, asked for by
    name, raises, naming each route's range."""
    lse = torch.zeros(1, 2, 8)
    for dtype in (torch.bfloat16, torch.float32):
        for d in range(1, 257):
            for base in ("flash_fwd", "flash_dq", "flash_dkv"):
                assert _kernels._variant(base, dtype, d) == "sm90"
        for d in (48, 44):
            q = torch.zeros(1, 8, 2, d, dtype=dtype)
            _kernels.flash_fwd(q, q, q, 1.0, True, dtype, variant="sm90")
            _kernels.flash_dq(q, q, q, q, lse, lse, 1.0, True,
                              variant="sm90")
            dk, dv = _kernels.flash_dkv(q, q, q, q, lse, lse, 1.0, True,
                                        variant="sm90")
            assert dk.shape == dv.shape == q.shape and dk.dtype == dtype
    q = torch.zeros(1, 8, 2, 264)
    assert _kernels._variant("flash_dkv", torch.float32, 264) == "simt"
    with pytest.raises(ValueError, match=r"flash_dkv_sm90 takes bfloat16 q "
                                         r"with head_dim 1\.\.512 \(o/dO "
                                         r"bfloat16\) or 1\.\.256 \(o/dO "
                                         r"float32\)"):
        _kernels.flash_dkv(q, q, q, q, lse, lse, 1.0, True, variant="sm90")


def test_sm90_takes_2byte_q_up_to_512_and_fp32_or_an_fp32_o_up_to_256():
    """sm90_takes, which use_flash="auto" asks: bf16 and fp16 q with an o in
    q's dtype at every head_dim 1..512 (padded widths 384 and 512 above
    256), not at 520; with the ring's fp32 o at 1..256, not at 264; fp32 q
    with an fp32 o at 1..256 (3xTF32 at padded widths 192 and 256 above
    128), not at 264; and no 2-byte o other than q's."""
    for d in range(1, 513):
        for dtype in (torch.bfloat16, torch.float16):
            assert _kernels.sm90_takes(dtype, d)
            assert _kernels.sm90_takes(dtype, d, torch.float32) == (d <= 256)
        assert _kernels.sm90_takes(torch.float32, d) == (d <= 256)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert not _kernels.sm90_takes(dtype, 520)
    assert not _kernels.sm90_takes(torch.float16, 264, torch.float32)
    assert not _kernels.sm90_takes(torch.bfloat16, 264, torch.float32)
    assert not _kernels.sm90_takes(torch.float16, 64, torch.bfloat16)
    assert not _kernels.sm90_takes(torch.float32, 64, torch.bfloat16)


# ---- the wide heads (bf16 q with a bf16 o/dO at head_dim 136..256) -------

@pytest.mark.parametrize("d", [192, 256])
def test_wide_heads_match_jax(d):
    """bf16 at head_dim 192 and 256, GQA (H 2, H_kv 1), causal: the plain
    versions of flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90 (what the
    wrappers run on CPU tensors) against the JAX package's flash attention
    at BF16, the file's bf16 tolerance (the two sides round p, o and, on
    the sm90 route, p and ds before the backward products at different
    points)."""
    q, k, v, do = _inputs(1, 128, 2, 1, d, seed=4)
    o_j, lse_j, g_j = _jax_side(q, k, v, do, True, jnp.bfloat16, 64)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, True, torch.bfloat16)
    np.testing.assert_allclose(o_t.float().numpy(), o_j, rtol=BF16,
                               atol=BF16)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FP32_GRAD,
                               atol=FP32_GRAD)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        assert got.dtype == torch.bfloat16 and got.shape[-1] == d
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16,
                                   atol=BF16, err_msg=name)


@pytest.mark.parametrize("d", [136, 200, 256])
def test_wide_heads_take_the_sm90_route_and_its_rounding(d):
    """On a CPU tensor each wrapper runs the plain version of the
    tensor-core kernel at every wide head_dim (136 and 200 padded to 192
    and 256): dq and dk/dv round their operands to bf16 as the kernels
    do."""
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16)
                   for x in _inputs(1, 64, 2, 1, d, seed=5))
    scale = d ** -0.5
    for base in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert _kernels._variant(base, torch.bfloat16, d) == "sm90"
        assert _kernels._kernel(base, q, "sm90") == base + "_sm90"
    o, lse = _kernels.flash_fwd(q, k, v, scale, True, torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, True)
    assert torch.equal(_kernels.flash_dq(*args), _kernels.flash_dq_plain(
        *args, split_dout=True, round_ds=True))
    for got, want in zip(_kernels.flash_dkv(*args), _kernels.flash_dkv_plain(
            *args, split_dout=True, round_operands=True)):
        assert torch.equal(got, want)


# ---- fp32 at the wide heads (3xTF32 at padded widths 192 and 256) -------

@pytest.mark.parametrize("d", [136, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_wide_heads_match_jax(d, causal):
    """fp32 at head_dim 136, 200 and 256 (padded widths 192 and 256 on the
    card) with one K/V head (the wide_head GPT's attention, cut down):
    the plain versions of flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90,
    which keep every operand fp32 as the kernels' 3xTF32 does, against the
    JAX package's flash attention (Pallas interpret mode) at FP32_FWD
    (forward) and FP32_GRAD (lse, gradients)."""
    q, k, v, do = _inputs(1, 64, 2, 1, d, seed=10)
    o_j, lse_j, g_j = _jax_side(q, k, v, do, causal, jnp.float32, 32)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, causal, torch.float32)
    assert o_t.dtype == torch.float32 and o_t.shape[-1] == d
    np.testing.assert_allclose(o_t.numpy(), o_j, rtol=FP32_FWD,
                               atol=FP32_FWD)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FP32_GRAD,
                               atol=FP32_GRAD)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        assert got.dtype == torch.float32 and got.shape[-1] == d
        np.testing.assert_allclose(got.numpy(), want, rtol=FP32_GRAD,
                                   atol=FP32_GRAD, err_msg=name)


@pytest.mark.parametrize("d", [136, 200, 256])
def test_fp32_wide_heads_take_the_sm90_route_with_fp32_operands(d):
    """On a CPU tensor each wrapper runs the plain version of the
    tensor-core kernel at every fp32 wide head_dim, every operand fp32 (no
    bf16 rounding, no split of dO: 3xTF32 stands for fp32)."""
    q, k, v, do = (torch.tensor(x) for x in _inputs(1, 64, 2, 1, d, seed=11))
    scale = d ** -0.5
    for base in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert _kernels._variant(base, torch.float32, d) == "sm90"
        assert _kernels._kernel(base, q, None) == base + "_sm90"
    assert not _kernels._rounds_operands("flash_dq_sm90", q, torch.float32)
    o, lse = _kernels.flash_fwd(q, k, v, scale, True, torch.float32)
    for got, want in zip((o, lse), _kernels.flash_fwd_plain(
            q, k, v, scale, True, torch.float32)):
        assert torch.equal(got, want)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, True)
    assert torch.equal(_kernels.flash_dq(*args),
                       _kernels.flash_dq_plain(*args))
    for got, want in zip(_kernels.flash_dkv(*args),
                         _kernels.flash_dkv_plain(*args)):
        assert got.dtype == torch.float32 and torch.equal(got, want)


# ---- the widest heads (bf16 and fp16 q, o in q's dtype, head_dim 264..512)

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,causal", [(264, True), (384, True), (512, True),
                                      (512, False)])
def test_widest_heads_match_jax(d, causal, dtype):
    """bf16 and fp16 at head_dim 264, 384 and 512 (padded widths 384 and
    512 on the card, 264 with D at run time), one K/V head, causal and not:
    the plain versions of flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90
    (what the wrappers run on CPU tensors, with the kernels' 2-byte
    operands) against the JAX package's flash attention (Pallas interpret
    mode) on the same inputs and cotangent: o, dq, dk and dv within BF16
    (bf16) or within FP16 of each output's largest magnitude (fp16), lse
    within FP32_GRAD."""
    q, k, v, do = _inputs(1, 128, 2, 1, d, seed=14)
    bf16 = dtype == torch.bfloat16
    o_j, lse_j, g_j = _jax_side(q, k, v, do, causal,
                                jnp.bfloat16 if bf16 else jnp.float16, 64)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, causal, dtype)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FP32_GRAD,
                               atol=FP32_GRAD)
    for name, got, want in zip(("o", "dq", "dk", "dv"), [o_t, *g_t],
                               [o_j, *g_j]):
        assert got.dtype == dtype and got.shape[-1] == d, name
        top = 1.0 if bf16 else float(np.abs(want).max())
        tol = BF16 if bf16 else FP16
        np.testing.assert_allclose(got.float().numpy() / top, want / top,
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [264, 400, 512])
def test_widest_heads_take_the_sm90_route_and_its_rounding(d, dtype):
    """On a CPU tensor each wrapper runs the plain version of the
    tensor-core kernel at the widest heads (264 and 400 with D at run time
    in the padded-width-384 and 512 instances): dq and dk/dv round their
    operands to q's dtype as the kernels do (fp16 after dO's scale), and
    that rounding is real at these inputs."""
    q, k, v, do = (torch.tensor(x).to(dtype)
                   for x in _inputs(1, 64, 2, 1, d, seed=15))
    scale = d ** -0.5
    for base in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert _kernels._variant(base, dtype, d) == "sm90"
        assert _kernels._kernel(base, q, None) == base + "_sm90"
    assert _kernels._rounds_operands("flash_dkv_sm90", q, dtype)
    o, lse = _kernels.flash_fwd(q, k, v, scale, True, dtype)
    for got, want in zip((o, lse), _kernels.flash_fwd_plain(
            q, k, v, scale, True, dtype)):
        assert torch.equal(got, want)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, True)
    dq = _kernels.flash_dq(*args)
    assert torch.equal(dq, _kernels.flash_dq_plain(*args, split_dout=True,
                                                   round_ds=True))
    assert not torch.equal(dq, _kernels.flash_dq_plain(*args))
    dk, dv = _kernels.flash_dkv(*args)
    for got, want in zip((dk, dv), _kernels.flash_dkv_plain(
            *args, split_dout=True, round_operands=True)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert not torch.equal(dk, _kernels.flash_dkv_plain(*args)[0])


@pytest.mark.parametrize("dtype,d,out_dtype", [
    (torch.float32, 264, None),            # fp32 past 256
    (torch.float16, 520, None),            # fp16 past 512
    (torch.float16, 264, torch.float32),   # fp16 with an fp32 o past 256
    (torch.bfloat16, 264, torch.float32),  # the ring's fp32 o past 256
    (torch.bfloat16, 520, None),           # past 512
    (torch.float16, 516, None),            # padded to 520: past 512
])
def test_shapes_no_kernel_takes_raise_on_a_cuda_tensor(monkeypatch, dtype,
                                                       d, out_dtype):
    """Where no tensor-core kernel takes the shape, each wrapper raises
    ``ValueError`` before a launch, naming the routes, whatever ``variant``
    None chose; a SIMT kernel asked for by name above head_dim 128 raises
    too."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(_kernels, "_run", no_launch)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    o_dtype = out_dtype or dtype
    q = meta((1, 16, 2, d), dtype)
    do = meta((1, 16, 2, d), o_dtype)
    lse = meta((1, 2, 16), torch.float32)
    assert not _kernels.sm90_takes(dtype, d, out_dtype)
    with pytest.raises(ValueError, match=r"flash_fwd_sm90 takes bfloat16 q "
                                         r"with head_dim 1\.\.512 \(o/dO "
                                         r"bfloat16\) or 1\.\.256 \(o/dO "
                                         r"float32\), float16 q with "
                                         r"head_dim 1\.\.512 \(o/dO "
                                         r"float16\) or 1\.\.256 \(o/dO "
                                         r"float32\) and float32 q with "
                                         r"head_dim 1\.\.256 \(o/dO "
                                         r"float32\); got "):
        _kernels.flash_fwd(q, q, q, 1.0, True, o_dtype)
    with pytest.raises(ValueError, match="flash_dq_sm90 takes"):
        _kernels.flash_dq(q, q, q, do, lse, lse, 1.0, True)
    with pytest.raises(ValueError, match="flash_dkv_sm90 takes"):
        _kernels.flash_dkv(q, q, q, do, lse, lse, 1.0, True)
    if d > 128:
        with pytest.raises(ValueError, match=r"flash_dkv \(SIMT\) takes"):
            _kernels.flash_dkv(q, q, q, do, lse, lse, 1.0, True,
                               variant="simt")


@pytest.mark.parametrize("dtype,d,out_dtype", [
    (torch.bfloat16, 256, torch.float32),  # the ring's fp32 o and dO
    (torch.bfloat16, 200, torch.float32),  # the same, padded to 256
    (torch.bfloat16, 100, None),           # off the 8-grid
    (torch.float32, 36, None),
    (torch.bfloat16, 250, torch.float32),  # the ring and off the grid
    (torch.float32, 4, None),              # below 8
    (torch.float32, 136, None),            # fp32 at the wide heads
    (torch.float32, 200, None),
    (torch.float32, 256, None),
    (torch.float32, 250, None),            # and off the grid
    (torch.bfloat16, 264, None),           # the widest heads: to 384
    (torch.float16, 264, None),
    (torch.float16, 300, None),            # off the 8-grid: to 304, 384
    (torch.bfloat16, 512, None),
    (torch.float16, 400, None),            # to 512
])
def test_new_routes_reach_the_kernels_on_a_cuda_tensor(monkeypatch, dtype, d,
                                                       out_dtype):
    """Where a tensor-core kernel takes the shape, each wrapper gets past
    the route check on a tensor off the CPU and hands its kernel the inputs
    zero-padded to the next multiple of 8 (none where the head_dim is one),
    and its outputs come back at the true head_dim. The kernel's launch and
    the device check are stood in for: there is no card here."""
    launched = []
    monkeypatch.setattr(_kernels, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(_kernels, "_run", lambda name, tensors, *rest:
                        launched.append((name, tensors[0].shape[-1])))
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    o_dtype = out_dtype or dtype
    q = meta((1, 16, 2, d), dtype)
    do = meta((1, 16, 2, d), o_dtype)
    lse = meta((1, 2, 16), torch.float32)
    assert _kernels.sm90_takes(dtype, d, out_dtype)
    o, _ = _kernels.flash_fwd(q, q, q, 1.0, True, o_dtype)
    dq = _kernels.flash_dq(q, q, q, do, lse, lse, 1.0, True)
    dk, dv = _kernels.flash_dkv(q, q, q, do, lse, lse, 1.0, True)
    dp = -(-d // 8) * 8
    assert launched == [(n, dp) for n in ("flash_fwd_sm90", "flash_dq_sm90",
                                          "flash_dkv_sm90")]
    assert o.shape == dq.shape == dk.shape == dv.shape == q.shape
    assert o.dtype == o_dtype and dq.dtype == dk.dtype == dtype


# ---- the ring's fp32 o and dO at the wide heads ----------------------------

@pytest.mark.parametrize("d", [200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_route_at_wide_heads_matches_jax(d, causal):
    """The sequence ring's blocks at the wide heads: bf16 q, k, v with an
    fp32 o, so an fp32 dO, GQA with one K/V head (the wide_head GPT's
    attention, cut down). Held against the JAX package with the same
    out_dtype at BF16, the file's bf16 tolerance."""
    q, k, v, do = _inputs(1, 64, 4, 1, d, seed=6)
    o_j, lse_j, g_j = _jax_side(q, k, v, do, causal, jnp.bfloat16, 32,
                                out_dtype=jnp.float32)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, causal, torch.bfloat16,
                                  out_dtype=torch.float32)
    assert o_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), o_j, rtol=BF16, atol=BF16)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FP32_GRAD,
                               atol=FP32_GRAD)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        assert got.dtype == torch.bfloat16 and got.shape[-1] == d
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16,
                                   atol=BF16, err_msg=name)


def test_wide_ring_route_carries_fp32_dout_as_two_terms():
    """At head_dim 256 the ring's fp32 dO reaches flash_dq_sm90's and
    flash_dkv_sm90's plain versions as two bf16 terms: in fp32 (before the
    final rounding to bf16), with ds (and p) rounded on every side, dq, dk
    and dv lie nearer the fp32-dO version than one rounding of dO does."""
    d = 256
    q, k, v, do = _inputs(1, 64, 4, 1, d, seed=7)
    qt, kt, vt = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    dot = torch.tensor(do)
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(qt, kt, vt, scale, True, torch.float32)
    delta = (dot * o).sum(-1).transpose(1, 2).contiguous()
    args = (qt, kt, vt, dot, lse, delta, scale, True)
    assert torch.equal(_kernels.flash_dq(*args), _kernels.flash_dq_plain(
        *args, split_dout=True, round_ds=True))
    for got, want in zip(_kernels.flash_dkv(*args), _kernels.flash_dkv_plain(
            *args, split_dout=True, round_operands=True)):
        assert torch.equal(got, want)
    f32 = [x.float() for x in (qt, kt, vt)]
    rest = (lse, delta, scale, True)
    for fn, flag in ((_kernels.flash_dq_plain, "round_ds"),
                     (_kernels.flash_dkv_plain, "round_operands")):
        want = fn(*f32, dot, *rest, **{flag: True})
        two = fn(*f32, dot, *rest, split_dout=True, **{flag: True})
        one = fn(*f32, dot.to(torch.bfloat16), *rest, **{flag: True})
        if isinstance(want, torch.Tensor):
            want, two, one = (want,), (two,), (one,)
        for w, t, o1 in zip(want, two, one):
            assert (t - w).abs().max() < (o1 - w).abs().max(), fn.__name__


# ---- head_dims off the kernels' grid of 8 --------------------------------

@pytest.mark.parametrize("d,dtype,out_dtype", [
    (4, torch.float32, None),
    (36, torch.float32, None),
    (100, torch.float32, None),
    (4, torch.bfloat16, None),
    (36, torch.bfloat16, None),
    (100, torch.bfloat16, None),
    (250, torch.bfloat16, None),
    (250, torch.bfloat16, torch.float32),   # the ring's, off the grid
    (250, torch.float32, None),             # fp32 at the wide heads
])
def test_off_grid_head_dims_match_jax(d, dtype, out_dtype):
    """Head_dims that are no multiple of 8, which the port's flash attention
    zero-pads to the next one, against the JAX package's flash attention,
    which takes them as they are, causal, GQA: fp32 at FP32_FWD (forward)
    and FP32_GRAD (gradients, lse), bf16 at BF16."""
    q, k, v, do = _inputs(1, 64, 4, 2, d, seed=8)
    bf16 = dtype == torch.bfloat16
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    o_j, lse_j, g_j = _jax_side(
        q, k, v, do, True, jdtype, 32,
        out_dtype=None if out_dtype is None else jnp.float32)
    o_t, lse_t, g_t = _torch_side(q, k, v, do, True, dtype,
                                  out_dtype=out_dtype)
    fwd, grad = (BF16, BF16) if bf16 else (FP32_FWD, FP32_GRAD)
    assert o_t.dtype == (out_dtype or dtype) and o_t.shape[-1] == d
    np.testing.assert_allclose(o_t.float().numpy(), o_j, rtol=fwd, atol=fwd)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=FP32_GRAD,
                               atol=FP32_GRAD)
    for name, got, want in zip(("dq", "dk", "dv"), g_t, g_j):
        assert got.dtype == dtype and got.shape[-1] == d
        np.testing.assert_allclose(got.float().numpy(), want, rtol=grad,
                                   atol=grad, err_msg=name)


@pytest.mark.parametrize("d,dtype,out_dtype", [
    (36, torch.float32, None),
    (100, torch.bfloat16, None),
    (250, torch.bfloat16, torch.float32),
    (250, torch.float32, None),
])
def test_padded_path_matches_the_unpadded_plain_version(monkeypatch, d,
                                                        dtype, out_dtype):
    """The port's flash attention at a head_dim off the grid hands the
    kernels' wrappers q, k, v and dO zero-padded to the next multiple of 8
    and cuts o, dq, dk and dv back; that equals the plain versions of the
    kernels run at the true head_dim on the same inputs, up to the order of
    fp32 sums: 1e-5 in fp32 (FP32_FWD), and in bf16 one bf16 rounding of
    the outputs (2^-7 relative). A head_dim on the grid is not copied."""
    widths = []
    real = _kernels.flash_fwd

    def spy(q, *args, **kwargs):
        widths.append(q.shape[-1])
        return real(q, *args, **kwargs)

    monkeypatch.setattr(_kernels, "flash_fwd", spy)
    q, k, v, do = (torch.tensor(x).to(dtype)
                   for x in _inputs(2, 48, 4, 2, d, seed=9))
    o_dtype = out_dtype or dtype
    do = do.to(o_dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*leaves, causal=True,
                                      out_dtype=out_dtype)
    o.backward(do)
    assert widths == [-(-d // 8) * 8]

    scale = d ** -0.5
    ro, rlse = _kernels.flash_fwd_plain(q, k, v, scale, True, o_dtype)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, True)
    bf16 = dtype == torch.bfloat16
    want = [ro, _kernels.flash_dq_plain(*args, split_dout=bf16,
                                        round_ds=bf16),
            *_kernels.flash_dkv_plain(*args, split_dout=bf16,
                                      round_operands=bf16)]
    tol = 2.0 ** -7 if bf16 else FP32_FWD
    torch.testing.assert_close(lse, rlse.transpose(1, 2), rtol=FP32_FWD,
                               atol=FP32_FWD)
    for name, got, ref in zip(("o", "dq", "dk", "dv"),
                              [o.detach()] + [x.grad for x in leaves], want):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol, msg=name)
    x = torch.zeros(1, 2, 2, 64)
    assert _kernels.pad_head_dim(x, _kernels.padded_head_dim(64)) is x


# ---- use_flash="auto" ----------------------------------------------------

AUTO = [
    (torch.bfloat16, 64, None, True),      # the main path's
    (torch.bfloat16, 256, None, True),     # Gemma's head
    (torch.bfloat16, 64, torch.float32, True),   # the ring's blocks
    (torch.float32, 128, None, True),
    (torch.bfloat16, 264, None, True),     # the widest heads: to 384
    (torch.bfloat16, 100, None, True),     # off the 8-grid: padded
    (torch.float16, 64, None, True),       # fp16 (PR 19)
    (torch.float32, 256, None, True),      # fp32 at the wide heads
    (torch.bfloat16, 256, torch.float32, True),  # the ring's at 256
    (torch.float32, 200, None, True),
    (torch.float32, 264, None, False),
    (torch.float16, 256, None, True),      # fp16 at Gemma's head
    (torch.bfloat16, 264, torch.float32, False),
    (torch.float16, 100, None, True),      # fp16 off the 8-grid: padded
    (torch.float32, 4, None, True),
    (torch.float16, 512, None, True),      # fp16 at the widest heads
    (torch.bfloat16, 520, None, False),    # past 512
    (torch.float16, 300, torch.float32, False),  # the ring's past 256
]


@pytest.mark.parametrize("dtype,d,out_dtype,flash", AUTO)
def test_auto_takes_the_kernels_only_where_they_take_the_shape(
        dtype, d, out_dtype, flash):
    """From sequence 256 "auto" picks the kernels exactly where all three
    tensor-core kernels take q's dtype and head_dim with o's dtype, and the
    einsum path elsewhere; below 256 the einsum path; True and False stay
    what they say."""
    assert resolve_flash("auto", 256, dtype, d, out_dtype) is flash
    assert resolve_flash("auto", 1 << 16, dtype, d, out_dtype) is flash
    assert resolve_flash("auto", 255, dtype, d, out_dtype) is False
    assert resolve_flash(True, 8, dtype, d, out_dtype) is True
    assert resolve_flash(False, 1 << 16, dtype, d, out_dtype) is False


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (which still runs)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("dtype,d,flash", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 256, True),
    (torch.bfloat16, 264, True),
    (torch.float32, 256, True),
    (torch.float32, 264, False),
    (torch.bfloat16, 520, False),
])
def test_the_model_follows_auto(monkeypatch, dtype, d, flash):
    """models/transformer.py's attention with use_flash="auto" at sequence
    256 (one head, one K/V head) calls the flash kernels where "auto" takes
    them, else runs its einsum path."""
    calls = _spy(monkeypatch, transformer, "flash_attention")
    cfg = GPTConfig(vocab_size=16, n_layers=1, d_model=d, n_heads=1,
                    d_ff=16, max_seq_len=256, dtype=dtype, use_flash="auto")
    attn = Attention(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(1, 256, d, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = attn(x.to(dtype), torch.arange(256))
    assert out.shape == (1, 256, d) and torch.isfinite(out.float()).all()
    assert calls == (["flash_attention"] if flash else [])


class _OneMember:
    """A process set of one member: the ring's and Ulysses' arithmetic with
    no peer."""

    def size(self):
        return 1

    def rank_in_set(self, rank):
        return 0


@pytest.mark.parametrize("dtype,d,ring_flash,ulysses_flash", [
    (torch.bfloat16, 64, True, True),
    (torch.bfloat16, 256, True, True),     # the ring's fp32 o at 256
    (torch.bfloat16, 264, False, True),    # the ring's fp32 o stops at 256
    (torch.bfloat16, 520, False, False),
    (torch.float16, 64, True, True),       # fp16: the ring's fp32 o too
    (torch.bfloat16, 100, True, True),     # off the 8-grid: padded
    (torch.float32, 200, True, True),      # fp32 at the wide heads
    (torch.float32, 264, False, False),
])
def test_the_sequence_paths_follow_auto(monkeypatch, dtype, d, ring_flash,
                                        ulysses_flash):
    """parallel/sequence.py with use_flash="auto" on a 256-position shard:
    ring attention's blocks (bf16 q with an fp32 o, up to head_dim 256)
    and Ulysses' local attention (o in q's dtype, up to 512) take the flash
    kernels where "auto" takes them, else the einsum blocks."""
    monkeypatch.setattr(sequence.basics, "rank", lambda: 0)
    blocks = _spy(monkeypatch, sequence, "flash_ring_block")
    local = _spy(monkeypatch, sequence, "flash_attention")
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 256, 1, d, generator=gen).to(dtype)
               for _ in range(3))
    ring = sequence.ring_attention_shard(q, k, v, process_set=_OneMember(),
                                         use_flash="auto")
    ulysses = sequence.ulysses_attention_shard(
        q, k, v, process_set=_OneMember(), use_flash="auto")
    for out in (ring, ulysses):
        assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert blocks == (["flash_ring_block"] if ring_flash else [])
    assert local == (["flash_attention"] if ulysses_flash else [])
