"""horovod_tpu_torch's Hopper kernels on the card, held against their plain
PyTorch versions. Every test here needs a CUDA device and skips without one.

This file (and tests/torch_port_gang.py, which its NCCL gang test runs)
imports nothing of JAX, so it also runs where JAX is missing; the
repo's conftest imports JAX, so on such a machine run it as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 1e-5 (the same fp32 arithmetic summed in another order;
the sm90 kernels take fp32 as 3xTF32, within about 2^-21 of fp32
products); bf16 2e-2, about two bf16 ulps at the outputs' magnitude; fp16
5e-3, about five fp16 ulps (fp16 keeps 3 bits more than bf16). The sm90
kernels on bf16 and fp16 are held to the plain versions that round their
operands where the tensor cores take them in q's dtype: dkv's p and ds
(``round_operands=True``), dq's ds (``round_ds=True``), each with an fp32
dO carried as two terms (``split_dout=True``), and on fp16 with dO's scale
(``_kernels.dout_scale``).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                   flash_attention_with_lse)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
# no wire codec kernel runs where no lossy wire codec is set
NO_CODEC = {k: 0 for k in _kernels.CODEC_KERNELS}

# (B, S, H, H_kv, D, dtype, causal, out_dtype)
CASES = [
    (2, 100, 4, 2, 32, torch.float32, True, torch.float32),      # ragged, GQA
    (2, 256, 4, 4, 64, torch.bfloat16, False, torch.bfloat16),
    (1, 300, 4, 1, 128, torch.bfloat16, True, torch.bfloat16),   # MQA, D 128
    (2, 130, 2, 2, 8, torch.float32, False, torch.float32),      # smallest D
    (2, 192, 4, 2, 64, torch.bfloat16, True, torch.float32),     # fp32 o
    (2, 100, 4, 2, 64, torch.bfloat16, True, torch.bfloat16),    # ragged, GQA
    # the tensor-core fwd and dkv at fp32 (3xTF32) and at bf16 D 32 / 96
    (2, 1000, 4, 2, 32, torch.float32, True, torch.float32),     # ragged, GQA
    (2, 256, 4, 4, 64, torch.float32, False, torch.float32),
    (1, 300, 4, 1, 96, torch.float32, True, torch.float32),      # MQA, D 96
    (2, 192, 2, 2, 128, torch.float32, True, torch.float32),
    (2, 1000, 4, 2, 32, torch.bfloat16, True, torch.bfloat16),   # ragged, GQA
    (2, 256, 4, 4, 32, torch.bfloat16, False, torch.float32),    # fp32 o
    (1, 300, 8, 2, 96, torch.bfloat16, True, torch.bfloat16),    # GQA, D 96
    (2, 1000, 2, 2, 96, torch.bfloat16, False, torch.bfloat16),  # ragged
    (2, 130, 4, 2, 48, torch.bfloat16, True, torch.bfloat16),    # padded
    # every kernel at every head_dim: padded widths, fp32 dO with bf16 q
    (2, 200, 4, 2, 48, torch.float32, True, torch.float32),      # padded
    (1, 300, 4, 1, 80, torch.bfloat16, False, torch.bfloat16),   # MQA, D 80
    (2, 130, 2, 2, 8, torch.bfloat16, True, torch.bfloat16),     # smallest D
    (2, 256, 4, 2, 96, torch.bfloat16, True, torch.float32),     # fp32 dO
    # head_dims off the kernels' grid of 8, zero-padded by the wrappers
    (2, 130, 4, 2, 36, torch.float32, True, torch.float32),      # to 40
    (2, 200, 4, 4, 4, torch.bfloat16, True, torch.bfloat16),     # to 8
    (1, 300, 8, 2, 100, torch.bfloat16, False, torch.bfloat16),  # to 104
]
# the wide heads, head_dim 136..256, which only the tensor-core kernels
# take: their padded widths 192 and 256, D fixed at 192 and 256 and at run
# time between; bf16 q with o and dO in bf16, or in fp32 as the sequence
# ring has them, and fp32 q (3xTF32)
WIDE_CASES = [
    (2, 300, 4, 1, 256, torch.bfloat16, True, torch.bfloat16),   # MQA
    (2, 256, 3, 3, 192, torch.bfloat16, False, torch.bfloat16),
    (1, 200, 2, 2, 200, torch.bfloat16, True, torch.bfloat16),   # to 256
    (2, 130, 4, 2, 136, torch.bfloat16, True, torch.bfloat16),   # to 192
    (2, 300, 4, 1, 256, torch.bfloat16, True, torch.float32),    # MQA
    (2, 256, 3, 3, 192, torch.bfloat16, False, torch.float32),
    (1, 200, 8, 1, 250, torch.bfloat16, True, torch.float32),    # to 256
    (2, 130, 4, 2, 136, torch.bfloat16, True, torch.float32),    # to 192
    (2, 300, 4, 1, 256, torch.float32, True, torch.float32),     # MQA
    (2, 256, 3, 3, 192, torch.float32, False, torch.float32),
    (1, 200, 2, 2, 200, torch.float32, True, torch.float32),     # to 256
    (2, 130, 4, 2, 136, torch.float32, True, torch.float32),     # to 192
]
# fp16 q, which only the tensor-core kernels take: every padded width (64,
# 128, 192, 256), D fixed and at run time, with o and dO in fp16 or in fp32
# (the sequence ring's)
F16 = torch.float16
FP16_CASES = [
    (2, 256, 4, 4, 64, F16, False, F16),
    (2, 100, 4, 2, 32, F16, True, F16),        # ragged, GQA, padded to 64
    (1, 300, 4, 1, 128, F16, True, F16),       # MQA, D 128
    (1, 300, 8, 2, 96, F16, True, F16),        # GQA, padded to 128
    (1, 300, 8, 2, 100, F16, False, F16),      # to 104, padded to 128
    (2, 300, 4, 1, 256, F16, True, F16),       # MQA
    (2, 256, 3, 3, 192, F16, False, F16),
    (1, 200, 2, 2, 200, F16, True, F16),       # to 256
    (2, 130, 4, 2, 136, F16, True, F16),       # to 192
    (2, 192, 4, 2, 64, F16, True, torch.float32),
    (2, 256, 4, 2, 96, F16, True, torch.float32),
    (2, 300, 4, 1, 256, F16, True, torch.float32),
    (2, 256, 3, 3, 192, F16, False, torch.float32),
    (1, 200, 8, 1, 250, F16, True, torch.float32),   # to 256
    (2, 130, 4, 2, 136, F16, True, torch.float32),   # to 192
]
# the widest heads, head_dim 264..512, bf16 and fp16 q with o and dO in q's
# dtype: padded widths 384 and 512, D fixed at 384 and 512 and at run time
# between, causal and not, GQA and MQA, and one head_dim off the grid of 8
BF = torch.bfloat16
XWIDE_CASES = [
    (c[0], c[1], c[2], c[3], c[4], dtype, c[5], dtype)
    for dtype in (BF, F16) for c in (
        (2, 300, 4, 1, 512, True),      # MQA
        (2, 256, 3, 3, 384, False),
        (1, 200, 2, 2, 400, True),      # to 512
        (2, 130, 4, 2, 264, True),      # GQA, to 384
        (1, 200, 8, 1, 512, False),     # MQA
        (1, 150, 4, 2, 300, False),     # to 304, then 384
    )]
# every case on the SIMT kernels, and on each kernel's own route (None:
# _variant's choice) where that reaches a tensor-core kernel; the wide heads
# and fp16 on their route only
VARIANT_CASES = [(c, "simt") for c in CASES] + [
    (c, None) for c in CASES + WIDE_CASES + FP16_CASES + XWIDE_CASES
    if any(_kernels._variant(base, c[5], c[4], c[7]) == "sm90"
           for base in ("flash_fwd", "flash_dq", "flash_dkv"))]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device):
    b, s, h, h_kv, d, dtype, _, out_dtype = case
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=device).to(dtype)
               for n in (h, h_kv, h_kv))
    do = torch.randn(b, s, h, d, generator=gen, device=device).to(out_dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case,variant", VARIANT_CASES,
                         ids=lambda c: "-".join(map(str, c[:6]))
                         if isinstance(c, tuple) else str(c or "route"))
def test_kernels_match_plain_versions(cuda, case, variant):
    q, k, v, do = _inputs(case, cuda)
    causal, out_dtype, tol = case[6], case[7], TOL[case[5]]
    scale = q.shape[-1] ** -0.5
    names = {base: _kernels._kernel(base, q, variant)
             for base in ("flash_fwd", "flash_dq", "flash_dkv")}
    before = dict(_kernels.LAUNCHES)
    o, lse = _kernels.flash_fwd(q, k, v, scale, causal, out_dtype,
                                variant=variant)
    ro, rl = _kernels.flash_fwd_plain(q, k, v, scale, causal, out_dtype)
    assert o.dtype == out_dtype
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-5)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    two_byte = q.dtype in (torch.bfloat16, torch.float16)
    dq = _kernels.flash_dq(*args, variant=variant)
    assert dq.dtype == q.dtype
    dq_rounds = two_byte and names["flash_dq"].endswith("_sm90")
    torch.testing.assert_close(
        dq.float(),
        _kernels.flash_dq_plain(*args, split_dout=dq_rounds,
                                round_ds=dq_rounds).float(),
        rtol=tol, atol=tol)
    dkv_rounds = two_byte and names["flash_dkv"].endswith("_sm90")
    for got, want in zip(_kernels.flash_dkv(*args, variant=variant),
                         _kernels.flash_dkv_plain(
                             *args, split_dout=dkv_rounds,
                             round_operands=dkv_rounds)):
        assert got.shape == k.shape and got.dtype == k.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    want_launches = {n: 0 for n in before}
    want_launches.update({n: 1 for n in names.values()})
    assert {n: _kernels.LAUNCHES[n] - before[n] for n in before} == \
        want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", XWIDE_CASES,
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_widest_heads_dq_gives_the_same_bits_every_run(cuda, case):
    """dq at head_dim 264..512 keeps its one owner (each warpgroup its
    column half, no atomics): a second launch on the same inputs gives the
    same bits."""
    q, k, v, do = _inputs(case, cuda)
    scale = q.shape[-1] ** -0.5
    o, lse = _kernels.flash_fwd(q, k, v, scale, case[6], case[7])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, case[6])
    assert torch.equal(_kernels.flash_dq(*args), _kernels.flash_dq(*args))


# bf16 or fp16 q with an fp32 o, and so an fp32 dO: the sequence ring's
# blocks
FP32_DOUT_CASES = [c for c in CASES + WIDE_CASES + FP16_CASES
                   if c[5] in (torch.bfloat16, F16) and c[7] == torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FP32_DOUT_CASES,
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_dq_with_fp32_dout_keeps_its_lo_term(cuda, case):
    """flash_dq_sm90 with bf16 or fp16 q splits an fp32 dO into two terms
    of q's dtype. A kernel that dropped the lo term would still pass the
    kernels test's tolerance, so its dq must lie nearer the plain version
    that takes both terms than the one that rounds dO to one: at most half
    as far, in the Frobenius norm."""
    q, k, v, do = _inputs(case, cuda)
    causal = case[6]
    scale = q.shape[-1] ** -0.5
    o, lse = _kernels.flash_fwd_plain(q, k, v, scale, causal, torch.float32)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    assert _kernels._kernel("flash_dq", q, None) == "flash_dq_sm90"
    dq = _kernels.flash_dq(*args).float()
    two = _kernels.flash_dq_plain(*args, split_dout=True, round_ds=True)
    one = _kernels.flash_dq_plain(q, k, v, do.to(q.dtype), lse, delta,
                                  scale, causal, round_ds=True)
    near = float((dq - two.float()).norm())
    far = float((dq - one.float()).norm())
    print(f"dq with fp32 dO {case[:7]}: {near:.4g} from two terms, "
          f"{far:.4g} from one")
    assert near < 0.5 * far


@pytest.mark.cuda
@pytest.mark.parametrize("case", FP32_DOUT_CASES,
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_dkv_with_fp32_dout_keeps_its_lo_term(cuda, case):
    """flash_dkv_sm90 with bf16 or fp16 q splits an fp32 dO into two terms
    of q's dtype for both products that read it (dP^T and dV). A kernel
    that dropped the lo term would still pass the kernels test's
    tolerance, so its dk and dv must each lie nearer the plain version that
    takes both terms than the one that rounds dO to one: at most half as
    far, in the Frobenius norm."""
    q, k, v, do = _inputs(case, cuda)
    causal = case[6]
    scale = q.shape[-1] ** -0.5
    o, lse = _kernels.flash_fwd_plain(q, k, v, scale, causal, torch.float32)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    assert _kernels._kernel("flash_dkv", q, None) == "flash_dkv_sm90"
    got = _kernels.flash_dkv(*args)
    two = _kernels.flash_dkv_plain(*args, split_dout=True,
                                   round_operands=True)
    one = _kernels.flash_dkv_plain(q, k, v, do.to(q.dtype), lse,
                                   delta, scale, causal, round_operands=True)
    for name, g, t, o1 in zip(("dk", "dv"), got, two, one):
        near = float((g.float() - t.float()).norm())
        far = float((g.float() - o1.float()).norm())
        print(f"{name} with fp32 dO {case[:7]}: {near:.4g} from two terms, "
              f"{far:.4g} from one")
        assert near < 0.5 * far, name


# dO scaled by these: the ring's blocks with fp16 q and an fp32 dO
DOUT_MAGNITUDES = (2.0 ** -20, 1.0, 2.0 ** 12)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in FP16_CASES
                                  if c[7] == torch.float32],
                         ids=lambda c: "-".join(map(str, c[:7])))
def test_fp16_ring_blocks_keep_their_precision_at_any_dout_magnitude(cuda,
                                                                     case):
    """fp16 q with an fp32 dO (the sequence ring's blocks) at dO times
    2^-20, 1 and 2^12: dq, dk and dv against the plain version that keeps
    every operand fp32. The kernels scale dO by a power of two from its
    largest magnitude before they round anything derived from it to fp16,
    so each output's error relative to its largest magnitude stays within
    twice its error at magnitude 1, plus one step of fp16's subnormal grid
    (2^-24) relative to that magnitude: the fp16 output's own resolution,
    which the plain version's fp16 output has too (at 2^-20 a gradient of
    these inputs is a few such steps). Nothing is inf or NaN where the plain
    version's output is finite."""
    q, k, v, do = _inputs(case, cuda)
    causal = case[6]
    scale = q.shape[-1] ** -0.5
    o, lse = _kernels.flash_fwd_plain(q, k, v, scale, causal, torch.float32)
    errs = {}
    for m in DOUT_MAGNITUDES:
        dom = do * m
        delta = (dom * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dom, lse, delta, scale, causal)
        got = dict(zip(("dq", "dk", "dv"),
                       (_kernels.flash_dq(*args), *_kernels.flash_dkv(*args))))
        want = dict(zip(("dq", "dk", "dv"),
                        (_kernels.flash_dq_plain(*args),
                         *_kernels.flash_dkv_plain(*args))))
        for n in got:
            g, w = got[n].float(), want[n].float()
            fin = torch.isfinite(w)
            assert bool(torch.isfinite(g[fin]).all()), (m, n)
            top = float(w[fin].abs().max())
            errs[m, n] = (float((g - w)[fin].abs().max()) / top,
                          2.0 ** -24 / top)
    for (m, n), (err, floor) in errs.items():
        print(f"fp16 ring {case[:7]} {n} at dO x {m:g}: {err:.3g} of its "
              f"largest magnitude (floor {floor:.3g})")
        assert err <= 2 * errs[1.0, n][0] + floor, (m, n, err)


@pytest.mark.cuda
def test_single_wgmma_product_matches_matmul(cuda):
    """The sm90 kernels' building blocks on one 64 x 64 x 64 product: TMA
    into 128-byte-swizzled tiles, K-major and MN-major descriptors, and an
    accumulator reused as the bf16 register A operand. bf16 products are
    exact in fp32, so only the order of the fp32 sums differs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.randn(64, 64, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    c1, c2 = _kernels.wgmma_probe(a, b)
    torch.testing.assert_close(c1, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(c2, c1.to(torch.bfloat16).float() @ b.float(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_single_fp16_wgmma_product_matches_matmul(cuda):
    """The same building blocks with fp16 operands (wgmma's .f16, the TMA
    map's FLOAT16 type, the accumulator packed to fp16 pairs as the register
    A operand): fp16 products are exact in fp32, so only the order of the
    fp32 sums differs, and c1's fp16 rounding may land one fp16 ulp from a
    reference summed in another order."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a, b = (torch.randn(64, 64, generator=gen, device=cuda)
            .to(torch.float16) for _ in range(2))
    c1, c2 = _kernels.wgmma_probe(a, b)
    torch.testing.assert_close(c1, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(c2, c1.to(torch.float16).float() @ b.float(),
                               rtol=1e-5, atol=2e-3)
    assert not torch.equal(c2, c1.to(torch.bfloat16).float() @ b.float())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [192, 256])
def test_wide_wgmma_products_match_matmul(cuda, n):
    """The wide heads' building blocks: m64n192k16 and m64n256k16, with the
    MN-major B tile over three or four 128-byte panels (the descriptor's
    stride between panels), its A operand from registers (as P V and dS K
    take it) and from shared memory (as the wide dK, dV products)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    a, b = (torch.randn(64, 64, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    w = torch.randn(64, n, generator=gen, device=cuda).to(torch.bfloat16)
    c1, c2, c3 = _kernels.wgmma_probe_wide(a, b, w)
    torch.testing.assert_close(c1, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-4)
    # c1's own bf16 rounding: a reference rounded from another sum order
    # may land one bf16 ulp away
    torch.testing.assert_close(c2, c1.to(torch.bfloat16).float() @ w.float(),
                               rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(c3, a.float() @ w.float(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CASES[:1] + [
    (1, 64, 2, 1, 264, torch.bfloat16, True, torch.bfloat16),    # past 256
    (1, 64, 2, 1, 264, torch.float32, True, torch.float32),      # past 256
    (1, 64, 2, 1, 256, torch.bfloat16, True, torch.float32),     # fp32 o
    (1, 64, 2, 1, 520, F16, True, F16),                          # past 512
    (1, 64, 2, 1, 520, torch.bfloat16, True, torch.bfloat16),    # past 512
    (1, 64, 2, 1, 264, F16, True, torch.float32),  # fp32 o past 256
], ids=lambda c: "-".join(map(str, c[4:6] + c[7:])))
def test_no_quiet_fallback_at_shapes_a_kernel_refuses(cuda, case):
    """use_flash=True at a shape no tensor-core kernel takes raises on the
    card before any launch, naming the route; the SIMT design asked for by
    name raises above head_dim 128 too."""
    q, k, v, _ = _inputs(case, cuda)
    before = dict(_kernels.LAUNCHES)
    if _kernels.sm90_takes(q.dtype, q.shape[-1], case[7]):
        with pytest.raises(ValueError, match=r"\(SIMT\) takes head_dim"):
            _kernels.flash_fwd(q, k, v, 1.0, True, case[7], variant="simt")
    else:
        with pytest.raises(ValueError, match="flash_fwd_sm90 takes"):
            flash_attention_with_lse(q, k, v, out_dtype=case[7])
    assert dict(_kernels.LAUNCHES) == before


@pytest.mark.cuda
def test_single_tf32_wgmma_product_matches_fp32_matmul(cuda):
    """The 3xTF32 building blocks on one 64 x 64 x 64 fp32 product: TMA into
    32-column fp32 panels, the hi/lo split in place, the transposed and
    permuted B tile, and an accumulator split into the hi and lo tf32
    register A operands. Held to fp64 products within 2^-18 of the sum of
    |products| of each element: 3xTF32 keeps about 2^-21 (dropped lo·lo
    terms and the lo terms' rounding), plain TF32 only 2^-11."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.randn(64, 64, generator=gen, device=cuda)
            for _ in range(2))
    c1, c2 = _kernels.wgmma_probe(a, b)
    a64, b64, c64 = a.double(), b.double(), c1.double()
    for got, want, mass in ((c1, a64 @ b64.T, a64.abs() @ b64.abs().T),
                            (c2, c64 @ b64, c64.abs() @ b64.abs())):
        err = (got.double() - want).abs()
        assert bool((err <= 2.0 ** -18 * mass + 1e-6).all()), \
            float((err / mass).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(192, 16), (192, 32), (256, 16), (256, 32)])
def test_wide_tf32_wgmma_products_match_fp32_matmul(cuda, n, r):
    """The fp32 wide heads' 3xTF32 building blocks: c1 = a b^T with a's A
    fragments loaded raw and split in registers over n / 8 k-steps
    (m64n16k8, m64n32k8: S = Q K^T and S^T = K Q^T at DP 192 and 256), c2 =
    c1 b with c1's fragment as the register A operand against b's
    transposed split (m64n192k8, m64n256k8: P V), c3 = (c1 b)^T with c1
    written as K-major B tiles and b's split tiles read transposed as A
    (m64n64k8: dQ^T, dV^T, dK^T). Each is held to fp64 products of the same
    operands within 2^-19 of the sum of |products| (the split keeps about
    2^-21) plus 2^-23 for each of the 3 K / 8 products the tensor cores add
    into one accumulator (they truncate as they accumulate)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(64, n, generator=gen, device=cuda)
    b = torch.randn(r, n, generator=gen, device=cuda)
    c1, c2, c3 = _kernels.wgmma_probe_wide(a, b)
    a64, b64, c64 = a.double(), b.double(), c1.double()
    for name, got, want, mass, k in (
            ("c1", c1, a64 @ b64.T, a64.abs() @ b64.abs().T, n),
            ("c2", c2, c64 @ b64, c64.abs() @ b64.abs(), r),
            ("c3", c3, (c64 @ b64).T, (c64.abs() @ b64.abs()).T, r)):
        tol = 2.0 ** -19 + 3 * (k // 8) * 2.0 ** -23
        ratio = float(((got.double() - want).abs() / mass).max())
        print(f"tf32 probe n {n} r {r} {name}: max |err| / mass {ratio:.3g}"
              f" (tol {tol:.3g})")
        assert got.shape == want.shape
        assert bool(((got.double() - want).abs()
                     <= tol * mass + 1e-6).all()), (name, ratio)


@pytest.mark.cuda
def test_autograd_function_matches_autograd_of_reference(cuda):
    """Gradients through o and lse, as a ring-attention combine needs."""
    q, k, v, do = _inputs((2, 200, 4, 2, 32, torch.float32, True,
                           torch.float32), cuda)
    w = torch.randn(2, 200, 4, device=cuda)
    grads = []
    for fn in (flash_attention_with_lse, flash_attention_reference):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*leaves, causal=True)
        ((o * do).sum() + (lse * w).sum()).backward()
        grads.append([o.detach(), lse.detach()] + [x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _wire_input(n, device, seed):
    """Seeded values over 16 decades with the codecs' edge cases: NaN of
    both signs, ±Inf, a zero block, a -0 block, subnormal blocks."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.logspace(-8, 8, n)).astype(np.float32)
    x[5], x[300], x[301], x[700] = np.nan, np.inf, -np.inf, -np.nan
    x[512:768], x[1280:1536] = 0.0, -0.0
    x[768:1024] = np.float32(1e-42)
    x[1024:1280] = (np.float32(1e-39) * rng.randn(256)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "int8", "fp8"])
def test_wire_codec_kernels_match_plain_versions_bit_for_bit(cuda, codec):
    """encode, decode_accumulate (both modes) and ef_roundtrip (with and
    without a residual) against their plain versions on the same CUDA
    tensors, at tails of 1 and 255 elements and a whole number of
    blocks."""
    from horovod_tpu_torch.compression import codecs as W

    for n in (256 * 8 + 1, 256 * 8 + 255, 256 * 16):
        x = _wire_input(n, cuda, seed=n)
        before = dict(_kernels.LAUNCHES)
        stream = W.encode(x, codec)
        assert torch.equal(stream, W.encode_plain(x, codec))
        assert stream.numel() == W.wire_bytes(codec, n)
        dec = W.decode_accumulate(stream, codec, n)
        want = W.decode_accumulate_plain(stream, codec, n,
                                         torch.empty_like(x))
        assert _same_bits(dec, want)
        base = torch.randn(n, device=cuda)
        acc = W.decode_accumulate(stream, codec, n, out=base.clone(),
                                  accumulate=True)
        assert _same_bits(acc, base + want)
        seg, r = torch.randn(n, device=cuda) * 3, \
            torch.randn(n, device=cuda) * 0.01
        seg[7] = float("nan")
        s1, r1 = seg.clone(), r.clone()
        W.ef_roundtrip(s1, codec, r1)
        s2, r2 = seg.clone(), r.clone()
        W.ef_roundtrip_plain(s2, codec, r2)
        assert _same_bits(s1, s2) and _same_bits(r1, r2)
        assert _same_bits(W.ef_roundtrip(x.clone(), codec),
                          W.roundtrip_plain(x, codec))
        got = {k: _kernels.LAUNCHES[k] - before[k] for k in before
               if _kernels.LAUNCHES[k] != before[k]}
        assert got == {f"wire_encode_{codec}": 1,
                       f"wire_decode_accumulate_{codec}": 2,
                       f"wire_ef_roundtrip_{codec}": 2}


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda):
    """What the tensor-core kernels still refuse raises ValueError naming
    the routes, before any launch: head_dims above 512 (bf16 and fp16 q with
    an o in q's dtype), above 256 with the ring's fp32 o or fp32 q."""
    before = dict(_kernels.LAUNCHES)
    for d, dtype, out_dtype in ((264, torch.float32, torch.float32),
                                (520, torch.float16, torch.float16),
                                (264, torch.float16, torch.float32),
                                (520, torch.bfloat16, torch.bfloat16),
                                (264, torch.bfloat16, torch.float32)):
        q = torch.zeros(1, 16, 2, d, device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="flash_fwd_sm90 takes "
                                             "bfloat16 q with head_dim"):
            _kernels.flash_fwd(q, q, q, 1.0, True, out_dtype)
    assert dict(_kernels.LAUNCHES) == before


DP_WORKER = r"""
import json, sys
import torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch.train import gpt_config, train

device, steps, batch, out = json.loads(sys.argv[1])
cfg = gpt_config("entry", dtype=torch.float32, use_flash=True)
torch.backends.cuda.matmul.allow_tf32 = False
res = train(cfg, steps, batch, 32, device=device, lr=1e-3)
if hvt.rank() == 0:
    torch.save({k: v.cpu() for k, v in res["model"].state_dict().items()},
               out + ".pt")
with open(out + f".{hvt.rank()}.json", "w") as f:
    json.dump({"rank": hvt.rank(), "size": hvt.size(),
               "device": str(hvt.device()), "loss": res["loss"]}, f)
hvt.shutdown()
"""


def run_dp_gang(n, device, steps, batch, out):
    """Start ``n`` processes of DP_WORKER through the hvtrun identity env;
    return (per-rank results, rank 0's final state_dict)."""
    import json
    import os
    import sys

    _wait_gang(_start_gang(n, [sys.executable, "-c", DP_WORKER,
                               json.dumps([device, steps, batch, out])],
                           "dp", os.path.dirname(out)), timeout=300)
    results = []
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            results.append(json.load(f))
    return results, torch.load(out + ".pt")


@pytest.mark.cuda
def test_nccl_dp_step_equals_the_one_process_step(cuda, tmp_path):
    """Each of n ranks (one per card, NCCL) takes a slice of the global
    batch; the averaged gradients make the same two AdamW steps as one
    process on the whole batch. Tolerances as in test_torch_port_train.py."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.train import gpt_config, train

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    steps, batch = 2, 2
    results, dp_state = run_dp_gang(n, "cuda", steps, batch,
                                    str(tmp_path / "dp"))
    assert [r["rank"] for r in results] == list(range(n))
    assert [r["device"] for r in results] == [f"cuda:{r}" for r in range(n)]
    try:
        one = train(gpt_config("entry", dtype=torch.float32, use_flash=True),
                    steps, n * batch, 32, lr=1e-3)
    finally:
        basics.shutdown()
    dp_loss = torch.tensor([r["loss"] for r in results]).mean(0)
    torch.testing.assert_close(dp_loss, torch.tensor(one["loss"]),
                               rtol=1e-4, atol=1e-5)
    for name, want in one["model"].state_dict().items():
        torch.testing.assert_close(dp_state[name], want.cpu(), rtol=1e-3,
                                   atol=1e-4, msg=name)


@pytest.mark.cuda
def test_nccl_collectives_and_accumulation_match_numpy(cuda, tmp_path):
    """On n >= 2 cards (NCCL), the gang of tests/torch_port_gang.py: every
    collective of the port held against numpy (fp32 rtol 1e-5, integers,
    bf16 small integers and data movement exact), and its accumulation step
    (two passes of one row per rank and update, averaged) against one
    process on the whole batch, at the tolerances of
    test_torch_port_train.py. Ranks are host-major with local size 2 when
    n is even, so the hierarchical groups have two levels."""
    import torch_port_gang as G
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import GPTConfig
    from horovod_tpu_torch.train import train

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    local = 2 if n % 2 == 0 else n
    out = str(tmp_path / "gang")
    results = G.run_gang(n, local, "cuda", out, timeout=600)
    assert not G.mismatches(results, n, local)
    try:
        one = train(GPTConfig(**G.ENTRY, dtype=torch.float32),
                    G.ACC_UPDATES, n * G.ACC_ROWS, G.ACC_SEQ, lr=1e-3)
    finally:
        basics.shutdown()
    losses = torch.tensor([r["acc_losses"] for r in results]).mean((0, 2))
    torch.testing.assert_close(losses, torch.tensor(one["loss"]),
                               rtol=1e-4, atol=1e-5)
    acc_state = torch.load(out + ".acc.pt")
    for name, want in one["model"].state_dict().items():
        torch.testing.assert_close(acc_state[name], want.cpu(), rtol=1e-3,
                                   atol=1e-4, msg=name)


LOSS_RTOL = 1e-2      # chip_smoke.py's: about 2.5 bf16 epsilons


@pytest.mark.cuda
def test_nccl_dryrun_and_full_width_sp_tp_step(cuda, tmp_path):
    """On four cards (NCCL, two fake hosts of two cards), the gang of
    tests/torch_port_parallel_gang.py runs ``dryrun_multichip`` at the
    entry and bench configs (each asserts its own tolerances: the JAX
    function's in fp32, the main path's 1e-2 on the bf16 losses), then seven
    steps of the full-width GPT (bench.py --model gpt --flash) at dp 1 ×
    sp 2 × tp 2 with ring flash attention, whose losses must be within
    LOSS_RTOL of the one-card main path's from the same weights and
    batch at steps 1 and 7, and Ulysses at sp 4 with the flash kernels
    against flash attention of the whole sequence (o within 2e-2, the
    gradients of sum(o**2) within 5e-2: chip_smoke.py's bf16 tolerances).
    Prints per-card step time, peak memory, launches and a profile of two
    steps as one JSON line (run with -s)."""
    import json
    import statistics
    import subprocess

    import torch_port_parallel_gang as PG
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.train import gpt_config, train

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    gang = PG.Gang("cuda", str(tmp_path / "par"), n=4, device="cuda",
                   timeout=600)
    results = gang.results()
    try:
        one = train(gpt_config("bench", use_flash=True), PG.FULL_STEPS,
                    PG.FULL_BATCH, 1024, seed=0)
    finally:
        basics.shutdown()
    summary = {"one_card": {"losses": one["loss"], "step_ms_median":
                            statistics.median(one["step_s"][2:]) * 1e3},
               "ranks": []}
    for r in results:
        full = r["full"]
        rel = [abs(a - b) / abs(b) for a, b in zip(full["losses"],
                                                    one["loss"])]
        assert rel[0] <= LOSS_RTOL and rel[-1] <= LOSS_RTOL, (
            full["losses"], one["loss"])
        # a causal ring of two shards: shard 0 attends one block a layer,
        # shard 1 two; no SIMT kernel runs at bf16, D 64
        blocks = 12 * (full["coords"]["sp"] + 1) * PG.FULL_STEPS
        assert full["launches"] == {
            "flash_fwd_sm90": blocks, "flash_dq_sm90": blocks,
            "flash_dkv_sm90": blocks, "flash_fwd": 0, "flash_dq": 0,
            "flash_dkv": 0, **NO_CODEC}
        need = r["ulysses_least_tol"]
        assert need[0] <= 2e-2 and max(need[1:]) <= 5e-2, need
        summary["ranks"].append({
            "coords": full["coords"], "device": full["device"],
            "losses": full["losses"], "rel_diff": rel,
            "step_ms_median": statistics.median(full["step_s"][2:]) * 1e3,
            "step_s": full["step_s"],
            "max_memory_allocated_bytes": full["max_memory_allocated_bytes"],
            "launches": full["launches"], "profile": full["profile"],
            "ulysses_least_tol": need,
            **{k: {f: r[k].get(f) for f in ("losses", "ref_losses",
                                            "loss_max_abs_diff",
                                            "param_max_abs_diff",
                                            "seconds")}
               for k in ("dryrun_entry", "dryrun_bench")}})
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("PARALLEL4 " + json.dumps(summary))


@pytest.mark.cuda
def test_nccl_ring_wide_head_on_four_cards(cuda, tmp_path):
    """On four cards (NCCL, two fake hosts of two cards), the gang of
    tests/torch_port_parallel_gang.py trains chip_smoke.py's wide_head GPT
    (Gemma-2B's attention widths: 8 heads of 256, one K/V head) at sp 4
    with ring attention, seven steps with use_flash="auto" and seven with
    the einsum ring blocks from the same weights and batch: the losses
    within 1e-2 (LOSS_RTOL) at steps 1 and 7 on every card. A causal ring
    of four shards: shard i attends i + 1 blocks a layer, each through the
    fp32-o instances of the three sm90 kernels; the einsum run launches
    nothing. Prints per-card step times, peak memory and launches as one
    RINGWIDE4 JSON line (run with -s)."""
    import json
    import statistics
    import subprocess

    import torch_port_parallel_gang as PG

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    gang = PG.Gang("ringwide", str(tmp_path / "ringwide"), n=4,
                   device="cuda", timeout=600)
    summary = {"ranks": []}
    for r in gang.results():
        flash, einsum = r["ringwide_flash"], r["ringwide_einsum"]
        rel = [abs(a - b) / abs(b) for a, b in zip(flash["losses"],
                                                    einsum["losses"])]
        assert rel[0] <= LOSS_RTOL and rel[-1] <= LOSS_RTOL, (
            flash["losses"], einsum["losses"])
        blocks = 4 * (flash["coords"]["sp"] + 1) * PG.RINGWIDE_STEPS
        assert flash["launches"] == {
            "flash_fwd_sm90": blocks, "flash_dq_sm90": blocks,
            "flash_dkv_sm90": blocks, "flash_fwd": 0, "flash_dq": 0,
            "flash_dkv": 0, **NO_CODEC}
        assert not any(einsum["launches"].values()), einsum["launches"]
        summary["ranks"].append({
            "coords": flash["coords"], "device": flash["device"],
            "losses": flash["losses"], "einsum_losses": einsum["losses"],
            "rel_diff": rel, "launches": flash["launches"],
            **{f"{name}_step_ms_median":
               statistics.median(run["step_s"][2:]) * 1e3
               for name, run in (("flash", flash), ("einsum", einsum))},
            "flash_step_s": flash["step_s"], "einsum_step_s": einsum["step_s"],
            **{f"{name}_max_memory_allocated_bytes":
               run["max_memory_allocated_bytes"]
               for name, run in (("flash", flash), ("einsum", einsum))}})
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("RINGWIDE4 " + json.dumps(summary))


def _start_gang(n, argv, tag, out_dir):
    """Start ``n`` processes of ``argv`` (one per card, NCCL) through the
    hvtrun identity env, each writing its output to a log file; return the
    (process, log path) pairs."""
    import os
    import socket
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=repo, HVT_PROCESS_ID=str(r),
                   HVT_NUM_PROCESSES=str(n), HVT_LOCAL_PROCESS_ID=str(r),
                   HVT_LOCAL_SIZE=str(n), HVT_CROSS_RANK="0",
                   HVT_CROSS_SIZE="1",
                   HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}")
        log = os.path.join(out_dir, f"{tag}.{r}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(argv, env=env, cwd=repo,
                                           stdout=f,
                                           stderr=subprocess.STDOUT), log))
    return procs


def _wait_gang(procs, timeout):
    """Wait for every process; fail with its log if one failed. Returns
    each rank's output."""
    import subprocess

    logs = []
    try:
        for p, log in procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass
            with open(log) as f:
                logs.append(f.read())
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


SCALING_CARDS = (1, 2, 4)


@pytest.mark.cuda
def test_nccl_resnet50_scaling_efficiency(cuda, tmp_path):
    """The benchmark harness (python -m horovod_tpu_torch.bench --model
    resnet50: batch 256 a card, 224x224, bf16, TpuBatchNorm over the world)
    on 1, 2 and 4 cards, one process a card: img/s per card and the
    scaling efficiency against one card, BASELINE.md's metric of record.
    Every record must be a measurement (not suspect) of finite losses.
    Prints one SCALING4 JSON line (run with -s)."""
    import json
    import subprocess
    import sys

    if torch.cuda.device_count() < max(SCALING_CARDS):
        pytest.skip(f"needs {max(SCALING_CARDS)} CUDA devices")
    argv = [sys.executable, "-m", "horovod_tpu_torch.bench", "--model",
            "resnet50", "--num-iters", "3", "--num-batches-per-iter", "4"]
    records = {}
    for n in SCALING_CARDS:
        logs = _wait_gang(_start_gang(n, argv, f"resnet50x{n}",
                                      str(tmp_path)), timeout=600)
        record = json.loads([line for line in logs[0].splitlines()
                             if line.startswith('{"metric"')][-1])
        assert record["config"]["chips"] == n and not record["suspect"]
        assert all(np.isfinite(record["eager"]["losses"]))
        records[n] = record
    one = records[1]["value"]
    summary = {"img_per_s_per_card": {n: r["value"]
                                      for n, r in records.items()},
               "efficiency": {n: r["value"] / one
                              for n, r in records.items()},
               "step_ms_median": {n: r["eager"]["step_ms_median"]
                                  for n, r in records.items()},
               "max_memory_allocated_bytes": {
                   n: r["eager"]["max_memory_allocated_bytes"]
                   for n, r in records.items()},
               "mfu_vs_peak": {n: r["mfu_vs_peak"]
                               for n, r in records.items()},
               "calib_tflops": {n: r["calib_tflops"]
                                for n, r in records.items()},
               "losses": {n: r["eager"]["losses"]
                          for n, r in records.items()},
               "nvidia_smi": subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True, timeout=60).stdout.strip().splitlines()}
    print("SCALING4 " + json.dumps(summary))


SYNC_BN_SHAPE = (8, 16, 14, 14)
SYNC_BN_WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch.models.normalization import TpuBatchNorm
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

shape, out = json.loads(sys.argv[1])
hvt.init()
r, n = hvt.rank(), hvt.size()
rs = np.random.RandomState(21)
x_all = (rs.normal(size=shape) * 2 + 1).astype(np.float32)
w_all = rs.normal(size=shape).astype(np.float32)
rows = slice(r * shape[0] // n, (r + 1) * shape[0] // n)
res = {}
for name in ("sync", "tpu"):
    bn = (SyncBatchNorm(shape[1]) if name == "sync" else
          TpuBatchNorm(shape[1], process_set=hvt.global_process_set)).cuda()
    x = torch.from_numpy(x_all[rows]).cuda().requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(w_all[rows]).cuda()).sum().backward()
    res[name] = {"y": y.tolist(), "dx": x.grad.tolist(),
                 "dweight": bn.weight.grad.tolist(),
                 "dbias": bn.bias.grad.tolist(),
                 "running_mean": bn.running_mean.tolist(),
                 "running_var": bn.running_var.tolist()}
with open(f"{out}.{r}.json", "w") as f:
    json.dump(res, f)
hvt.shutdown()
"""


def _batch_norm_np(x, w, momentum, unbiased, eps=1e-5):
    """Training batch norm over dim 1 in float64 numpy, with scale 1 and
    bias 0, from running stats (0, 1): (y, dx, dweight, dbias,
    running_mean, running_var) for the cotangent ``w``; ``momentum`` is
    the weight of the batch, the running variance unbiased or not."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    axes = (0, 2, 3)
    count = x.size // x.shape[1]
    mean = x.mean(axes, keepdims=True)
    var = x.var(axes, keepdims=True)
    xhat = (x - mean) / np.sqrt(var + eps)
    dx = ((w - w.mean(axes, keepdims=True)
           - xhat * (w * xhat).mean(axes, keepdims=True))
          / np.sqrt(var + eps))
    batch_var = var.ravel() * (count / (count - 1) if unbiased else 1.0)
    return (xhat, dx, (w * xhat).sum(axes), w.sum(axes),
            momentum * mean.ravel(),
            (1 - momentum) + momentum * batch_var)


@pytest.mark.cuda
def test_nccl_synced_batch_norm_equals_one_card(cuda, tmp_path):
    """SyncBatchNorm and TpuBatchNorm over the world on every card (NCCL):
    each card's output and input gradient are its rows of the whole
    batch's, the cards' weight and bias gradients sum to the whole batch's,
    and the running statistics are the whole batch's, against float64
    numpy; so are one card's over the whole batch. fp32 on the card, tol
    1e-4."""
    import json
    import sys

    from horovod_tpu_torch.models.normalization import TpuBatchNorm
    from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    out = str(tmp_path / "syncbn")
    _wait_gang(_start_gang(n, [sys.executable, "-c", SYNC_BN_WORKER,
                               json.dumps([SYNC_BN_SHAPE, out])], "syncbn",
                           str(tmp_path)), timeout=300)
    rs = np.random.RandomState(21)
    x_all = (rs.normal(size=SYNC_BN_SHAPE) * 2 + 1).astype(np.float32)
    w_all = rs.normal(size=SYNC_BN_SHAPE).astype(np.float32)
    want = {"sync": _batch_norm_np(x_all, w_all, 0.1, unbiased=True),
            "tpu": _batch_norm_np(x_all, w_all, 0.1, unbiased=False)}
    keys = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
    tol = dict(rtol=1e-4, atol=1e-4)
    shard = SYNC_BN_SHAPE[0] // n
    dsum = {name: [0.0, 0.0] for name in want}
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            got = json.load(f)
        rows = slice(r * shard, (r + 1) * shard)
        for name, ref in want.items():
            for key, w in zip(keys, ref):
                if key in ("y", "dx"):
                    w = w[rows]
                if key in ("dweight", "dbias"):
                    dsum[name][key == "dbias"] += np.asarray(got[name][key])
                    continue
                np.testing.assert_allclose(got[name][key], w,
                                           err_msg=f"{name} {key} rank {r}",
                                           **tol)
    for name, ref in want.items():
        np.testing.assert_allclose(dsum[name][0], ref[2], **tol)
        np.testing.assert_allclose(dsum[name][1], ref[3], **tol)
    # one card, the whole batch (a world of one: local statistics)
    for name, ref in want.items():
        bn = (SyncBatchNorm(SYNC_BN_SHAPE[1]) if name == "sync"
              else TpuBatchNorm(SYNC_BN_SHAPE[1])).to(cuda)
        x = torch.from_numpy(x_all).to(cuda).requires_grad_()
        y = bn(x)
        (y * torch.from_numpy(w_all).to(cuda)).sum().backward()
        for key, got, w in zip(keys, (y, x.grad, bn.weight.grad,
                                      bn.bias.grad, bn.running_mean,
                                      bn.running_var), ref):
            np.testing.assert_allclose(got.detach().cpu().numpy(), w,
                                       err_msg=f"one card {name} {key}",
                                       **tol)


FSDP_CARDS, FSDP_STEPS, FSDP_SAVE_AT, FSDP_BATCH = 4, 7, 3, 8


def _global_batch_one_card(steps, batch, cards):
    """The bench GPT trained on one card on the global batch of ``cards``
    ranks' ``batch`` rows each (``seeded_tokens`` from seed 0, the rows
    the ranks take): each step's loss, each rank's rows' loss on the
    weights before each step, step seconds and peak memory."""
    import time

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import (gpt_config, loss_fn,
                                         make_train_step, seeded_tokens)

    cfg = gpt_config("bench", use_flash=True)
    basics.init(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    try:
        model = GPT(cfg, device=basics.device(), seed=0)
        step = make_train_step(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        tokens = seeded_tokens(cfg, batch * cards, cfg.max_seq_len, seed=0)
        out = {"losses": [], "rank_rows_losses": [], "step_s": []}
        for _ in range(steps):
            with torch.no_grad():
                out["rank_rows_losses"].append(
                    [float(loss_fn(model, tokens[r * batch:(r + 1) * batch]))
                     for r in range(cards)])
            t0 = time.perf_counter()
            out["losses"].append(float(step(tokens)))
            out["step_s"].append(time.perf_counter() - t0)
    finally:
        basics.shutdown()
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out


@pytest.mark.cuda
def test_nccl_fsdp_sharded_steps_and_checkpoint(cuda, tmp_path):
    """The full-width GPT (bench.py --model gpt --flash) under
    ``shard_module`` on four cards, launched by the port's launcher
    (``-np 4``, tests/torch_port_launch_worker.py), each card on its own
    batch of 8 rows of a seeded global batch of 32: seven steps at fsdp 4
    and at dp 2 × fsdp 2, held at steps 1 and 7 against one card trained
    on the global batch: each card's loss within LOSS_RTOL of its rows'
    loss there, and the cards' mean within LOSS_RTOL of its loss. One card
    trained on rank 0's rows alone must miss rank 0's reference at step 7
    by more than LOSS_RTOL, so a reduction that drops ranks shows. At
    fsdp 4 an async sharded checkpoint at step 3, restored by a new launch
    of four processes whose steps 4-6 equal the unbroken run's bit for
    bit. Every step launches each sm90 kernel 12 times and no SIMT kernel.
    Prints one FSDP4 JSON line: per card step time, peak memory, parameter
    bytes and the checkpoint's timings, beside one card's at batch 8 and at
    the global batch (run with -s)."""
    import json
    import statistics
    import subprocess

    import torch_port_launch_worker as LW
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.train import gpt_config, train

    if torch.cuda.device_count() < FSDP_CARDS:
        pytest.skip(f"needs {FSDP_CARDS} CUDA devices")
    base = dict(device="cuda", config="bench", batch=FSDP_BATCH,
                timeout_s=300)
    ckpt = str(tmp_path / "ckpt")
    runs = {}
    for name, args in (
            ("fsdp4", dict(layout={"fsdp": 4}, steps=FSDP_STEPS,
                           save_at=FSDP_SAVE_AT, dir=ckpt)),
            ("fsdp4_resumed", dict(layout={"fsdp": 4},
                                   steps=FSDP_STEPS - FSDP_SAVE_AT - 1,
                                   resume=True, dir=ckpt)),
            ("dp2_fsdp2", dict(layout={"dp": 2, "fsdp": 2},
                               steps=FSDP_STEPS,
                               dir=str(tmp_path / "unused")))):
        runs[name] = LW.Launch(FSDP_CARDS, "fsdp_gpt", str(tmp_path / name),
                               {**base, **args}, timeout=900).results()
    torch.cuda.reset_peak_memory_stats()
    try:
        # rank 0's rows alone: the first FSDP_BATCH rows of the global batch
        one = train(gpt_config("bench", use_flash=True), FSDP_STEPS,
                    FSDP_BATCH, 1024, seed=0)
    finally:
        basics.shutdown()
    one_peak = torch.cuda.max_memory_allocated()
    del one["model"], one["optimizer"]
    ref = _global_batch_one_card(FSDP_STEPS, FSDP_BATCH, FSDP_CARDS)
    rows_alone_gap = (abs(one["loss"][-1] - ref["rank_rows_losses"][-1][0])
                      / ref["rank_rows_losses"][-1][0])
    summary = {"one_card": {"losses": one["loss"],
                            "step_ms_median": statistics.median(
                                one["step_s"][2:]) * 1e3,
                            "max_memory_allocated_bytes": one_peak},
               "global_batch_one_card": {
                   **ref, "step_ms_median": statistics.median(
                       ref["step_s"][2:]) * 1e3},
               "rank0_rows_alone_step7_rel_gap": rows_alone_gap}
    failures = []
    sims = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for name, results in runs.items():
        steps = len(results[0]["losses"])
        rows = []
        for r, res in enumerate(results):
            assert res["launches"] == {
                **{k + "_sm90": 12 * steps for k in sims}, **sims,
                **NO_CODEC}, name
            if name == "fsdp4_resumed":
                assert res["restored_step"] == FSDP_SAVE_AT
                want = runs["fsdp4"][r]["losses"][FSDP_SAVE_AT:
                                                  FSDP_SAVE_AT + steps]
                assert res["losses"] == want, (res["losses"], want)
            else:
                for k in (0, steps - 1):
                    want = ref["rank_rows_losses"][k][r]
                    if abs(res["losses"][k] - want) > LOSS_RTOL * want:
                        failures.append((name, r, k, res["losses"][k], want))
            rows.append({k: res.get(k) for k in (
                "coords", "device", "losses", "n_params",
                "local_param_bytes", "max_memory_allocated_bytes",
                "save_blocking_ms", "wait_ms", "restore_ms", "launches")})
            rows[-1]["step_ms_median"] = statistics.median(
                res["step_s"][min(2, steps - 1):]) * 1e3
            rows[-1]["step_s"] = res["step_s"]
        rows[0]["profile"] = results[0]["profile"]
        summary[name] = rows
        if name != "fsdp4_resumed":
            for k in (0, steps - 1):
                mean = statistics.mean(res["losses"][k] for res in results)
                want = ref["losses"][k]
                if abs(mean - want) > LOSS_RTOL * want:
                    failures.append((name, "mean", k, mean, want))
    summary["checkpoint_bytes_on_disk"] = sum(
        p.stat().st_size for p in (tmp_path / "ckpt").rglob("*")
        if p.is_file())
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("FSDP4 " + json.dumps(summary))
    assert not failures, failures
    assert rows_alone_gap > LOSS_RTOL, summary["global_batch_one_card"]


ELASTIC_CARDS, ELASTIC_BATCH = 4, 8
# rows of the epoch: 3 commits at 4 cards, then 3 cards, then 4 again; 1152
# splits over 4 and over 3 at every step of those rounds (no padding), so
# every row is committed exactly once
ELASTIC_ROWS, ELASTIC_KILL_AFTER, ELASTIC_GROW_AFTER = 1152, 3, 2
ELASTIC_REPLICATED_STEPS = 4


def _elastic_summary(lives, rounds, seconds):
    """The ELASTIC4 numbers of one job: kill → HorovodInternalError per
    survivor, each survivor's recovery phases, the grow round, step ms by
    world size in order, commit ms and peak memory per card."""
    import statistics

    import torch_port_elastic_worker as EW

    a = EW.analyze(lives, rounds)
    phases, steps = {}, []
    for life in lives:
        for r in life["recoveries"]:
            phases.setdefault(f"slot{life['slot']}", []).append(r)
        if life["slot"] == 0:
            for size, s in life["step_s"]:
                if not steps or steps[-1][0] != size:
                    steps.append((size, []))
                steps[-1][1].append(s * 1e3)
    commits = [e for life in lives for e in life["events"]
               if e["kind"] == "commit"]
    return a, {
        "seconds": seconds, "rounds": [(r["round"], r["size"])
                                       for r in rounds],
        "kill_to_internal_error_s": a["kill_to_internal_error_s"],
        "recoveries": phases,
        "grow_written_to_resumed_s": a.get("grow_written_to_resumed_s"),
        "fresh_worker_start_to_entry_s": a.get("fresh_start_to_enter_s"),
        "step_ms_median_by_world": [
            (size, statistics.median(ms[1:] or ms), len(ms))
            for size, ms in steps],
        "commit_ms_median": statistics.median(e["ms"] for e in commits),
        "commit_payload_bytes": max((e.get("payload_bytes", 0)
                                     for e in commits), default=0),
        "commit_shard_bytes_held": max((e.get("shard_bytes", 0)
                                        for e in commits), default=0),
        "max_memory_allocated_bytes": {
            f"slot{life['slot']}.{life['pid']}":
                life.get("max_memory_allocated_bytes") for life in lives}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["torch_state", "replicated"])
def test_nccl_elastic_kill_shrink_grow(cuda, tmp_path, case):
    """Elastic training of the full-width GPT (bench.py --model gpt
    --flash) on four cards, launched by the port's elastic launcher
    (``-np 4 --min-np 2 --max-np 4 --host-discovery-script``, worker
    tests/torch_port_elastic_worker.py). ``torch_state``: TorchState, rows
    from an ElasticSampler over a seeded dataset; after commit 3 the worker
    of slot 3 rewrites the discovery to ``localhost:3`` and SIGKILLs
    itself; the driver aborts the survivors' NCCL communicators, each
    survivor gets HorovodInternalError, restores commit 3 and trains at
    size 3; rank 0 then writes ``localhost:4`` back, and at the next commit
    the survivors re-rendezvous with a fresh worker on cuda:3 that sync()
    brings to rank 0's state. Held: every row committed exactly once, one
    parameter digest on every rank after each sync, each survivor's state
    after the restore bit for bit its commit-3 state, finite losses, ranks
    kept by slot. ``replicated``: ReplicatedTorchState; the killed slot is
    respawned and rebuilds its lineage from its peer's shard, bit for bit.
    Each case prints one ELASTIC4 JSON line (run with -s)."""
    import json
    import subprocess

    import torch_port_elastic_worker as EW

    if torch.cuda.device_count() < ELASTIC_CARDS:
        pytest.skip(f"needs {ELASTIC_CARDS} CUDA devices")
    args = dict(device="cuda", config="bench", batch=ELASTIC_BATCH,
                timeout_s=120, rows=ELASTIC_ROWS)
    if case == "torch_state":
        args.update(kill={"slot": 3, "after_commit": ELASTIC_KILL_AFTER,
                          "hosts": "localhost:3"},
                    grow={"after_commit": ELASTIC_GROW_AFTER,
                          "hosts": "localhost:4"})
    else:
        args.update(state="replicated", steps=ELASTIC_REPLICATED_STEPS,
                    kill={"slot": 3, "after_commit": ELASTIC_KILL_AFTER})
    job = EW.ElasticLaunch(ELASTIC_CARDS, str(tmp_path / case), args,
                           min_np=2, timeout=900)
    a, summary = _elastic_summary(*job.results())
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("ELASTIC4 " + json.dumps({case: summary}))

    assert sorted(a["kill_to_internal_error_s"]) == [0, 1, 2]
    assert all(0 < s < 60 for s in a["kill_to_internal_error_s"].values())
    assert all(a["params_agree"].values()) and a["losses_finite"]
    assert a["opt_set_sizes_match"]
    for ranks in a["round_ranks"]:
        assert all(rank == int(key.split("/")[1])
                   for key, rank in ranks.items()), ranks
    if case == "replicated":
        assert a["round_sizes"] == [4, 4], a["round_sizes"]
        assert a["fresh_equals_killed"], a
        assert a["fresh_last_recovery"]["outcome"] == "peer"
        return
    sizes = a["round_sizes"]
    assert sizes[0] == 4 and 3 in sizes and sizes[-1] == 4, sizes
    assert sizes.index(3) < len(sizes) - 1
    assert sorted(a["committed_counts"]) == list(range(ELASTIC_ROWS))
    assert set(a["committed_counts"].values()) == {1}
    assert a["restored_equals_commit"] == {0: True, 1: True, 2: True}
    assert a["devices_by_slot"] == {i: [f"cuda:{i}"]
                                    for i in range(ELASTIC_CARDS)}


JOIN_CARDS, JOIN_BATCHES, JOIN_SHORT, JOIN_BATCH = 4, 5, 3, 8
JOIN_RTOL = 1e-5


def join_reference(cfg, state, steps, batch, cards, device):
    """One process from the JOIN4 job's state after step ``JOIN_SHORT``:
    for each of ``steps`` (0-based), the active ranks' (all but the last)
    rows' losses, then one AdamW step on their gradients summed with the
    joined rank's zeros and divided by ``cards`` (the JAX engine's Average
    rule with a rank joined). Returns the losses by step and the
    parameters' sums after the last step."""
    import torch_port_launch_worker as LW
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import loss_fn

    model = GPT(cfg, device=device, seed=0)
    model.load_state_dict(state["model"])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    opt.load_state_dict(state["optim"])
    losses = []
    for i in steps:
        opt.zero_grad(set_to_none=True)
        losses.append([])
        for r in range(cards - 1):
            loss = loss_fn(model, LW.join_tokens(cfg, i, r, cards,
                                                 batch).to(device))
            loss.backward()
            losses[-1].append(float(loss.detach()))
        for p in model.parameters():
            p.grad /= cards
        opt.step()
    return losses, [float(p.detach().double().sum())
                    for p in model.parameters()]


def check_join_job(results, trace, cfg, device, batch, cards, out):
    """JOIN4's checks (also run on the CPU at a small size): the same last
    rank everywhere, steps JOIN_SHORT+1.. of the active ranks against
    :func:`join_reference`, equal parameters on every rank at the end, and
    a merged trace with a pid per rank holding its allreduces' spans.
    Returns the reference's losses."""
    lasts = {res["last"] for res in results}
    assert len(lasts) == 1 and lasts.pop() in range(cards - 1), lasts
    assert len({res["param_sha256"] for res in results}) == 1
    state = torch.load(out + ".state.pt", weights_only=False,
                       map_location=device)
    steps = range(JOIN_SHORT, JOIN_BATCHES)
    ref_losses, ref_sums = join_reference(cfg, state, steps, batch, cards,
                                          device)
    for k, i in enumerate(steps):
        for r in range(cards - 1):
            np.testing.assert_allclose(results[r]["losses"][i],
                                       ref_losses[k][r], rtol=JOIN_RTOL,
                                       err_msg=f"step {i + 1} rank {r}")
    np.testing.assert_allclose(results[0]["param_sums"], ref_sums,
                               rtol=JOIN_RTOL, atol=1e-6)
    assert {e["pid"] for e in trace} == set(range(cards))
    span = "NCCL_GROUPED_ALLREDUCE" if device.type == "cuda" \
        else "GLOO_GROUPED_ALLREDUCE"
    for r in range(cards):
        spans = [e for e in trace if e["pid"] == r and e.get("name") == span]
        # a step's allreduce each, and the profiled ones after the join
        want = len(results[r]["losses"]) + results[r].get(
            "window", {}).get("calls", 0)
        assert len(spans) == want, (r, len(spans))
        assert all(e["dur"] > 0 for e in spans)
        if device.type == "cuda":
            assert all(e["args"]["clock"] == "cuda_event" for e in spans)
    return ref_losses


@pytest.mark.cuda
def test_nccl_join_ragged_ranks_full_width(cuda, tmp_path):
    """JOIN4: the full-width GPT (bench.py --model gpt --flash) through the
    port's launcher on four cards with ``--timeline`` and
    ``--metrics-port``; ranks 0-2 hold 5 batches of 8 rows, rank 3 holds 3
    and calls ``hvt.join()`` after its third step, the others after their
    fifth, then all take the last joiner's parameters. Every rank's join
    returns the same last rank; steps 4-5 of ranks 0-2 match one process
    from step 3's state applying the JAX engine's Average rule with rank
    3's zeros (rtol 1e-5); parameters agree on all four ranks; the merged
    trace has four pids, each with the CUDA-event spans of its NCCL
    allreduces; rank 0 scrapes all four /metrics mid-run. Prints one JOIN4
    JSON line: the negotiation's cost per collective, the step time before and
    after the join, the histogram's allreduce ms beside the NCCL kernels'
    ms, the trace's size (run with -s)."""
    import json

    import torch_port_launch_worker as LW
    from horovod_tpu_torch.train import gpt_config

    if torch.cuda.device_count() < JOIN_CARDS:
        pytest.skip(f"needs {JOIN_CARDS} CUDA devices")
    trace_path, out = str(tmp_path / "trace.json"), str(tmp_path / "res")
    base = LW.free_port()
    results = LW.Launch(
        JOIN_CARDS, "join_gpt", out,
        dict(device="cuda", config="bench", batch=JOIN_BATCH,
             batches=JOIN_BATCHES, short=JOIN_SHORT, scrape_at=2,
             timeout_s=300),
        timeout=900, launcher_args=("--timeline", trace_path,
                                    "--metrics-port", str(base))).results()
    with open(trace_path) as f:
        trace = json.load(f)
    cfg = gpt_config("bench", use_flash=True)
    ref = None
    try:
        ref = check_join_job(results, trace, cfg, cuda, JOIN_BATCH,
                             JOIN_CARDS, out)
    finally:
        print("JOIN4 " + json.dumps(_join_summary(results, ref, trace,
                                                  trace_path)))
    for r, res in enumerate(results):
        want = JOIN_SHORT if r == JOIN_CARDS - 1 else JOIN_BATCHES
        assert res["launches"] == {
            **{k: 12 * want for k in ("flash_fwd_sm90", "flash_dq_sm90",
                                      "flash_dkv_sm90")},
            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, **NO_CODEC}, r
        assert res["diagnostics"]["pending"] == []
    for peer, scrape in enumerate(results[0]["scraped"]):
        assert 'hvt_collective_latency_seconds_count{op="grouped_allreduce"' \
            in scrape["text"], peer
    for res in results:
        w = res["window"]
        assert w["observations"] == w["calls"], w
        assert w["nccl_kernels"] == 1 + w["calls"], w


def _join_summary(results, ref, trace, trace_path):
    """The JOIN4 line's numbers."""
    import os
    import statistics
    import subprocess

    return {
        "last": results[0]["last"],
        "reference_losses_steps_4_5": ref,
        "losses": [res["losses"] for res in results],
        "step_ms": [[s * 1e3 for s in res["step_s"]] for res in results],
        "step_ms_before_join": [statistics.median(res["step_s"][1:JOIN_SHORT])
                                * 1e3 for res in results],
        "step_ms_after_join": [statistics.median(res["step_s"][JOIN_SHORT:])
                               * 1e3 for res in results[:-1]],
        "join_s": [res["join_s"] for res in results],
        "window": [res["window"] for res in results],
        "negotiation_cost": [res["negotiation_cost"] for res in results],
        "scrape_ms": [s["ms"] for s in results[0]["scraped"]],
        "max_memory_allocated_bytes": [res["max_memory_allocated_bytes"]
                                       for res in results],
        "trace_bytes": os.path.getsize(trace_path),
        "trace_events": len(trace),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()}


@pytest.mark.cuda
def test_nccl_allreduce_latency_from_cuda_events(cuda, tmp_path):
    """NCCL allreduces of 64 MiB on two cards, behind a barrier: the
    latency the histogram holds (a pair of CUDA events on the issuing
    stream, resolved off the thread) against the NCCL kernels' time in
    torch.profiler over the same calls. The events bracket each call's
    allreduce kernel (its negotiation runs on the host before the first
    event), so the latency is at least the kernel's time and exceeds it by
    the gaps alone. Prints one
    ALLREDUCE_LATENCY JSON line."""
    import json

    import torch_port_launch_worker as LW

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    calls = 5
    results = LW.Launch(2, "allreduce_latency", str(tmp_path / "res"),
                        dict(device="cuda", mib=64, calls=calls),
                        timeout=300).results()
    print("ALLREDUCE_LATENCY " + json.dumps(results))
    for res in results:
        assert res["observations"] == calls, res
        assert res["nccl_kernels"] == 1 + calls, res
        assert res["event_ms"] >= 0.95 * res["nccl_kernel_ms"], res
        assert res["event_ms"] - res["nccl_kernel_ms"] < calls * 1.0, res


def _wire4_chunk_bytes(codec, m, g, me):
    """Encoded bytes member ``me`` of a group of ``g`` sends in a
    compressed reduce-scatter and allgather of ``m`` elements (the wire
    formula of tests/test_data_plane.py:205, stream by stream)."""
    c = -(-m // (256 * g)) * 256
    lens = [max(0, min(c, m - j * c)) for j in range(g)]
    wb = (lambda k: 2 * k) if codec == "bf16" else \
        (lambda k: (k // 256) * 260 + (4 + k % 256 if k % 256 else 0))
    return sum(wb(k) for j, k in enumerate(lens) if j != me) + \
        (g - 1) * wb(lens[me])


@pytest.mark.cuda
def test_nccl_wire4_codecs_on_two_faked_hosts_full_width(cuda, tmp_path):
    """WIRE4: the bench GPT at full width under
    DistributedOptimizer(AdamW) on four cards as two faked hosts of two,
    each rank on its own rows, WIRE4_STEPS steps under each spec of
    torch_port_wire_gang.WIRE4_SPECS in turn (a launch each). Every run's
    losses are finite and within LOSS_RTOL of the raw run's at steps 1 and
    7, the parameters are bit-identical across the four ranks, each step's
    encoded bytes equal the wire formula for the codec it used, and the
    codec kernels launch as the route says. Prints one WIRE4 JSON line
    (run with -s): step ms a card, the codec kernels' and NCCL's device ms
    in a profiled step, the cross stage alone by CUDA events."""
    import json
    import statistics
    import subprocess

    import torch_port_wire_gang as WG

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    _kernels.build()        # once, before four processes would each build
    runs = {}
    for i, spec in enumerate(WG.WIRE4_SPECS):
        name = ",".join(f"{k}={v}" for k, v in spec.items()) or "unset"
        runs[name] = WG.run_wire4(str(tmp_path / f"w{i}"), spec)
    raw = runs["unset"]
    summary = {"steps": WG.WIRE4_STEPS, "batch_per_card": WG.WIRE4_BATCH,
               "seq": WG.WIRE4_SEQ, "n_params": raw[0]["n_params"],
               "runs": {}}
    failures = []
    for name, results in runs.items():
        n_params = results[0]["n_params"]
        piece = 256 * -(-n_params // (2 * 256))
        row = {"losses": [r["losses"] for r in results],
               "step_ms_median": [statistics.median(r["step_s"][2:]) * 1e3
                                  for r in results],
               "codec_ms_per_step": [r["codec_ms_per_step"]
                                     for r in results],
               "nccl_ms_per_step": [r["nccl_ms_per_step"] for r in results],
               "cross_stage_ms_median": [statistics.median(
                   r["cross_stage_ms"]) for r in results],
               "cross_stage_elements": results[0]["cross_stage_elements"],
               "picks": results[0]["picks"],
               "tx_bytes_total": [r["tx"][-1] for r in results],
               "ef_residual_bytes": results[0]["ef_residual_bytes"],
               "ef_dropped": results[0]["ef_dropped"],
               "launches_rank0": {k: v for k, v in
                                  results[0]["launches"].items() if v},
               "profiled_step_device_ms_rank0":
                   results[0]["profiled_step_device_ms"]}
        summary["runs"][name] = row
        for r, res in enumerate(results):
            losses, ref = res["losses"], raw[r]["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            if not all(map(lambda v: v == v and abs(v) < 1e30, losses)) \
                    or rel[0] > LOSS_RTOL or rel[6] > LOSS_RTOL:
                failures.append(f"{name} rank {r}: losses {losses} vs raw "
                                f"{ref}")
            if res["param_sha256"] != results[0]["param_sha256"]:
                failures.append(f"{name}: rank {r}'s parameters differ "
                                f"from rank 0's")
            prev, cr = {}, r // 2
            for i, (tx, pick) in enumerate(zip(res["tx"], res["picks"])):
                step_tx = {c: v - prev.get(c, 0) for c, v in tx.items()
                           if v - prev.get(c, 0)}
                want = {} if pick == "none" else {
                    pick: _wire4_chunk_bytes(pick, piece, 2, cr)}
                if step_tx != want:
                    failures.append(f"{name} rank {r} step {i + 1}: wire "
                                    f"bytes {step_tx}, formula {want}")
                prev = tx
            lossy = [p for p in res["picks"] if p != "none"]
            want = {k: 12 * WG.WIRE4_STEPS for k in (
                "flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90")}
            for codec in set(lossy):
                k = lossy.count(codec)
                want.update({f"wire_encode_{codec}": 2 * k,
                             f"wire_decode_accumulate_{codec}": 3 * k,
                             f"wire_ef_roundtrip_{codec}":
                                 res["n_tensors"] * k})
            got = {k: v for k, v in res["launches"].items() if v}
            if got != want:
                failures.append(f"{name} rank {r}: launches {got}, "
                                f"expected {want}")
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("WIRE4 " + json.dumps(summary))
    assert not failures, failures


@pytest.mark.cuda
def test_nccl_serve4_replica_gangs_on_four_cards(cuda, tmp_path):
    """SERVE4: ``python -m horovod_tpu_torch.serving.loadgen`` under the
    port's launcher ``-np 4`` (each slot on fake hosts of two cards) with
    r07's traffic (2 replicas, 800 requests of 8,192 bytes a rank a phase,
    burst 2, window 4, admission 250 ms, sync every 50, replica 0 saturated
    by 2 in the contended phase), once unbatched, once with
    HVT_SERVING_BATCH=4, once with the column lanes [[0, 2], [1, 3]] across
    the fake hosts, and with a zero admission budget (every reap waits
    without the 1 ms deadline poll), in turns with the unbatched run, twice
    each. Every artifact is valid; every member
    of a replica has the same admitted and shed counts and decision log;
    every result is exact. Prints one SERVE4 JSON line (run with -s): p50,
    p99 and requests/s per replica and phase, the isolation block (its
    ratio reported, not gated) and the decision logs' equality."""
    import json
    import subprocess

    import torch_port_serve_worker as SW

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    runs = SW.run_serve4(str(tmp_path))
    failures = []
    for name, (doc, _) in runs.items():
        members = [[0, 2], [1, 3]] if name == "columns" \
            else [[0, 1], [2, 3]]
        failures += [f"{name}: {p}" for p in SW.problems(doc, members)]
        if not doc["config"]["device"].startswith("cuda"):
            failures.append(f"{name}: ran on {doc['config']['device']}")
    line = SW.serve4_line(runs)
    line["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("SERVE4 " + json.dumps(line))
    assert not failures, failures


# COORD4: each case of tests/torch_port_coord_program.py on four ranks and
# what every rank of it must give: the exception's class and a part of its
# message (the CPU test holds the whole text to the JAX engine's), or "ok"
COORD4_EXPECT = {
    "shape": ("ValueError", "mismatched shape for tensor 'bad' ([3] vs [2])"),
    "shape_2d": ("ValueError", "([2,3] vs [2,2])"),
    "shape_unnamed": ("ValueError", "tensor 'hvt.allreduce.1' ([5] vs [4])"),
    "dtype": ("ValueError", "mismatched dtype for tensor 'dt'"),
    "reduce_op": ("ValueError", "mismatched reduce op for tensor 'ro'"),
    "root": ("ValueError", "mismatched root rank for tensor 'rt'"),
    "scales": ("ValueError", "mismatched scale factors for tensor 'sc'"),
    "op": ("ValueError", "mismatched collective op for tensor 'opx'"),
    "allgather_dims": ("ValueError", "mismatched non-leading dims"),
    "allgather_ndim": ("ValueError", "mismatched rank (ndims)"),
    "grouped_member": ("ValueError", "(fusion group 1 aborted)"),
    "repeat0": ("ok", ""), "repeat1": ("ok", ""), "repeat2": ("ok", ""),
    "repeat_changed": ("ValueError", "tensor 'rep' ([2] vs [3])"),
    "set_conflict": ("ValueError", "conflicting process sets"),
    "grouped_set_conflict": ("ValueError", "tensor 'gg.0' was submitted with "
                                           "conflicting process sets"),
    "after": ("ok", [1.0, 1.0]), "stalled": ("ok", ""),
}


@pytest.mark.cuda
def test_nccl_coord4_mismatches_error_and_stalls_warn(cuda, tmp_path):
    """COORD4: tests/torch_port_coord_program.py through the port's
    launcher on four cards (NCCL) with --stall-warning-sec 1, in a world
    that negotiates on the board and in one that negotiates in the store:
    every mismatch of the matrix raises the JAX engine's ValueError on
    every rank before any data moves, and does not hang; overlapping sets
    error and a disjoint set's allreduce ([2, 3]) gives the right sum
    beside an error in [0, 1]; the next collective works; a late rank 0 is
    warned about (never the joined rank 1) and shows in rank 0's
    diagnostics(); 10,000 negotiations leave the store's keys where they
    were. Prints one COORD4 JSON line: per world and rank, the host µs a
    negotiation costs alone (one request repeated, a new name each call)
    and through hvt.allreduce_ beside torch.distributed, and the store's
    key counts (run with -s)."""
    import json
    import os
    import re
    import socket
    import subprocess
    import sys

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "coord")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "4",
         "--master-port", str(port), "--stall-warning-sec", "1",
         sys.executable, os.path.join(repo, "tests",
                                      "torch_port_coord_program.py"),
         out, "cuda"], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    worlds = {}
    for r in range(4):
        with open(f"{out}.{r}.json") as f:
            for transport, res in json.load(f).items():
                worlds.setdefault(transport, []).append(res)
    sections = {part.split(" ==", 1)[0]: part
                for part in proc.stdout.split("== transport ")[1:]}
    warned = {transport: sorted({(t, ranks.strip()) for t, ranks in
                                 re.findall(
        r"tensor '(\w+)' was submitted by some ranks but not by ranks "
        r"\[ ([0-9 ]*)\] for \d+ s", sections.get(transport, ""))})
        for transport in worlds}
    print("COORD4 " + json.dumps({
        "negotiation_cost_us": {t: [res["negotiation_cost"] for res in rs]
                                for t, rs in worlds.items()},
        "keys": {t: [res["keys"] for res in rs] for t, rs in worlds.items()},
        "warned": warned,
        "diagnostics": {t: rs[0]["diagnostics"] for t, rs in worlds.items()},
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()}))
    assert sorted(worlds) == ["board", "store"]
    assert [res["on_board"] for res in worlds["board"]] == [True] * 4
    assert [res["on_board"] for res in worlds["store"]] == [False] * 4
    for transport, results in worlds.items():
        for r, res in enumerate(results):
            by = {tag: (cls, msg) for tag, cls, msg in res["cases"]}
            for tag, (cls, part) in COORD4_EXPECT.items():
                got = by[tag]
                assert got[0] == cls, (transport, r, tag, got)
                assert part in got[1] if isinstance(part, str) else \
                    got[1] == part, (transport, r, tag, got)
            keys = res["keys"]
            assert keys["async_sums_ok"], (transport, r)
            assert keys["peak"] - keys["before"] < keys["calls"], keys
            assert keys["after"] - keys["before"] < 2 * 64 * 4, keys
        for r in (0, 1):
            assert dict((t, c) for t, c, _ in results[r]["cases"])[
                "set_error"] == "ValueError"
        for r in (2, 3):
            assert dict((t, m) for t, _, m in results[r]["cases"])[
                "spared_set"] == [5.0, 5.0]
        # the late rank 0, never the joined rank 1; other warnings may
        # come from a set's first collective, which makes its NCCL
        # communicator
        stalled = dict(warned[transport])
        assert (stalled["lonely"], stalled["lonely2"]) == ("0", "0"), \
            warned
        assert [res["after_join"] for res in results] == [[6.0, 6.0]] * 4
        rows = results[0]["diagnostics"]["stalls"]
        assert [(x["tensor"], x["arrived_ranks"], x["missing_ranks"])
                for x in rows] == [("lonely", [1, 2, 3], [0])]
