"""The tensor-core (sm90) route of horovod_tpu_torch's flash kernels, on the
CPU: which kernel each dtype and head_dim reaches, the wrappers' checks
before any launch, and the plain versions of ``flash_dq_sm90`` and
``flash_dkv_sm90`` held against the JAX package's gradients (Pallas
interpret mode, as tests/test_flash_attention.py runs it) on the same numpy
inputs.

Tolerance of the dkv comparison: 2e-2, relative and absolute. On the sm90
route p and ds are rounded to bf16 before p^T dO and ds^T q, where the TPU
kernel takes them in fp32; at these shapes that moves dk and dv by at most
one bf16 ulp of the output (0.0156 at |dk| <= 2.8, 0.031 at |dv| <= 5.4,
the same as the fp32-operand plain version's distance to JAX), and 2e-2
relative is three such ulps.

Tolerance of the dq comparison: the same 2e-2. ds is rounded to bf16
before ds k, where the TPU kernel takes it in fp32; at these shapes dq lies
at most 0.0090 from JAX's at |dq| <= 2.6 (at most 0.0087 of the 2e-2
budget |err| <= tol (1 + |want|)), the same distance as the fp32-operand
plain version's, so the rounding hides inside dq's own bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash
from horovod_tpu_torch.ops import _kernels

BF16_OPERANDS = 2e-2


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "simt"),      # the entry config's head_dim
    (torch.bfloat16, 96, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
])
def test_variant_routes_by_dtype_and_head_dim(dtype, d, want):
    assert _kernels._variant(dtype, d) == want
    q = torch.zeros(1, 4, 2, d, dtype=dtype)
    suffix = "_sm90" if want == "sm90" else ""
    for base in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert _kernels._kernel(base, q, None) == base + suffix
        assert _kernels._kernel(base, q, "simt") == base


@pytest.mark.parametrize("dtype,d,variant,match", [
    (torch.float32, 64, "sm90", "bf16 with head_dim 64 or 128"),
    (torch.bfloat16, 32, "sm90", "bf16 with head_dim 64 or 128"),
    (torch.bfloat16, 64, "wgmma", "variant must be"),
])
def test_explicit_variant_must_take_the_inputs(dtype, d, variant, match):
    q = torch.zeros(1, 16, 2, d, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        _kernels.flash_fwd(q, q, q, 1.0, True, dtype, variant=variant)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_dq", "flash_dkv"])
@pytest.mark.parametrize("variant", ["sm90", "simt"])
@pytest.mark.parametrize("bad,match", [
    (dict(k=(1, 16, 3, 64)), "divisible"),
    ({}, "CUDA"),          # well formed, but not on a CUDA device
])
def test_wrappers_validate_before_any_launch(monkeypatch, wrapper, variant,
                                            bad, match):
    """A tensor off the CPU goes down the launch path: the wrapper checks
    it there and raises before any pointer reaches a kernel."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(_kernels, "_run", no_launch)
    q = _meta((1, 16, 2, 64))
    k = _meta(bad.get("k", (1, 16, 2, 64)))
    lse = _meta((1, 2, 16), torch.float32)
    with pytest.raises(ValueError, match=match):
        if wrapper == "flash_fwd":
            _kernels.flash_fwd(q, k, k, 0.125, True, torch.bfloat16,
                               variant=variant)
        else:
            getattr(_kernels, wrapper)(q, k, k, q, lse, lse, 0.125, True,
                                       variant=variant)


SHAPES = pytest.mark.parametrize("b,s,h,h_kv,causal", [
    (1, 128, 2, 1, True),       # causal, the query group summed (MQA)
    (1, 128, 2, 2, False),      # non-causal
    (2, 96, 4, 2, True),        # uneven S (JAX halves its blocks), GQA
])


def _grads_and_args(b, s, h, h_kv, causal, d=64):
    """(dq, dk, dv) of the JAX package's flash attention at bf16, and the
    port's kernel arguments for the same numpy inputs."""
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.normal(size=(b, s, n, d)).astype(np.float32)
                   for n in (h, h_kv, h_kv, h))
    to_j = lambda x: jnp.asarray(x, jnp.bfloat16)
    blocks = 64 if s % 64 == 0 else 32
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=blocks, block_k=blocks)[0],
        to_j(q), to_j(k), to_j(v))
    grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(to_j(do))]

    qt, kt, vt, dot = (torch.tensor(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd_plain(qt, kt, vt, scale, causal,
                                      torch.bfloat16)
    delta = (dot.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return grads, (qt, kt, vt, dot, lse, delta, scale, causal)


@SHAPES
def test_dq_with_bf16_operands_matches_jax(b, s, h, h_kv, causal):
    (dq_j, _, _), args = _grads_and_args(b, s, h, h_kv, causal)
    dq = _kernels.flash_dq_plain(*args, round_operands=True)
    np.testing.assert_allclose(dq.float().numpy(), dq_j, rtol=BF16_OPERANDS,
                               atol=BF16_OPERANDS)
    # on a CPU tensor the wrapper runs the plain version of the kernel it
    # would launch: bf16 at D 64 is the sm90 route, ds rounded
    assert torch.equal(_kernels.flash_dq(*args), dq)


@SHAPES
def test_dkv_with_bf16_operands_matches_jax(b, s, h, h_kv, causal):
    (_, dk_j, dv_j), args = _grads_and_args(b, s, h, h_kv, causal)
    dk, dv = _kernels.flash_dkv_plain(*args, round_operands=True)
    for name, got, want in (("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_OPERANDS, atol=BF16_OPERANDS,
                                   err_msg=name)
    # on a CPU tensor the wrapper runs the plain version of the kernel it
    # would launch: bf16 at D 64 is the sm90 route, operands rounded
    for got, want in zip(_kernels.flash_dkv(*args), (dk, dv)):
        assert torch.equal(got, want)
