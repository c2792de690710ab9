"""Flash attention for the port: one ``torch.autograd.Function`` whose
forward and backward are the hand-written Hopper kernels of
:mod:`horovod_tpu_torch.ops._kernels` on CUDA tensors, and their plain
PyTorch versions on CPU tensors.

The public surface follows ``horovod_tpu/ops/flash_attention.py``: BSHD
tensors in and out, lse as fp32 ``[B, S, H]``, gradients through both o and
lse (a lse cotangent folds into ``delta = rowsum(dO∘O) − dlse``), GQA served
without repeating K/V, and ``ValueError`` on indivisible heads. Block sizes
are the kernels' own (any sequence length), so the JAX function's
``block_q``/``block_k`` arguments have no counterpart here. Any head_dim
up to the kernels' widest reaches them: one off their grid of 8 is
zero-padded once in the forward (q, k, v) and once in the backward (dO),
and o, dq, dk and dv are cut back. That is exact: zero columns of q and k
add nothing to q·kᵀ, zero columns of v and dO give zero columns of o, dq,
dk and dv, and delta is unchanged; ``scale`` keeps the true head_dim's
value. A head_dim on the grid makes no copy.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.ops import _kernels

# "auto" uses the flash kernels above this length. The TPU package's
# crossover (2048) was measured on a TPU and does not carry over. On an
# H100 (python -m horovod_tpu_torch.bench --model gpt, batch 8, bf16, with
# and without --flash) the flash step was faster at every length measured,
# 256 to 4096; below 256 nothing was measured, so "auto" keeps the einsum
# path there.
FLASH_AUTO_THRESHOLD = 255


def resolve_flash(use_flash, local_seq, dtype, head_dim,
                  out_dtype=None) -> bool:
    """Resolve a ``use_flash`` policy ("auto" | bool) for attention over
    ``local_seq`` positions of q in ``dtype`` with ``head_dim``, o in
    ``out_dtype`` (default q's): "auto" is True above
    ``FLASH_AUTO_THRESHOLD`` where all three kernels take the shape
    (``_kernels.sm90_takes``: bf16 or fp16 q at head_dim 1..512 with an o
    in q's dtype and at 1..256 with an fp32 o, fp32 at 1..256), else the
    einsum path; True stays True, and the kernels then raise on a CUDA
    tensor whose shape they do not take."""
    if isinstance(use_flash, str):
        if use_flash != "auto":
            raise ValueError(
                f"use_flash must be True, False, or 'auto'; got "
                f"{use_flash!r}")
        return (local_seq > FLASH_AUTO_THRESHOLD
                and _kernels.sm90_takes(dtype, head_dim, out_dtype))
    return bool(use_flash)


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) [B, S, H(_kv), D] → (o [B, S, H, D], lse [B, H, S]); a D
    off the kernels' grid of 8 runs zero-padded (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, out_dtype):
        d = q.shape[-1]
        dp = _kernels.padded_head_dim(d)
        q, k, v = (_kernels.pad_head_dim(t.contiguous(), dp)
                   for t in (q, k, v))
        o, lse = _kernels.flash_fwd(q, k, v, scale, causal, out_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.d = scale, causal, d
        ctx.set_materialize_grads(False)
        return (o if dp == d else o[..., :d].contiguous()), lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        d = ctx.d
        if do is None:
            do = torch.zeros_like(o)
        do = _kernels.pad_head_dim(do.contiguous(), o.shape[-1])
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()                         # [B, H, S]
        # fp16: dO's largest magnitude, which both kernels scale dO by
        amax = _kernels.dout_amax(do) if q.dtype == torch.float16 else None
        dq = _kernels.flash_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal,
                               dout_amax=amax)
        dk, dv = _kernels.flash_dkv(q, k, v, do, lse, delta, ctx.scale,
                                    ctx.causal, dout_amax=amax)
        return dq[..., :d], dk[..., :d], dv[..., :d], None, None, None


def _prepare(q, k, scale):
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(
            f"GQA requires n_heads ({h}) divisible by n_kv_heads ({h_kv})")
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention_with_lse(q, k, v, *, causal=True, scale=None,
                             out_dtype=None):
    """Fused attention returning ``(o, lse)``; both are differentiable.

    ``q`` is ``[batch, seq, heads, head_dim]``; ``k`` and ``v`` carry
    ``n_kv_heads`` heads, which must divide ``heads`` (query head ``hi``
    reads K/V head ``hi // group``). ``o`` is ``[batch, seq, heads,
    head_dim]`` in ``out_dtype`` (default q's dtype); ``lse[b, s, h]`` is
    the fp32 log-sum-exp of the scaled, masked scores of each query, which
    blockwise consumers use to combine partial outputs.
    """
    scale = _prepare(q, k, scale)
    o, lse = _FlashAttention.apply(q, k, v, scale, bool(causal),
                                   out_dtype or q.dtype)
    return o, lse.transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Fused multi-head attention: ``[batch, seq, heads, head_dim]`` in q's
    dtype. Differentiable, with recompute-based backward kernels."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    return o


def flash_attention_reference(q, k, v, *, causal=True, scale=None,
                              out_dtype=None):
    """Plain PyTorch attention with the flash contract: dense fp32 scores,
    the ``-1e30`` causal fill, fp32 softmax, p rounded to v's dtype before
    p·v. Returns ``(o, lse)`` like :func:`flash_attention_with_lse` and is
    differentiable by autograd. The yardstick the kernels are held to."""
    scale = _prepare(q, k, scale)
    o, lse = _kernels.flash_fwd_plain(q, k, v, scale, bool(causal),
                                      out_dtype or q.dtype)
    return o, lse.transpose(1, 2)
