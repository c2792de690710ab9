"""Sequence parallelism: ring attention and Ulysses (the JAX package's
``parallel/sequence.py``).

- **Ring attention** (:func:`ring_attention_shard`): each rank holds a
  sequence shard of Q and passes the K/V shards around the ring of its
  ``sp`` line with :func:`~horovod_tpu_torch.parallel.primitives.ring_pass`,
  merging one block per step into an online softmax. Memory per rank is
  O(seq / n). (Liu et al., "Ring Attention with Blockwise Transformers",
  2023.)
- **Ulysses** (:func:`ulysses_attention_shard`): an all-to-all turns the
  sequence shards into head shards, attention runs over the whole sequence
  with H / n heads, and a second all-to-all turns them back. (DeepSpeed
  Ulysses, Jacobs et al., 2023.)

Every function takes this rank's shards (``[batch, seq / n, heads,
head_dim]``) and a process set or mesh; the port has no global arrays, so
the JAX wrappers' ``shard_map`` and ``seq_specs`` have no counterpart.

On the ring the kind of each block is known on the host from the ranks
alone: the shard that started on this rank is the diagonal block (causal),
a shard from an earlier position is fully visible, and one from a later
position is fully masked and launches nothing. Skipping it gives the same
numbers, gradients included, as the JAX branch that returns a zero ``o``
with an lse of -1e30: merging that block leaves ``(o, lse)`` unchanged.
The block arithmetic (:func:`flash_ring_block`, :func:`einsum_ring_block`)
is kept apart from the communication, so it also runs on one device.
"""

from __future__ import annotations

import functools

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_with_lse,
                                                   resolve_flash)
from horovod_tpu_torch.parallel.primitives import all_to_all, ring_pass

# finite stand-in for -inf: merging two masked rows gives 0, never inf-inf
NEG_INF = -1e30
# the kinds of a ring block, from the shard positions of Q and of K/V
DIAGONAL, EARLIER, LATER = 0, 1, 2


def block_kind(q_shard, kv_shard, causal) -> int:
    """DIAGONAL (causal mask), EARLIER (fully visible) or LATER (fully
    masked) for the K/V shard ``kv_shard`` seen from Q shard ``q_shard``;
    without ``causal`` every block is fully visible."""
    if not causal or kv_shard < q_shard:
        return EARLIER
    return DIAGONAL if kv_shard == q_shard else LATER


def _check_gqa(h, h_kv):
    if h % h_kv:
        raise ValueError(f"query heads ({h}) must be a multiple of K/V "
                         f"heads ({h_kv})")


def flash_ring_start(q):
    """The empty ``(o, lse)`` of :func:`flash_ring_block`: fp32 zeros
    ``[B, S, H, D]`` and ``[B, S, H]`` of -1e30."""
    b, s, h, d = q.shape
    return (q.new_zeros((b, s, h, d), dtype=torch.float32),
            q.new_full((b, s, h), NEG_INF, dtype=torch.float32))


def flash_ring_block(q, k_blk, v_blk, o, lse, kind, scale):
    """Attend one K/V block with the flash kernels and merge it into
    ``(o, lse)`` by logaddexp: ``o = Σ_i exp(lse_i - logaddexp_i lse_i) ·
    o_i``. The kernel writes an fp32 ``o`` so that the merge sees the
    unrounded accumulator. A LATER block returns ``(o, lse)`` as they
    are."""
    if kind == LATER:
        return o, lse
    o_blk, lse_blk = flash_attention_with_lse(
        q, k_blk, v_blk, causal=kind == DIAGONAL, scale=scale,
        out_dtype=torch.float32)
    lse_new = torch.logaddexp(lse, lse_blk)
    o = (o * torch.exp(lse - lse_new)[..., None]
         + o_blk * torch.exp(lse_blk - lse_new)[..., None])
    return o, lse_new


def _local_attention(q, k, v, mask, scale):
    """One block, returning the unnormalised fp32 (o [B, Sq, H, D], m and
    l [B, H, Sq]): the running max and sum of the online softmax. ``mask``
    [Sq, Sk] (True = visible) or None."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, p.sum(dim=-1)


def einsum_ring_start(q):
    """The empty ``(o, m, l)`` of :func:`einsum_ring_block`."""
    b, s, h, d = q.shape
    return (q.new_zeros((b, s, h, d), dtype=torch.float32),
            q.new_full((b, h, s), NEG_INF, dtype=torch.float32),
            q.new_zeros((b, h, s), dtype=torch.float32))


def einsum_ring_block(q, k_blk, v_blk, state, kind, scale):
    """Attend one K/V block with dense fp32 scores and merge it into the
    online softmax ``(o, m, l)``; GQA K/V heads are repeated here, per
    block, so the ring carries the small K/V. A LATER block returns
    ``state`` as it is."""
    if kind == LATER:
        return state
    o, m, l = state
    group = q.shape[2] // k_blk.shape[2]
    if group > 1:
        k_blk = k_blk.repeat_interleave(group, dim=2)
        v_blk = v_blk.repeat_interleave(group, dim=2)
    mask = None
    if kind == DIAGONAL:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    o_blk, m_blk, l_blk = _local_attention(q, k_blk, v_blk, mask, scale)
    m_new = torch.maximum(m, m_blk)
    c_old = torch.exp(m - m_new)
    c_blk = torch.exp(m_blk - m_new)
    o = (o * c_old.transpose(1, 2)[..., None]
         + o_blk * c_blk.transpose(1, 2)[..., None])
    return o, m_new, l * c_old + l_blk * c_blk


def ring_attention_shard(q, k, v, *, process_set, causal=True, scale=None,
                         use_flash=False):
    """Ring attention on this rank's shards of one sequence.

    ``q`` is ``[batch, seq_shard, heads, head_dim]`` and ``k``/``v`` carry
    ``n_kv_heads`` heads (GQA: they must divide ``heads``); the members of
    ``process_set`` hold consecutive shards in member order. The K/V shards
    travel once around the ring, stacked in one buffer of ``n_kv_heads``
    heads (n - 1 shifts). ``use_flash`` runs each block through the flash
    kernels; ``"auto"`` resolves by the shard length, and by what the
    kernels take with an fp32 o (bf16, fp16 and fp32 q at head_dim
    1..256).
    Causal masks use
    global positions. Returns ``[batch, seq_shard, heads, head_dim]`` in
    q's dtype.
    """
    n = process_set.size()
    idx = process_set.rank_in_set(basics.rank())
    _check_gqa(q.shape[2], k.shape[2])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # the blocks write an fp32 o for the logaddexp merge (flash_ring_block)
    flash = resolve_flash(use_flash, q.shape[1], q.dtype, q.shape[-1],
                          torch.float32)
    state = flash_ring_start(q) if flash else einsum_ring_start(q)
    # after `step` shifts this rank holds the shard of member idx - step
    for step, kv in enumerate(ring_pass(torch.stack([k, v]), process_set)):
        kind = block_kind(idx, (idx - step) % n, causal)
        if flash:
            state = flash_ring_block(q, kv[0], kv[1], *state, kind, scale)
        else:
            state = einsum_ring_block(q, kv[0], kv[1], state, kind, scale)
    if flash:
        return state[0].to(q.dtype)
    o, _, l = state
    # a row with nothing visible keeps l == 0 (not reachable by causal
    # self-attention over the whole ring)
    return (o / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention_shard(q, k, v, *, process_set, causal=True,
                            scale=None, attn_fn=None, use_flash=False):
    """Ulysses attention on this rank's shards: ``[B, S/n, H, D]`` →
    all-to-all → ``[B, S, H/n, D]``, attention over the whole sequence,
    and back. ``heads`` must be divisible by n, and GQA K/V heads too
    (each rank then holds H/n query heads and H_kv/n K/V heads; the group
    structure survives because consecutive query heads share a K/V head).
    ``use_flash`` runs the local attention through the flash kernels,
    which serve the GQA group in place; the einsum route repeats K/V.
    ``attn_fn(q, k, v)`` overrides both."""
    n = process_set.size()
    b, s, h, d = q.shape
    if h % n != 0:
        raise ValueError(f"Ulysses needs heads ({h}) divisible by the "
                         f"sequence-parallel axis size ({n})")
    h_kv = k.shape[2]
    _check_gqa(h, h_kv)
    if h_kv != h and h_kv % n != 0:
        raise ValueError(
            f"Ulysses with grouped-query K/V needs K/V heads ({h_kv}) "
            f"divisible by the axis size ({n}); repeat K/V to the "
            f"query head count first for smaller head counts")
    group = h // h_kv
    if scale is None:
        scale = d ** -0.5
    qg, kg, vg = (all_to_all(x, process_set, 2, 1) for x in (q, k, v))
    if attn_fn is None and resolve_flash(use_flash, qg.shape[1], q.dtype, d):
        attn_fn = functools.partial(flash_attention, causal=causal,
                                    scale=scale)
    if attn_fn is None:
        if group > 1:
            kg = kg.repeat_interleave(group, dim=2)
            vg = vg.repeat_interleave(group, dim=2)
        mask = (torch.ones(s * n, s * n, dtype=torch.bool,
                           device=q.device).tril() if causal else None)
        og, _, l = _local_attention(qg, kg, vg, mask, scale)
        og = (og / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
    else:
        og = attn_fn(qg, kg, vg)
    return all_to_all(og, process_set, 1, 2)


def ring_attention(q, k, v, *, mesh, axis_name="sp", causal=True,
                   scale=None, use_flash=False):
    """:func:`ring_attention_shard` over this rank's line along
    ``axis_name`` of ``mesh``."""
    return ring_attention_shard(q, k, v,
                                process_set=mesh.process_set(axis_name),
                                causal=causal, scale=scale,
                                use_flash=use_flash)


def ulysses_attention(q, k, v, *, mesh, axis_name="sp", causal=True,
                      scale=None, use_flash=False):
    """:func:`ulysses_attention_shard` over this rank's line along
    ``axis_name`` of ``mesh``."""
    return ulysses_attention_shard(q, k, v,
                                   process_set=mesh.process_set(axis_name),
                                   causal=causal, scale=scale,
                                   use_flash=use_flash)
