"""Decoder-only transformer (GPT), ported from
``horovod_tpu/models/transformer.py``.

Embedding → N × (RMSNorm → rotary GQA attention → RMSNorm → gelu MLP) →
RMSNorm → tied fp32 logits. Parameters are stored in fp32 in the flax
layouts of the JAX model, so weights carry across unchanged
(:mod:`horovod_tpu_torch.models.convert`): ``q``/``k``/``v`` are
``(d_model, heads, head_dim)``, ``o`` is ``(heads, head_dim, d_model)``,
``up``/``down`` are ``(in, out)``. Each product casts its weight to
``cfg.dtype``; RMSNorm, softmax and the logits run in fp32, as in the
reference. Plain large products stay ``torch.matmul``; attention runs the
port's flash kernels when ``use_flash`` resolves true.

On a mesh (``GPT(cfg, mesh=...)``, :mod:`horovod_tpu_torch.parallel.mesh`)
the model holds this rank's shards, Megatron style, by the rules of
:func:`param_partition_spec`: q/k/v and ``up`` column-parallel (heads and
d_ff over ``tp``), ``o`` and ``down`` row-parallel, with
:func:`~horovod_tpu_torch.parallel.primitives.copy_to` before the
column-parallel products and
:func:`~horovod_tpu_torch.parallel.primitives.reduce_from` after the
row-parallel ones, and the embedding sharded over the vocab, so the tied
logits come out as this rank's ``[..., vocab / tp]`` slice. With
``cfg.ring_mesh`` the tokens are this rank's sequence shard, positions are
global, and attention runs ring attention over the ``sp`` axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.convert import shard_state_dict
from horovod_tpu_torch.ops.flash_attention import (flash_attention,
                                                   resolve_flash)
from horovod_tpu_torch.parallel.primitives import copy_to, reduce_from
from horovod_tpu_torch.parallel.sequence import ring_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    # Grouped-query attention: K/V head count; None → n_heads (MHA). Must
    # divide n_heads. The flash kernels read the shared K/V heads directly;
    # the einsum path repeats them to n_heads.
    n_kv_heads: Optional[int] = None
    d_ff: int = 1024
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # recompute each block in the backward pass
    # False = einsum-softmax attention; True = the flash kernels; "auto" =
    # resolve_flash's choice by sequence length, dtype and head_dim.
    use_flash: Union[bool, str] = False
    # Ring-attention sequence parallelism: the parallel.mesh.Mesh the model
    # runs under (its 'sp' axis carries the sequence shards). Attention then
    # runs parallel/sequence.ring_attention over this rank's sp line, with
    # the flash kernels per block when use_flash resolves true for the
    # shard length.
    ring_mesh: Optional[object] = None


def _rotary(x, positions):
    """Rotary position embeddings (fp32 phase math); each head is split in
    half, not interleaved."""
    half = x.shape[-1] // 2
    # made on x's device (a host copy would stall the host on every layer);
    # float64 as the reference's numpy, then fp32
    freqs = (1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float64,
                                             device=x.device) / half))).float()
    angles = positions[..., None].float() * freqs              # [.., seq, half]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _repeat_kv(k, v, group):
    """Broadcast GQA K/V heads to the query head count (no-op for MHA)."""
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=-2),
            v.repeat_interleave(group, dim=-2))


def _lecun_normal_(param, fan_in, generator):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(param, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        n_kv = cfg.n_kv_heads or cfg.n_heads
        if cfg.n_heads % n_kv:
            raise ValueError(f"n_kv_heads ({n_kv}) must divide n_heads "
                             f"({cfg.n_heads})")
        hd = cfg.d_model // cfg.n_heads
        self.q = nn.Parameter(torch.empty(cfg.d_model, cfg.n_heads, hd))
        self.k = nn.Parameter(torch.empty(cfg.d_model, n_kv, hd))
        self.v = nn.Parameter(torch.empty(cfg.d_model, n_kv, hd))
        self.o = nn.Parameter(torch.empty(cfg.n_heads, hd, cfg.d_model))
        for w in (self.q, self.k, self.v):
            _lecun_normal_(w, cfg.d_model, generator)
        _lecun_normal_(self.o, cfg.n_heads * hd, generator)
        # on a mesh GPT sets this rank's tp line, its index on it, and
        # whether K/V stay whole because their heads do not divide over tp
        self.tp, self.tp_rank, self.replicated_kv = None, 0, False

    @staticmethod
    def _project(x, w, dtype):
        """x [..., d] · w [d, heads, head_dim] → [..., heads, head_dim]."""
        out = torch.matmul(x, w.to(dtype).reshape(w.shape[0], -1))
        return out.view(*x.shape[:-1], *w.shape[1:])

    def forward(self, x, positions):
        cfg, dt = self.cfg, self.cfg.dtype
        head_dim = cfg.d_model // cfg.n_heads
        wk, wv = self.k, self.v
        if self.tp is not None:
            x = copy_to(x, self.tp)
            if self.replicated_kv:  # each rank's gradient of them is partial
                wk, wv = copy_to(wk, self.tp), copy_to(wv, self.tp)
        q = _rotary(self._project(x, self.q, dt), positions)
        k = _rotary(self._project(x, wk, dt), positions)
        v = self._project(x, wv, dt)
        if self.replicated_kv:  # this rank's query heads' K/V, repeated
            h = self.q.shape[1]
            k, v = (t.repeat_interleave(cfg.n_heads // t.shape[-2], dim=-2)
                    [..., self.tp_rank * h:(self.tp_rank + 1) * h, :]
                    for t in (k, v))
        scale = 1.0 / math.sqrt(head_dim)
        if cfg.ring_mesh is not None:
            # GQA K/V go round the ring unrepeated
            out = ring_attention(q, k, v, mesh=cfg.ring_mesh, causal=True,
                                 scale=scale, use_flash=cfg.use_flash)
        elif resolve_flash(cfg.use_flash, q.shape[-3], q.dtype, head_dim):
            # the kernels read the shared GQA K/V heads directly
            out = flash_attention(q, k, v, causal=True, scale=scale)
        else:
            k, v = _repeat_kv(k, v, q.shape[-2] // k.shape[-2])
            scores = torch.einsum("...qhd,...khd->...hqk", q.float(),
                                  k.float()) / math.sqrt(head_dim)
            causal = (positions[..., None, :] <= positions[..., :, None])
            scores = scores.masked_fill(~causal[..., None, :, :], -1e30)
            probs = torch.softmax(scores, dim=-1).to(dt)
            out = torch.einsum("...hqk,...khd->...qhd", probs, v)
        out = out.reshape(*out.shape[:-2], -1)
        out = torch.matmul(out, self.o.to(dt).reshape(-1, cfg.d_model))
        return out if self.tp is None else reduce_from(out, self.tp)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.up = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff))
        self.down = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model))
        _lecun_normal_(self.up, cfg.d_model, generator)
        _lecun_normal_(self.down, cfg.d_ff, generator)
        self.tp = None      # this rank's tp line, set by GPT on a mesh

    def forward(self, x):
        dt = self.cfg.dtype
        if self.tp is not None:
            x = copy_to(x, self.tp)
        # flax's nn.gelu is the tanh approximation
        h = F.gelu(torch.matmul(x, self.up.to(dt)), approximate="tanh")
        out = torch.matmul(h, self.down.to(dt))
        return out if self.tp is None else reduce_from(out, self.tp)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model)
        self.attn = Attention(cfg, generator)
        self.ln2 = RMSNorm(cfg.d_model)
        self.mlp = MLP(cfg, generator)

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """GPT with random weights drawn from ``seed`` on the CPU (so a seed
    gives the same weights on every device), then moved to ``device``:
    CUDA by default, which raises when there is none unless
    ``device="cpu"`` is passed.

    ``mesh`` (default ``cfg.ring_mesh``): the weights are drawn whole, so a
    seed gives the same global model on any mesh, and this rank keeps its
    ``tp`` shards by :func:`param_partition_spec`. A mesh whose ``sp`` axis
    has more than one rank needs ``cfg.ring_mesh``, the same mesh."""

    def __init__(self, cfg: GPTConfig, *, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        mesh = cfg.ring_mesh if mesh is None else mesh
        if cfg.ring_mesh is not None and mesh is not cfg.ring_mesh:
            raise ValueError("GPT(mesh=...) must be cfg.ring_mesh when "
                             "both are given")
        if mesh is not None and mesh.axis_size("sp") > 1 \
                and cfg.ring_mesh is None:
            raise ValueError("a mesh with an sp axis shards the sequence: "
                             "set cfg.ring_mesh to it")
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size,
                                                  cfg.d_model))
        nn.init.normal_(self.embedding, std=0.02, generator=gen)
        self.blocks = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model)
        self.tp = None
        tp = 1 if mesh is None else mesh.axis_size("tp")
        if tp > 1:
            self._keep_tp_shards(mesh, tp)
        self.to(device)

    def _keep_tp_shards(self, mesh, tp):
        """Replace every parameter by this rank's tp shard."""
        full = dict(self.named_parameters())
        specs = param_partition_spec(full, tp_size=tp)
        shards = shard_state_dict(full, specs, {"tp": tp},
                                  {"tp": mesh.axis_index("tp")})
        for name, shard in shards.items():
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner) if owner else self, leaf,
                    nn.Parameter(shard))
        self.tp = mesh.process_set("tp")
        self.tp_rank = mesh.axis_index("tp")
        for block in self.blocks:
            block.attn.tp = block.mlp.tp = self.tp
            block.attn.tp_rank = self.tp_rank
            block.attn.replicated_kv = bool(
                (self.cfg.n_kv_heads or self.cfg.n_heads) % tp)

    def _embed(self, tokens):
        """The embedding rows of ``tokens``; over a vocab-sharded table,
        each rank looks up the tokens in its slice and ``reduce_from``
        adds the slices (one term is non-zero)."""
        if self.tp is None:
            return self.embedding[tokens]
        rows = self.embedding.shape[0]
        local = tokens - self.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        x = self.embedding[local.clamp(0, rows - 1)] * inside[..., None]
        return reduce_from(x, self.tp)

    def forward(self, tokens, return_hidden: bool = False):
        """Logits ``[..., seq, vocab]`` in fp32 (on a tp mesh this rank's
        ``[..., seq, vocab / tp]`` slice), or with ``return_hidden=True``
        the final post-norm hidden states. Under ``cfg.ring_mesh``
        ``tokens`` is this rank's sequence shard and positions are
        global."""
        cfg = self.cfg
        seq = tokens.shape[-1]
        first = 0 if cfg.ring_mesh is None \
            else cfg.ring_mesh.axis_index("sp") * seq
        positions = torch.arange(first, first + seq,
                                 device=tokens.device).expand(tokens.shape)
        x = self._embed(tokens).to(cfg.dtype)
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.ln_f(x)
        if return_hidden:
            return x
        x = x.float()
        if self.tp is not None:
            x = copy_to(x, self.tp)
        return torch.matmul(x, self.embedding.t())


def param_partition_spec(state_dict, *, tp_axis="tp", tp_size=None):
    """Megatron tensor parallelism: ``{name: spec}``, where a spec is a
    tuple with one entry per dim, ``tp_axis`` on the dim to shard and None
    elsewhere, or ``()`` for a replicated tensor (the tuples of the JAX
    function's ``PartitionSpec`` objects).

    Column-parallel: q/k/v (``(d_model, heads, head_dim)``) shard their
    heads and ``up`` its output dim; row-parallel: ``o``
    (``(heads, head_dim, d_model)``) and ``down`` shard their input dim.
    The embedding shards the vocab dim; norm scales replicate. With
    ``tp_size``, a head count it does not divide (GQA/MQA K/V with
    ``n_kv_heads < tp``) replicates, Megatron's MQA layout."""

    def spec_for(name, leaf):
        names = name.split(".")
        if "embedding" in names:
            return (tp_axis, None)
        if any(n in ("q", "k", "v") for n in names):
            if tp_size and leaf.shape[1] % tp_size:
                return ()
            return (None, tp_axis, None)
        if "o" in names:
            return (tp_axis, None, None)
        if "up" in names:
            return (None, tp_axis)
        if "down" in names:
            return (tp_axis, None)
        return ()

    return {name: spec_for(name, leaf) for name, leaf in state_dict.items()}
