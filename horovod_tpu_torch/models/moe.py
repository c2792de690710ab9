"""Mixture-of-Experts layer with expert parallelism (the JAX package's
``models/moe.py``): GShard's dense dispatch and combine, written as
einsums with static shapes.

- :class:`Router`: top-1 softmax gating with a capacity per expert and
  batch row, and the auxiliary load-balancing loss (GShard eq. (4):
  ``E · Σ_e mean(gates_e) · mean(mask_e)``), all in fp32.
- :class:`MoEMlp`: the expert FFN. On a mesh with an ``ep`` axis each rank
  holds ``n_experts / ep`` experts (``wi``/``wo`` split on dim 0 by
  :func:`moe_param_partition_spec`) and the tokens of its dp shard whole
  (replicated over ep). It routes every token, runs its own experts, and
  :func:`~horovod_tpu_torch.parallel.primitives.reduce_from` over ep adds
  the experts' outputs; :func:`~horovod_tpu_torch.parallel.primitives.copy_to`
  before the dispatch and on the combine weights adds up, over ep, the
  gradients that each rank's experts send to x and to the router. Those
  are the reductions XLA inserts when the JAX layer runs on a dp × ep mesh.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.convert import shard_state_dict
from horovod_tpu_torch.models.transformer import _lecun_normal_
from horovod_tpu_torch.parallel.primitives import copy_to, reduce_from


class Router(nn.Module):
    """Top-1 router with capacity (tokens per expert per batch row)."""

    def __init__(self, d_model, n_experts, capacity_factor=1.25,
                 generator=None):
        super().__init__()
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
        self.router = nn.Parameter(torch.empty(d_model, n_experts))
        _lecun_normal_(self.router, d_model, generator)

    def forward(self, x):
        """x [batch, seq, d_model] → (dispatch, combine [b, s, e, c],
        aux loss)."""
        e = self.n_experts
        gates = torch.softmax(torch.matmul(x.float(), self.router), dim=-1)
        mask = F.one_hot(gates.argmax(dim=-1), e).float()     # [b, s, e]
        # auxiliary load-balance loss (GShard)
        aux_loss = (mask.mean(dim=1) * gates.mean(dim=1)).sum(-1).mean() * e
        capacity = int(self.capacity_factor * x.shape[1] / e) or 1
        # position of each token in its expert's queue
        pos_in_expert = (torch.cumsum(mask, dim=1) - 1.0) * mask
        keep = (pos_in_expert < capacity).float() * mask
        pos = torch.einsum("bse,bse->bs", pos_in_expert, keep)
        pos_oh = F.one_hot(pos.long(), capacity).float()      # [b, s, c]
        dispatch = torch.einsum("bse,bsc->bsec", keep, pos_oh)
        gate_val = torch.einsum("bse,bse->bs", gates, keep)
        combine = dispatch * gate_val[..., None, None]
        return dispatch, combine, aux_loss


class MoEMlp(nn.Module):
    """Expert FFN: route, dispatch to expert slots, expert products
    (batched over this rank's experts), combine. Weights are drawn whole
    from ``seed`` on the CPU, then this rank keeps its ``ep`` shard of
    ``wi``/``wo`` when ``mesh`` has an ep axis."""

    def __init__(self, d_model, n_experts, d_ff, capacity_factor=1.25,
                 dtype=torch.bfloat16, *, mesh=None, seed=0, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.n_experts, self.dtype = n_experts, dtype
        self.router_block = Router(d_model, n_experts, capacity_factor, gen)
        # flax's lecun_normal counts the expert dim in the fan-in
        self.wi = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.wo = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        _lecun_normal_(self.wi, n_experts * d_model, gen)
        _lecun_normal_(self.wo, n_experts * d_ff, gen)
        self.ep, self.first_expert = None, 0
        ep = 1 if mesh is None else mesh.axis_size("ep")
        if ep > 1:
            full = {"wi": self.wi, "wo": self.wo}
            shards = shard_state_dict(full, moe_param_partition_spec(full),
                                      {"ep": ep}, mesh.coords())
            self.wi = nn.Parameter(shards["wi"])
            self.wo = nn.Parameter(shards["wo"])
            self.ep = mesh.process_set("ep")
            self.first_expert = mesh.axis_index("ep") * self.wi.shape[0]
        self.to(device)

    def forward(self, x):
        """x [batch, seq, d_model] → (out in x's dtype, aux loss)."""
        dt = self.dtype
        dispatch, combine, aux_loss = self.router_block(x)
        if self.ep is not None:
            mine = slice(self.first_expert,
                         self.first_expert + self.wi.shape[0])
            combine = copy_to(combine, self.ep)[:, :, mine]
            dispatch = dispatch[:, :, mine]
            x_in = copy_to(x, self.ep)
        else:
            x_in = x
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt),
                                 x_in.to(dt))
        h = torch.einsum("ebcd,edf->ebcf", expert_in, self.wi.to(dt))
        h = F.gelu(h, approximate="tanh")     # flax's nn.gelu
        expert_out = torch.einsum("ebcf,efd->ebcd", h, self.wo.to(dt))
        out = torch.einsum("bsec,ebcd->bsd", combine.to(dt), expert_out)
        if self.ep is not None:
            out = reduce_from(out, self.ep)
        return out.to(x.dtype), aux_loss


def moe_param_partition_spec(state_dict, ep_axis="ep", tp_axis=None):
    """``{name: spec}`` for an MoE state_dict: the expert-stacked ``wi``
    and ``wo`` (``[n_experts, ...]``) split over ``ep_axis`` on dim 0 (and
    over ``tp_axis`` on their d_ff dim, when given); everything else
    replicated."""

    def spec(name, leaf):
        last = name.split(".")[-1]
        if last == "wi" and leaf.dim() == 3:
            return (ep_axis, None, tp_axis)
        if last == "wo" and leaf.dim() == 3:
            return (ep_axis, tp_axis, None)
        return ()

    return {name: spec(name, leaf) for name, leaf in state_dict.items()}
