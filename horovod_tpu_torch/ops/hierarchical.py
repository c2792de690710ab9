"""Hierarchical allreduce and allgather (the JAX package's
``ops/hierarchical.py``; Horovod's NCCLHierarchicalAllreduce,
``ops/nccl_operations.cc:188-350``).

The JAX package's two mesh axes become two families of process groups,
built from each rank's ``local_rank`` and ``cross_rank``: a "local" group
per host (the ranks with one ``cross_rank``) and a "cross" group per local
slot (the ranks with one ``local_rank``). Allreduce is a reduce-scatter
over local, an allreduce of one 1/local_size slice over cross, and an
allgather over local, so each host sends 1/local_size of the bytes across
hosts. Ranks must be host-major (rank = cross_rank · local_size +
local_rank), as the ``hvtrun`` launcher assigns them. The groups are made
on first use, collectively, so every process makes its first hierarchical
call together.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import collective_ops as C


def _new_group(ranks):
    return dist.group.WORLD if ranks == list(range(basics.size())) \
        else dist.new_group(ranks)


def _groups():
    """(local group, cross group, local size, cross size) of this rank."""
    world = basics._world()
    if "hierarchical" not in world.groups:
        n, L, Cs = basics.size(), basics.local_size(), basics.cross_size()
        me = torch.tensor([[basics.cross_rank(), basics.local_rank()]],
                          device=basics.device())
        coords = [tuple(c) for c in C.allgather(me).tolist()]
        if L * Cs != n or coords != [divmod(r, L) for r in range(n)]:
            raise ValueError(
                f"hierarchical collectives need a homogeneous, host-major "
                f"job (rank = cross_rank * local_size + local_rank); got "
                f"(cross_rank, local_rank) {coords} with local_size {L}, "
                f"cross_size {Cs}")
        # new_group is collective: every process makes every group
        local = [_new_group(list(range(c * L, (c + 1) * L)))
                 for c in range(Cs)]
        cross = [_new_group(list(range(l, n, L))) for l in range(L)]
        world.groups["hierarchical"] = (local[basics.cross_rank()],
                                        cross[basics.local_rank()], L, Cs)
    return world.groups["hierarchical"]


def hierarchical_allreduce(tensor, average=False):
    """Allreduce ``tensor`` over every process by reduce-scatter over
    local, allreduce over cross and allgather over local. The same sum as
    ``allreduce(op=Sum)`` (divided by the world size when ``average``; an
    integer tensor then gives the float mean); the flat tensor is
    zero-padded to a multiple of the local size and unpadded after."""
    local, cross, L, Cs = _groups()
    flat = tensor.detach().reshape(-1)
    n = flat.numel()
    pad = (-n) % L
    flat = torch.cat([flat, flat.new_zeros(pad)]) if pad \
        else flat.contiguous()
    piece = flat.new_empty(flat.numel() // L)
    C._collective(dist.reduce_scatter_tensor, piece, flat, group=local)
    C._collective(dist.all_reduce, piece, group=cross)
    full = flat.new_empty(flat.numel())
    C._collective(dist.all_gather_into_tensor, full, piece, group=local)
    full = full[:n].view(tensor.shape)
    return full / (L * Cs) if average else full


def hierarchical_allgather(tensor):
    """Gather ``tensor`` (the same shape on every rank) across hosts, then
    within the host; concatenated along dim 0 in global rank order."""
    local, cross, L, Cs = _groups()
    t = tensor.detach()
    flat = t.reshape(-1).contiguous()
    over_cross = flat.new_empty(Cs * flat.numel())
    C._collective(dist.all_gather_into_tensor, over_cross, flat, group=cross)
    over_both = flat.new_empty(L * over_cross.numel())
    C._collective(dist.all_gather_into_tensor, over_both, over_cross,
                  group=local)
    # [local, cross, ...] -> global rank order, rank = cross * L + local
    return over_both.view((L, Cs) + t.shape).transpose(0, 1).reshape(
        (-1,) + t.shape[1:])
