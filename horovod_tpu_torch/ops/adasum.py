"""Adasum: the scale-invariant combine of gradients (Horovod's
``common/ops/adasum/adasum.h``; the JAX package's ``ops/adasum.py``).

For two gradients a, b::

    adasum(a, b) = (1 - a·b / (2‖a‖²)) a  +  (1 - a·b / (2‖b‖²)) b

applied over a binary tree of the set's members: at level k each member
trades its current vector with the member 2^k away (``batch_isend_irecv``),
and both compute the same combine. After log2(n) levels every member holds
the Adasum of all of them. Dot products and norms are fp32 whatever the
input dtype. The JAX package rebuilds the partner's vector as ``(a + b) -
mine`` from one pairwise psum; the port receives it whole, so the two
differ by the rounding of that subtraction (the parity tests hold them to
rtol 1e-5).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.process_sets import global_process_set


def pairwise_adasum(a, b):
    """The pairwise combine in fp32, with the zero-norm guards of
    ``adasum.h:372-383``; returns ``a``'s dtype."""
    af, bf = a.float(), b.float()
    dot, a_sq, b_sq = (af * bf).sum(), (af * af).sum(), (bf * bf).sum()
    ca = torch.where(a_sq > 0, 1.0 - dot / (2.0 * a_sq), 1.0)
    cb = torch.where(b_sq > 0, 1.0 - dot / (2.0 * b_sq), 1.0)
    return (ca * af + cb * bf).to(a.dtype)


def start_level_from_env() -> int:
    """``HVT_ADASUM_START_LEVEL``: an integer, or ``local`` for the local
    size (levels inside a host average, the ones across hosts combine);
    1 when unset."""
    raw = os.environ.get("HVT_ADASUM_START_LEVEL", "1")
    if raw == "local":
        return basics.local_size()
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"HVT_ADASUM_START_LEVEL must be an integer or "
                         f"'local', got {raw!r}") from None


def _exchange(v, peer, group):
    """Send ``v`` to global rank ``peer`` and receive its vector."""
    recv = torch.empty_like(v)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, v, peer, group),
                                    dist.P2POp(dist.irecv, recv, peer,
                                               group)])
    for w in works:
        w.wait()
    return recv


def adasum_reduce_flat(flat, sizes, process_set=global_process_set,
                       start_level=None):
    """Adasum over the set of each segment of the 1-D ``flat`` (segment
    lengths ``sizes``), with one exchange a level for all segments: the
    coefficients are per segment, as for separate tensors.

    Levels whose stride 2^k is below ``start_level`` take the pair's plain
    average instead (``adasum.h:177-183``); ``None`` reads
    ``HVT_ADASUM_START_LEVEL``. The set's size must be a power of two."""
    n = process_set.size()
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-two number of "
                         f"processes, got {n}")
    group = process_set.group()
    if n == 1:
        return flat
    if start_level is None:
        start_level = start_level_from_env()
    start_level = max(1, int(start_level))
    ranks = process_set.global_ranks()
    me = process_set.rank_in_set(basics.rank())
    v = flat.float()
    for k in range(n.bit_length() - 1):
        stride = 1 << k
        other = _exchange(v.contiguous(), ranks[me ^ stride], group)
        if stride < start_level:
            v = 0.5 * (v + other)
            continue
        # both members sum the same products in the same order, so they
        # compute the same coefficients and stay bit-identical
        mine, theirs = v.split(sizes), other.split(sizes)
        dot = torch.stack([(a * b).sum() for a, b in zip(mine, theirs)])
        my_sq = torch.stack([(a * a).sum() for a in mine])
        their_sq = torch.stack([(b * b).sum() for b in theirs])
        cv = torch.where(my_sq > 0, 1.0 - dot / (2.0 * my_sq), 1.0)
        co = torch.where(their_sq > 0, 1.0 - dot / (2.0 * their_sq), 1.0)
        reps = torch.tensor(sizes, device=v.device)
        v = cv.repeat_interleave(reps) * v + co.repeat_interleave(reps) * other
    return v.to(flat.dtype)


def adasum_reduce(t, process_set=global_process_set, start_level=None):
    """Adasum-combine ``t`` across the set (``adasum.h:194-336``); a set
    of one returns ``t`` unchanged."""
    return adasum_reduce_flat(t.reshape(-1), [t.numel()], process_set,
                              start_level).view(t.shape)
