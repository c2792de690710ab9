"""Differentiable collectives over a process set: the port's counterparts
of the ``lax`` collectives that the JAX package's parallel modules use
inside ``shard_map``, where XLA differentiates them.

- :func:`ring_shift` (``lax.ppermute`` around a ring): each member sends to
  the next and receives from the previous; its backward shifts the other
  way.
- :func:`ring_pass`: a tensor's whole trip around the ring, n - 1 shifts,
  returning what arrived at each step. Its backward runs the n - 1 reverse
  shifts whichever of the steps' outputs this member used, so members that
  use different steps (ring attention's masked blocks) still post the same
  exchanges. A chain of ``ring_shift`` calls would not: autograd skips the
  backward of a shift whose output reaches no loss, and the members
  waiting for that shift would hang.
- :func:`all_to_all` (``lax.all_to_all(tiled=True)``): split one dim into
  one chunk per member, send chunk j to member j, concatenate what arrives
  along another dim in member order; its backward is the reverse exchange.
- :func:`copy_to` and :func:`reduce_from`, Megatron's pair (Shoeybi et
  al., 2019): ``copy_to`` is the identity forward and all-reduces the
  gradient backward (before a column-parallel product, whose input every
  member holds whole); ``reduce_from`` all-reduces forward and is the
  identity backward (after a row-parallel product, whose partial sums it
  adds).

Each takes a :class:`~horovod_tpu_torch.common.process_sets.ProcessSet`
(a mesh axis's line, ``Mesh.process_set``); on a set of one member every
one is the identity and communicates nothing. Only members call them, all
in the same order. A backward exchange runs when autograd reaches it, so
members must reach the same exchanges in the same order: their data
dependencies fix that order in the GPT, and ``ring_pass`` keeps it where
members use different outputs. A backend failure raises
``HorovodInternalError``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.collective_ops import _collective


def _shift(x, process_set, shift):
    members = process_set.global_ranks()
    n = len(members)
    i = process_set.rank_in_set(basics.rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    group = process_set.group()
    works = _collective(dist.batch_isend_irecv, [
        dist.P2POp(dist.isend, x, members[(i + shift) % n], group),
        dist.P2POp(dist.irecv, out, members[(i - shift) % n], group)])
    for w in works:
        _collective(w.wait)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set, shift):
        ctx.process_set, ctx.shift = process_set, shift
        return _shift(x, process_set, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.process_set, -ctx.shift), None, None


def ring_shift(x, process_set, shift=1):
    """Member i of ``process_set`` sends ``x`` to member (i + shift) mod n
    and returns what member (i - shift) mod n sent. One send and one
    receive, posted together (``batch_isend_irecv``). Every member must
    backpropagate through the result, or the others wait for its reverse
    shift; a chain whose later steps some members leave unused is
    :func:`ring_pass`."""
    if process_set.size() == 1:
        return x
    return _RingShift.apply(x, process_set, shift)


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set):
        ctx.process_set = process_set
        steps = [x.view_as(x)]
        for _ in range(process_set.size() - 1):
            steps.append(_shift(steps[-1], process_set, 1))
        return tuple(steps)

    @staticmethod
    def backward(ctx, *grads):
        # step t's tensor reached step t + 1 by a shift: walk back from the
        # last step, adding each step's own gradient on the way
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = _shift(acc, ctx.process_set, -1) + g
        return acc, None


def ring_pass(x, process_set):
    """The trip of ``x`` around the ring of ``process_set``: a tuple whose
    entry t is what member i holds after t shifts, member (i - t) mod n's
    ``x`` (entry 0 is ``x``). n - 1 shifts forward, n - 1 backward."""
    if process_set.size() == 1:
        return (x,)
    return _RingPass.apply(x, process_set)


def _exchange(x, process_set, split_dim, concat_dim):
    n = process_set.size()
    split_dim %= x.dim()
    concat_dim %= x.dim()
    length = x.shape[split_dim]
    if length % n:
        raise ValueError(f"all_to_all splits dim {split_dim} of size "
                         f"{length} into {n} equal chunks")
    # [n, length / n, ...]: chunk j is the j-th block of the split dim
    send = x.movedim(split_dim, 0).reshape(
        (n, length // n) + tuple(x.movedim(split_dim, 0).shape[1:]))
    send = send.contiguous()
    recv = torch.empty_like(send)
    _collective(dist.all_to_all_single, recv, send,
                group=process_set.group())
    # recv[j] came from member j: put the split dim back, then concatenate
    # the member blocks along concat_dim, member j's block j-th
    recv = recv.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(x.shape)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return recv.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set, split_dim, concat_dim):
        ctx.args = process_set, split_dim, concat_dim
        return _exchange(x, process_set, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        process_set, split_dim, concat_dim = ctx.args
        return (_exchange(grad, process_set, concat_dim, split_dim), None,
                None, None)


def all_to_all(x, process_set, split_dim, concat_dim):
    """Split ``split_dim`` of ``x`` into one equal chunk per member, send
    chunk j to member j, and concatenate the chunks that arrive along
    ``concat_dim`` in member order (``all_to_all_single``)."""
    if process_set.size() == 1:
        return x
    return _AllToAll.apply(x, process_set, split_dim, concat_dim)


def _all_reduce(x, process_set):
    out = x.clone(memory_format=torch.contiguous_format)
    _collective(dist.all_reduce, out, group=process_set.group())
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set):
        ctx.process_set = process_set
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.process_set), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set):
        return _all_reduce(x, process_set)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x, process_set):
    """Identity forward; the gradient is summed over ``process_set``
    backward."""
    if process_set.size() == 1:
        return x
    return _CopyTo.apply(x, process_set)


def reduce_from(x, process_set):
    """Sum ``x`` over ``process_set`` forward; identity backward."""
    if process_set.size() == 1:
        return x
    return _ReduceFrom.apply(x, process_set)
