"""Collective operations on ``torch.distributed`` (Horovod's
``torch/mpi_ops.py``; the JAX package's ``ops/collective_ops.py``):
allreduce, grouped allreduce, allgather, broadcast, alltoall,
reducescatter, barrier, their in-place and ``*_async`` forms, and
``synchronize`` / ``poll`` on the handles those return.

Each call is a collective over a process set (the global one by default):
NCCL on the GPU, gloo on the CPU. Every member of the set makes the same
calls in the same order, and a non-member's call raises ``ValueError``
(``common/process_sets.py``). A collective that the backend fails (a peer
lost, or one stalled past the process group's timeout) raises
``HorovodInternalError``, as Horovod's torch ops do; NCCL may instead abort
the process, as its watchdog decides. After ``basics.abort`` every
collective raises ``HorovodInternalError`` before it is issued.

The synchronous out-of-place forms (:func:`allreduce`, :func:`allgather`,
:func:`broadcast`, :func:`alltoall`, :func:`reducescatter`) are
differentiable, as the torch binding's ``autograd.Function`` s are
(``horovod_tpu/torch/mpi_ops.py``): the gradient of an allreduce is the
allreduce of the cotangent with the same op and scales; of an allgather,
this rank's rows of the summed cotangent; of a broadcast, the summed
cotangent on the root and zeros elsewhere; of an alltoall, the alltoall of
the cotangent back along the received splits; of a reducescatter, the
allgather of the cotangent, scaled as the forward was. The in-place forms
and the ``*_async`` handles are not differentiable.

Async calls return a :class:`Handle` that wraps the backend's ``Work``
objects and keeps the input and output buffers alive. ``synchronize`` does
the post-processing (the Average division, trimming a ragged allgather,
the grouped allreduce's decompression). On NCCL a finished ``Work`` only
makes the current stream wait for the collective, so the result is ready
for work queued on the current stream, as any PyTorch result is.
Allgather and alltoall exchange their sizes before the data, so their
``*_async`` forms return once the sizes are known.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HorovodTimeoutError)
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops.compression import Compression


class ReduceOp:
    """Reduction op constants (Horovod's ``torch/mpi_ops.py:48-56``)."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"hvt.{self.name}"


Average = ReduceOp("Average")
Sum = ReduceOp("Sum")
Adasum = ReduceOp("Adasum")
Min = ReduceOp("Min")
Max = ReduceOp("Max")
Product = ReduceOp("Product")

_DIST_OP = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
            Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
            Product: dist.ReduceOp.PRODUCT}
_MAX_DIMS = 8     # the shape exchange of a ragged allgather


def _resolve_op(op, average):
    """Horovod keeps the deprecated ``average=`` beside ``op=``."""
    if op is not None and average is not None:
        raise ValueError("specify either op= or average=, not both")
    if op is None:
        return Average if average is None or average else Sum
    if op is not Adasum and op not in _DIST_OP:
        raise ValueError(f"unknown reduce op {op}")
    return op


def _collective(fn, *args, **kwargs):
    reason = basics.aborted()
    if reason is not None:      # basics.abort() tore the world down
        raise HorovodInternalError(f"{fn.__name__}: the process group was "
                                   f"aborted: {reason}")
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        # an abort from another thread may fail the call in other ways
        if isinstance(e, RuntimeError) or basics.aborted() is not None:
            raise HorovodInternalError(f"{fn.__name__} failed: {e}") from e
        raise


def _wait(work):
    """Wait for a backend ``Work``. On the CPU the wait polls, so that
    ``basics.abort`` from another thread (the elastic driver's word that a
    peer died) fails it at once: gloo does not release a collective in
    flight when its group is aborted. On NCCL ``wait`` only orders the
    current stream after the collective."""
    if basics.device().type == "cpu":
        delay = 1e-5
        while not work.is_completed():
            if basics.aborted() is not None:
                raise HorovodInternalError(
                    f"the process group was aborted: {basics.aborted()}")
            time.sleep(delay)
            delay = min(2 * delay, 1e-3)
    work.wait()


def _blocking(fn, *args, **kwargs):
    """``fn`` issued asynchronously and waited for by :func:`_wait`."""
    _collective(_wait, _collective(fn, *args, async_op=True, **kwargs))


def _scale_(t, factor):
    """``t *= factor`` in place. An integer tensor takes only an integral
    factor: the product must fit its dtype."""
    if factor == 1.0:
        return t
    if t.is_floating_point():
        return t.mul_(factor)
    if factor != int(factor):
        raise TypeError(f"an integer tensor cannot be scaled in place by "
                        f"{factor}")
    return t.mul_(int(factor))


def _average(t, n):
    """Average's division after the sum: in place for a floating tensor;
    an integer tensor gives the float mean, as the JAX package's pmean
    does."""
    return t.div_(n) if t.is_floating_point() else t / n


class Handle:
    """An async collective in flight. ``synchronize(handle)`` waits for it
    and returns its result; ``poll(handle)`` says whether it is done."""

    def __init__(self, works, finish):
        self._works = list(works)     # the backend's Work objects
        self._finish = finish         # result from the finished buffers
        self._result = None

    def done(self) -> bool:
        return self._finish is None or all(w.is_completed()
                                           for w in self._works)

    def wait(self, timeout=None):
        """Block until the collective completes and return its result.
        With ``timeout`` (seconds), raise ``HorovodTimeoutError`` if it is
        still pending then; the handle stays waitable."""
        if self._finish is None:
            return self._result
        if timeout is not None:
            deadline = time.monotonic() + timeout
            while not self.done():
                if time.monotonic() >= deadline:
                    raise HorovodTimeoutError(
                        f"collective still pending after {timeout} s")
                time.sleep(1e-3)
        for w in self._works:
            _collective(_wait, w)
        self._result, self._finish, self._works = self._finish(), None, []
        return self._result


def _done(result) -> Handle:
    h = Handle([], None)
    h._result = result
    return h


def synchronize(handle, timeout=None):
    """Wait for an async handle and return its output
    (``torch/mpi_ops.py:823``). A backend failure raises
    ``HorovodInternalError``; with ``timeout`` (seconds) a collective still
    pending at the deadline raises ``HorovodTimeoutError`` and the handle
    stays waitable."""
    return handle.wait(timeout=timeout)


def poll(handle) -> bool:
    """True once the async op has completed (``torch/mpi_ops.py:807``);
    never blocks."""
    return handle.done()


# --------------------------------------------------------------------------
# allreduce
# --------------------------------------------------------------------------

def _allreduce_start(buf, op, prescale, postscale, process_set,
                     segments=None):
    """Reduce ``buf`` (owned by the caller, may be reduced in place) and
    return a Handle whose result is the reduced tensor. Adasum combines
    each of the flat ``segments`` (lengths; default the whole tensor) with
    its own coefficients. Over a set of one process every op but Adasum is
    the identity with the scales applied, so nothing is sent: the result is
    ready at once, as the JAX package's single-process path is, and a
    one-process step holds no collective (which a CUDA graph can then
    capture)."""
    group = process_set.group()
    n = process_set.size()
    _scale_(buf, prescale)
    if op is Adasum:
        from horovod_tpu_torch.ops.adasum import adasum_reduce_flat

        out = adasum_reduce_flat(buf.reshape(-1), segments or [buf.numel()],
                                 process_set).view(buf.shape)
        return _done(_scale_(out, postscale))

    def finish():
        out = _average(buf, n) if op is Average else buf
        return _scale_(out, postscale)

    if n == 1:
        return _done(finish())
    work = _collective(dist.all_reduce, buf, op=_DIST_OP[op], group=group,
                       async_op=True)
    return Handle([work], finish)


def _own_copy(tensor):
    """A contiguous copy that the collective may overwrite, out of the
    autograd graph."""
    return tensor.detach().clone(memory_format=torch.contiguous_format)


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set):
    """Start :func:`allreduce`; returns a handle (``torch/mpi_ops.py:130``).
    ``tensor`` is left as it was."""
    del name
    return _allreduce_start(_own_copy(tensor), _resolve_op(op, average),
                            prescale_factor, postscale_factor, process_set)


class _Allreduce(torch.autograd.Function):
    """The gradient is the allreduce of the cotangent with the same op and
    scales (``horovod_tpu/torch/mpi_ops.py:112``)."""

    @staticmethod
    def forward(ctx, tensor, op, prescale, postscale, process_set):
        ctx.args = (op, prescale, postscale, process_set)
        return allreduce_async(tensor, op=op, prescale_factor=prescale,
                               postscale_factor=postscale,
                               process_set=process_set).wait()

    @staticmethod
    def backward(ctx, grad):
        return (_Allreduce.apply(grad, *ctx.args),) + (None,) * 4


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set):
    """Reduce ``tensor`` across the set's processes:
    ``postscale · reduce_op(prescale · tensor)``, where Average is the sum
    divided by the set's size, and Adasum the scale-invariant combine of
    ``ops/adasum.py``. An integer tensor under Average gives the float
    mean. Differentiable. ``name`` is accepted for API parity."""
    del name
    return _Allreduce.apply(tensor, _resolve_op(op, average),
                            prescale_factor, postscale_factor, process_set)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               process_set=global_process_set):
    """:func:`allreduce` in place; returns ``tensor``. An integer tensor
    under Average raises ``TypeError``: it cannot hold the mean."""
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=global_process_set):
    """Start :func:`allreduce_`; returns a handle whose result is
    ``tensor``, reduced in place (``torch/mpi_ops.py:96``)."""
    del name
    op = _check_in_place(tensor, _resolve_op(op, average))
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()
    h = _allreduce_start(buf, op, prescale_factor, postscale_factor,
                         process_set)
    return _then(h, lambda out: _copy_into(tensor, out))


def _check_in_place(tensor, op):
    if op is Average and not tensor.is_floating_point():
        raise TypeError(f"an in-place allreduce cannot average a "
                        f"{tensor.dtype} tensor; use allreduce, which "
                        "returns the float mean")
    return op


def _copy_into(tensor, out):
    if out is not tensor:
        tensor.copy_(out)
    return tensor


def _then(handle, fn):
    """A handle on the same collective whose result is ``fn`` of
    ``handle``'s."""
    return Handle(handle._works, lambda: fn(handle.wait()))


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set,
                            compression=Compression.none):
    """Start :func:`grouped_allreduce`; returns a handle."""
    del name
    op = _resolve_op(op, average)
    tensors = list(tensors)
    wires = [compression.compress(t.detach()) for t in tensors]
    buckets = {}        # (device, wire dtype) -> indices, in order
    for i, (wire, _) in enumerate(wires):
        buckets.setdefault((wire.device, wire.dtype), []).append(i)
    parts = []
    for idx in buckets.values():
        flat = torch.cat([wires[i][0].reshape(-1) for i in idx])
        parts.append((idx, _allreduce_start(
            flat, op, prescale_factor, postscale_factor, process_set,
            segments=[wires[i][0].numel() for i in idx])))

    def finish():       # the parts' Work objects are already waited for
        out = [None] * len(tensors)
        for idx, h in parts:
            flat, offset = h.wait(), 0
            for i in idx:
                wire, ctx = wires[i]
                out[i] = compression.decompress(
                    flat[offset:offset + wire.numel()].view(wire.shape), ctx)
                offset += wire.numel()
        return out

    return Handle([w for _, h in parts for w in h._works], finish)


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set,
                      compression=Compression.none):
    """Reduce a list of tensors as one fused unit: one flat buffer and one
    collective per (device, wire dtype) (Horovod's tensor fusion).
    ``compression`` casts each tensor for the wire and back. Adasum's
    coefficients stay per tensor. Returns the reduced tensors in order."""
    return synchronize(grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set, compression=compression))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=global_process_set,
                             compression=Compression.none):
    """Start :func:`grouped_allreduce_`; returns a handle whose result is
    ``tensors``, each reduced in place (``torch/mpi_ops.py:181``)."""
    tensors = list(tensors)
    op = _resolve_op(op, average)
    for t in tensors:
        _check_in_place(t, op)
    h = grouped_allreduce_async(
        tensors, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        compression=compression)
    return _then(h, lambda outs: [_copy_into(t, o)
                                  for t, o in zip(tensors, outs)])


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=global_process_set,
                       compression=Compression.none):
    """:func:`grouped_allreduce` in place; returns ``tensors``. An integer
    tensor under Average raises ``TypeError``, as :func:`allreduce_`
    does."""
    return synchronize(grouped_allreduce_async_(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set, compression=compression))


# --------------------------------------------------------------------------
# allgather
# --------------------------------------------------------------------------

def _allgather_start(tensor, process_set):
    """(Handle of the gathered tensor, every member's dim-0 rows)."""
    group = process_set.group()
    n = process_set.size()
    t = tensor.detach()
    t = (t.reshape(1) if t.dim() == 0 else t).contiguous()
    if t.dim() > _MAX_DIMS:
        raise ValueError(f"allgather takes at most {_MAX_DIMS} dims")
    shape = torch.tensor([t.dim(), *t.shape] + [0] * (_MAX_DIMS - t.dim()),
                         dtype=torch.int64, device=t.device)
    shapes = torch.empty(n * (1 + _MAX_DIMS), dtype=torch.int64,
                         device=t.device)
    _blocking(dist.all_gather_into_tensor, shapes, shape, group=group)
    shapes = shapes.view(n, 1 + _MAX_DIMS).tolist()
    rows = [s[1] for s in shapes]
    if any(s[0] != t.dim() or s[2:1 + t.dim()] != list(t.shape[1:])
           for s in shapes):
        raise ValueError(f"allgather needs the same dims after dim 0 on "
                         f"every rank; got shapes "
                         f"{[s[1:1 + s[0]] for s in shapes]}")
    m = max(rows)
    if m != t.shape[0]:        # pad to the largest, trim after
        t = torch.cat([t, t.new_zeros((m - t.shape[0],) + t.shape[1:])])
    out = t.new_empty((n * m,) + t.shape[1:])
    work = _collective(dist.all_gather_into_tensor, out, t, group=group,
                       async_op=True)

    def finish():
        if all(r == m for r in rows):
            return out
        return torch.cat([out[i * m:i * m + r] for i, r in enumerate(rows)])

    return Handle([work], finish), rows


def allgather_async(tensor, name=None, process_set=global_process_set):
    """Start :func:`allgather`. The shapes are exchanged before this
    returns; the data moves asynchronously."""
    del name
    return _allgather_start(tensor, process_set)[0]


class _Allgather(torch.autograd.Function):
    """The gradient is this rank's rows of the cotangent summed over the
    set (``horovod_tpu/torch/mpi_ops.py:225``)."""

    @staticmethod
    def forward(ctx, tensor, process_set):
        handle, rows = _allgather_start(tensor, process_set)
        ctx.shape, ctx.process_set, ctx.rows = tensor.shape, process_set, rows
        return handle.wait()

    @staticmethod
    def backward(ctx, grad):
        ps = ctx.process_set
        total = _Allreduce.apply(grad, Sum, 1.0, 1.0, ps)
        r = ps.rank_in_set(basics.rank())
        mine = total.narrow(0, sum(ctx.rows[:r]), ctx.rows[r])
        return mine.reshape(ctx.shape), None


def allgather(tensor, name=None, process_set=global_process_set):
    """Concatenate ``tensor`` from the set's processes along dim 0, in rank
    order (``torch/mpi_ops.py:502``). Dim 0 may differ per rank, as in the
    engine's allgatherv; the other dims must match. Differentiable."""
    del name
    return _Allgather.apply(tensor, process_set)


def grouped_allgather_async(tensors, name=None,
                            process_set=global_process_set):
    """Start :func:`grouped_allgather`; returns a handle whose result is
    the list (``torch/mpi_ops.py:254``)."""
    del name
    handles = [allgather_async(t, process_set=process_set) for t in tensors]
    return Handle([w for h in handles for w in h._works],
                  lambda: [h.wait() for h in handles])


def grouped_allgather(tensors, name=None, process_set=global_process_set):
    """:func:`allgather` of each tensor; returns the list."""
    return synchronize(grouped_allgather_async(tensors, name=name,
                                               process_set=process_set))


# --------------------------------------------------------------------------
# broadcast
# --------------------------------------------------------------------------

def broadcast_async_(tensor, root_rank, name=None,
                     process_set=global_process_set):
    """Start :func:`broadcast_`; returns a handle whose result is
    ``tensor``."""
    del name
    if root_rank not in process_set.global_ranks():
        raise ValueError(f"root_rank {root_rank} is not in {process_set}")
    group = process_set.group()
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()
    work = _collective(dist.broadcast, buf, src=root_rank, group=group,
                       async_op=True)

    def finish():
        if buf is not tensor:
            tensor.copy_(buf)
        return tensor

    return Handle([work], finish)


def broadcast_async(tensor, root_rank=0, name=None,
                    process_set=global_process_set):
    """Start :func:`broadcast`; returns a handle."""
    return broadcast_async_(_own_copy(tensor), root_rank, name=name,
                            process_set=process_set)


class _Broadcast(torch.autograd.Function):
    """The gradient is the cotangent summed over the set on the root and
    zeros elsewhere (``horovod_tpu/torch/mpi_ops.py:297``)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, process_set):
        ctx.root_rank, ctx.process_set = root_rank, process_set
        return broadcast_async(tensor, root_rank,
                               process_set=process_set).wait()

    @staticmethod
    def backward(ctx, grad):
        total = _Allreduce.apply(grad, Sum, 1.0, 1.0, ctx.process_set)
        if basics.rank() != ctx.root_rank:
            total = torch.zeros_like(total)
        return total, None, None


def broadcast_(tensor, root_rank, name=None, process_set=global_process_set):
    """Overwrite ``tensor`` on every member with ``root_rank``'s, in place.
    ``root_rank`` is a global rank and must be a member of the set."""
    return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                        process_set=process_set))


def broadcast(tensor, root_rank=0, name=None,
              process_set=global_process_set):
    """Out-of-place :func:`broadcast_`. Differentiable."""
    del name
    return _Broadcast.apply(tensor, root_rank, process_set)


# --------------------------------------------------------------------------
# alltoall
# --------------------------------------------------------------------------

def _alltoall_start(tensor, splits, process_set):
    """A handle whose result is ``(output, received_splits)``, whatever
    ``splits`` is."""
    group = process_set.group()
    n = process_set.size()
    t = tensor.detach().contiguous()
    if splits is None:
        if t.shape[0] % n:
            raise ValueError(
                f"alltoall without splits requires dim 0 ({t.shape[0]}) "
                f"divisible by the number of participants ({n})")
        splits = [t.shape[0] // n] * n
    else:
        splits = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                                   else splits)]
        if len(splits) != n or min(splits) < 0 or sum(splits) != t.shape[0]:
            raise ValueError(
                f"alltoall splits {splits} must be {n} non-negative counts "
                f"that sum to dim 0 ({t.shape[0]})")
    send = torch.tensor(splits, dtype=torch.int64, device=t.device)
    recv = torch.empty_like(send)
    _blocking(dist.all_to_all_single, recv, send, group=group)
    recv_splits = recv.tolist()
    out = t.new_empty((sum(recv_splits),) + t.shape[1:])
    work = _collective(dist.all_to_all_single, out, t,
                       output_split_sizes=recv_splits,
                       input_split_sizes=splits, group=group, async_op=True)
    return Handle([work], lambda: (out, torch.tensor(recv_splits)))


def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set):
    """Start :func:`alltoall`; its result follows :func:`alltoall`'s rule
    (the output alone without ``splits``). The receive splits are
    exchanged before this returns; the data moves asynchronously."""
    del name
    h = _alltoall_start(tensor, splits, process_set)
    return h if splits is not None else _then(h, lambda pair: pair[0])


class _Alltoall(torch.autograd.Function):
    """The gradient is the alltoall of the cotangent back along the
    received splits (``horovod_tpu/torch/mpi_ops.py:345``)."""

    @staticmethod
    def forward(ctx, tensor, splits, process_set):
        out, recv_splits = _alltoall_start(tensor, splits,
                                           process_set).wait()
        ctx.recv_splits, ctx.process_set = recv_splits, process_set
        ctx.mark_non_differentiable(recv_splits)
        return out, recv_splits

    @staticmethod
    def backward(ctx, grad, _):
        back, _ = _Alltoall.apply(grad, ctx.recv_splits, ctx.process_set)
        return back, None, None


def alltoall(tensor, splits=None, name=None, process_set=global_process_set):
    """Send ``splits[j]`` consecutive dim-0 rows of ``tensor`` to the set's
    j-th member and concatenate what each member sent here, in rank order
    (``torch/mpi_ops.py:710``). Without ``splits`` dim 0 is split evenly
    and the output alone is returned; with ``splits``, ``(output,
    received_splits)``, the splits a CPU int64 tensor: the torch binding's
    rule (``horovod_tpu/torch/mpi_ops.py:366-372``). Differentiable in the
    output."""
    del name
    out, recv_splits = _Alltoall.apply(tensor, splits, process_set)
    return out if splits is None else (out, recv_splits)


# --------------------------------------------------------------------------
# reducescatter
# --------------------------------------------------------------------------

def _reducescatter_start(tensor, op, process_set, prescale_factor,
                         postscale_factor):
    op = Average if op is None else op
    if op not in _DIST_OP:
        raise ValueError(f"reducescatter does not support {op}")
    group = process_set.group()
    n = process_set.size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(f"reducescatter dim 0 of shape {tuple(tensor.shape)}"
                         f" must divide by the set's size ({n})")
    buf = _scale_(_own_copy(tensor), prescale_factor)
    out = buf.new_empty((buf.shape[0] // n,) + buf.shape[1:])
    work = _collective(dist.reduce_scatter_tensor, out, buf,
                       op=_DIST_OP[op], group=group, async_op=True)

    def finish():
        # gloo completes this work only inside its wait(), so it is waited
        # for here and never polled
        _collective(work.wait)
        return _scale_(_average(out, n) if op is Average else out,
                       postscale_factor)

    h = Handle([], finish)
    h._input = buf      # alive until the collective completes
    return h


def reducescatter_async(tensor, op=None, name=None,
                        process_set=global_process_set,
                        prescale_factor=1.0, postscale_factor=1.0):
    """Start :func:`reducescatter`; returns a handle
    (``torch/mpi_ops.py:375``)."""
    del name
    return _reducescatter_start(tensor, op, process_set, prescale_factor,
                                postscale_factor)


class _Reducescatter(torch.autograd.Function):
    """The gradient is the allgather of the cotangent, scaled as the
    forward was: the pre- and postscale, and 1/size for Average
    (``horovod_tpu/torch/mpi_ops.py:387``)."""

    @staticmethod
    def forward(ctx, tensor, op, process_set, prescale, postscale):
        ctx.process_set = process_set
        ctx.scale = prescale * postscale / (
            process_set.size() if op in (None, Average) else 1)
        return _reducescatter_start(tensor, op, process_set, prescale,
                                    postscale).wait()

    @staticmethod
    def backward(ctx, grad):
        return (_Allgather.apply(grad, ctx.process_set) * ctx.scale,
                None, None, None, None)


def reducescatter(tensor, op=None, name=None, process_set=global_process_set,
                  prescale_factor=1.0, postscale_factor=1.0):
    """Reduce across the set and give the i-th member the i-th of ``size``
    equal dim-0 slices of the result. Dim 0 must divide by the set's size.
    Average divides by the set's size after the sum; pre/postscale as in
    :func:`allreduce`. An integer tensor under Average gives the float
    mean. Differentiable."""
    del name
    return _Reducescatter.apply(tensor, op, process_set, prescale_factor,
                                postscale_factor)


def grouped_reducescatter(tensors, op=None, name=None,
                          process_set=global_process_set):
    """:func:`reducescatter` of each tensor; returns the list."""
    del name
    return [reducescatter(t, op=op, process_set=process_set)
            for t in tensors]


def barrier(process_set=global_process_set):
    """Block until every member of the set reaches this call."""
    _blocking(dist.barrier, group=process_set.group())

