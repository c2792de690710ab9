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

Every eager collective, sync or async, grouped or not, is counted in
``hvt_collective_bytes_total{op,process_set}`` and timed in
``hvt_collective_latency_seconds{op,process_set}`` (the JAX package's
families, ``horovod_tpu_torch.metrics``). On CUDA the latency is the span
between two CUDA events on the issuing stream, one recorded before the
collective is issued and one after it is waited for, resolved off this
thread by ``utils/timeline.py``'s drainer: no host sync is added. On gloo
the wait blocks, so the host clock gives the completion time. A collective
issued under CUDA-graph capture is counted once in
``hvt_traced_collectives_total{op}`` and not timed. With a timeline
recording, each collective also writes its spans (``utils/timeline.py``).

:func:`join` is Horovod's answer to uneven inputs, with the JAX engine's
semantics (``horovod_tpu/csrc/engine.cc``): a rank out of data calls it,
and until every rank has, the others' collectives on the global set proceed
with the joined ranks' stand-ins (zeros for an allreduce, whose Average
still divides by the set's size; zero rows for an allgather; zero splits
for an alltoall). The port has no coordinator, so each collective on the
global set of a world of more than one process is preceded by a header: a
small allreduce (sum) on the same group, 1 and the collective's descriptor
(op, dtype, shape, reduce op or root) from each active rank, zeros from a
joined one. Active ranks never read it back; a joined rank, idle in
:func:`join`, reads each header and issues the same call with its
stand-in, until a header sums to no active rank.
"""

from __future__ import annotations

import threading
import time
import weakref

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HorovodTimeoutError)
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.utils import timeline


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


# --------------------------------------------------------------------------
# dispatch telemetry (horovod_tpu_torch.metrics, utils/timeline.py)
# --------------------------------------------------------------------------

_LATENCY_HELP = (
    "eager collective latency, issue to completion: on CUDA the span "
    "between CUDA events recorded on the issuing stream before the "
    "collective is issued and after it is waited for (its queueing and its "
    "run as that stream sees them); on gloo the host clock")
_dispatch_metrics = None    # (registry, its three families)


def _metric_handles():
    global _dispatch_metrics
    from horovod_tpu_torch import metrics

    reg = metrics.registry()
    if _dispatch_metrics is None or _dispatch_metrics[0] is not reg:
        _dispatch_metrics = (reg, (
            reg.histogram("hvt_collective_latency_seconds", _LATENCY_HELP,
                          ("op", "process_set")),
            reg.counter("hvt_collective_bytes_total",
                        "payload bytes submitted to eager collectives",
                        ("op", "process_set")),
            reg.counter("hvt_traced_collectives_total",
                        "collectives issued under CUDA-graph capture "
                        "(counted per capture, not per replay)", ("op",))))
    return _dispatch_metrics[1]


def _ps_label(process_set) -> str:
    ranks = getattr(process_set, "ranks", None) if process_set else None
    if ranks is None:
        return "global"
    return ",".join(str(r) for r in sorted(int(r) for r in ranks))


def _nbytes(tensors) -> int:
    if tensors is None:
        return 0
    if torch.is_tensor(tensors):
        return tensors.numel() * tensors.element_size()
    return sum(_nbytes(t) for t in tensors)


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class _Timed:
    """One eager collective from its issue until its handle is waited
    for."""

    __slots__ = ("op", "ps", "lane", "nbytes", "t0", "wall0", "event",
                 "device", "__weakref__")


_in_flight = weakref.WeakSet()     # _Timed of handles not yet waited for
_in_flight_lock = threading.Lock()  # collectives run from several threads


def _begin(op_name, process_set, tensors, name=None, device=None):
    """Count and start timing one eager collective; None for a joined
    rank's stand-in and under graph capture (counted there in
    ``hvt_traced_collectives_total``)."""
    if _join.serving:
        return None
    _, bytes_total, traced = _metric_handles()
    device = basics.device() if device is None else device
    if _capturing(device):
        traced.labels(op=op_name).inc()
        return None
    t = _Timed()
    t.op, t.ps, t.lane = op_name, _ps_label(process_set), name or op_name
    t.nbytes, t.device = _nbytes(tensors), device
    bytes_total.labels(op=op_name, process_set=t.ps).inc(t.nbytes)
    t.t0, t.wall0 = time.monotonic(), timeline.now_us()
    t.event = (timeline.drainer.start_event(device)
               if device.type == "cuda" else None)
    with _in_flight_lock:
        _in_flight.add(t)
    return t


def _end(t):
    """The collective ``t`` times was waited for: on gloo observe its
    latency now; on CUDA record the end event and leave the pair to the
    drainer."""
    if t is None:
        return
    with _in_flight_lock:
        if t not in _in_flight:
            return
        _in_flight.discard(t)
    hist = _metric_handles()[0].labels(op=t.op, process_set=t.ps)
    wall1 = timeline.now_us()
    args = {"op": t.op, "bytes": t.nbytes, "process_set": t.ps}
    op = t.op.upper()
    if t.event is None:
        hist.observe(time.monotonic() - t.t0)
        timeline.span(t.lane, f"GLOO_{op}", t.wall0, wall1 - t.wall0,
                      dict(args, clock="host"))
        return
    timeline.span(t.lane, f"EAGER_{op}", t.wall0, wall1 - t.wall0, args)
    timeline.drainer.submit(t.event, t.device, f"{t.lane} (device)",
                            f"NCCL_{op}", dict(args, clock="cuda_event"),
                            hist.observe, t.t0)


def pending() -> list:
    """This rank's collectives not yet complete: the handles not yet waited
    for, and the collectives waited for whose end event the card has not
    reached. Each with its name, op, process set and age in seconds."""
    now = time.monotonic()
    with _in_flight_lock:
        in_flight = list(_in_flight)
    out = [{"name": t.lane, "op": t.op, "process_set": t.ps,
            "age_sec": now - t.t0, "waited": False} for t in in_flight]
    if torch.cuda.is_available():
        out += [{"name": p.lane.rsplit(" (device)", 1)[0],
                 "op": p.args["op"], "process_set": p.args["process_set"],
                 "age_sec": now - p.t_issue, "waited": True}
                for p in timeline.drainer.unresolved()]
    return sorted(out, key=lambda d: -d["age_sec"])


# --------------------------------------------------------------------------
# join's headers (see the module docstring)
# --------------------------------------------------------------------------

_OP_CODES = ("allreduce", "allgather", "broadcast", "alltoall",
             "reducescatter", "barrier")
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
           torch.bool)
_WIRE_OPS = (dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX,
             dist.ReduceOp.PRODUCT)
_WIRE_CODE = {Average: 0, Sum: 0, Min: 1, Max: 2, Product: 3}
_CODE_OP = (Sum, Min, Max, Product)     # _WIRE_CODE's inverse
# [active, op, dtype, reduce op or root, ndim, dims...]
_HEADER_LEN = 5 + _MAX_DIMS
_HEADER_CACHE_MAX = 256


class _JoinState:
    def __init__(self):
        self.joined = False     # this rank is inside join()
        self.serving = False    # ... issuing a stand-in
        self.headers = 0        # global headers this world has issued
        self.cache = {}         # (device, descriptor) -> header tensor


_join = _JoinState()


def _reset_join():
    """A new world starts with no header issued (``basics.init``)."""
    global _join
    _join = _JoinState()


def _header_tensor(desc, device):
    """A fresh copy of the header for ``desc``. On CUDA the first is copied
    from pinned memory without blocking and cached, so an active rank never
    waits on the card for a header."""
    key = (device, desc)
    cached = _join.cache.get(key)
    if cached is None:
        cached = torch.tensor(desc, dtype=torch.int64)
        if device.type == "cuda":
            cached = cached.pin_memory().to(device, non_blocking=True)
        if len(_join.cache) >= _HEADER_CACHE_MAX:
            _join.cache.clear()
        _join.cache[key] = cached
    return cached.clone()


def _announce(op_name, process_set, tensor=None, arg=0, rows=True):
    """Issue the header of a collective about to be issued on the global
    set; returns its ``Work``, or None when no header is sent (a world of
    one, another set, a joined rank's stand-in, graph capture). ``tensor``
    gives the dtype and shape: the whole shape flattened when ``rows`` (an
    allreduce, broadcast or reducescatter, where only the element count
    matters), else the dims after dim 0 (an allgather or alltoall, whose
    rows differ by rank)."""
    if process_set.ranks is not None or _join.serving \
            or basics.size() == 1:
        return None
    device = basics.device()
    if _capturing(device):
        return None
    desc = [1, _OP_CODES.index(op_name) + 1, 0, arg, 0] + [0] * _MAX_DIMS
    if tensor is not None:
        desc[2] = _DTYPES.index(tensor.dtype) + 1 \
            if tensor.dtype in _DTYPES else 0
        shape = [tensor.numel()] if rows else [0, *tensor.shape[1:]]
        if len(shape) > _MAX_DIMS:
            raise ValueError(f"{op_name} takes at most {_MAX_DIMS} dims")
        desc[4] = len(shape)
        desc[5:5 + len(shape)] = shape
    header = _header_tensor(tuple(desc), device)
    _join.headers += 1
    return _collective(dist.all_reduce, header,
                       group=global_process_set.group(), async_op=True)


def _stand_in(desc, active):
    """As a joined rank, issue with zeros the collective that the
    ``active`` ranks announced: the sum of their descriptors is ``active``
    times each."""
    if any(v % active for v in desc):
        raise HorovodInternalError(
            f"join: the active ranks announced different collectives "
            f"(descriptor sum {desc} over {active} ranks)")
    op_code, dtype_code, arg, ndim, *dims = [v // active for v in desc]
    op = _OP_CODES[op_code - 1]
    group = global_process_set.group()
    _join.serving = True
    try:
        if op == "barrier":
            _blocking(dist.barrier, group=group)
            return
        if dtype_code == 0:
            raise HorovodInternalError(f"join: cannot stand in for a {op} "
                                       "of this dtype")
        zeros = torch.zeros(dims[:ndim], dtype=_DTYPES[dtype_code - 1],
                            device=basics.device())
        if op == "allreduce":
            plan = _wire_plan(zeros, _CODE_OP[arg], global_process_set)
            if plan is not None:
                from horovod_tpu_torch.ops import hierarchical

                hierarchical.compressed_allreduce(zeros, global_process_set,
                                                  plan, op=_CODE_OP[arg])
            else:
                _blocking(dist.all_reduce, zeros, op=_WIRE_OPS[arg],
                          group=group)
        elif op == "broadcast":
            _blocking(dist.broadcast, zeros, src=arg, group=group)
        elif op == "reducescatter":
            out = zeros.new_empty(zeros.numel() // basics.size())
            _blocking(dist.reduce_scatter_tensor, out, zeros,
                      op=_WIRE_OPS[arg], group=group)
        elif op == "allgather":
            _allgather_start(zeros, global_process_set)[0].wait()
        else:
            _alltoall_start(zeros, [0] * basics.size(),
                            global_process_set).wait()
    finally:
        _join.serving = False


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

    def __init__(self, works, finish, timing=None):
        # the backend's Work objects (a header's among them)
        self._works = [w for w in works if w is not None]
        self._finish = finish         # result from the finished buffers
        self._result = None
        self._timing = timing         # _Timed, ended by wait()

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
        _end(self._timing)
        return self._result


def _done(result, timing=None) -> Handle:
    h = Handle([], None)
    h._result = result
    _end(timing)
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


def wire_compression() -> tuple:
    """The wire-codec pair of this process as ``(intra, inter)`` codec
    names (``"none"``, ``"bf16"``, ``"int8"`` or ``"fp8"``): the codec an
    fp32 allreduce moves between processes of one host and across hosts,
    e.g. ``("none", "int8")`` under ``HVT_WIRE_COMPRESSION=none,int8``,
    ``("none", "none")`` by default. Under ``auto`` the inter codec is the
    tuner's latest pick (``horovod_tpu_torch.compression.auto_active()``
    tells). Distinct from ``hvt.Compression`` (a cast before the
    collective): wire codecs are transparent to callers, with per-tensor
    error feedback (``HVT_ERROR_FEEDBACK``) compensating the quantization.
    Every process of a job must be given the same spec."""
    from horovod_tpu_torch import compression

    return compression.wire_pair()


# --------------------------------------------------------------------------
# allreduce
# --------------------------------------------------------------------------

def _wire_plan(buf, op, process_set):
    """The compressed route of this allreduce (``ops/hierarchical.py``),
    or None: every fp32 allreduce but Adasum whose wire codec is lossy
    takes it, as the engine's ``WireEligible`` (``csrc/engine.cc:2148``,
    the one gate of its stamping, error feedback and tuner) takes them.
    Min, Max and Product decode each peer's chunk and then reduce by the
    op, as the ring's ``ReduceFromWire`` does (``csrc/ring_ops.cc:82``), so
    their results are quantized as the reference's are."""
    if op is Adasum or buf.dtype != torch.float32 or buf.numel() == 0:
        return None
    from horovod_tpu_torch.ops import hierarchical

    return hierarchical.wire_plan(process_set)


def _allreduce_start(buf, op, prescale, postscale, process_set,
                     segments=None, name=None, timed=True, names=None):
    """Reduce ``buf`` (owned by the caller, may be reduced in place) and
    return a Handle whose result is the reduced tensor. Adasum combines
    each of the flat ``segments`` (lengths; default the whole tensor) with
    its own coefficients; ``names`` name them for error feedback. Over a
    set of one process every op but Adasum is the identity with the scales
    applied, so nothing is sent: the result is ready at once, as the JAX
    package's single-process path is, and a one-process step holds no
    collective (which a CUDA graph can then capture). An fp32 allreduce
    but Adasum under a lossy wire codec takes the compressed route, which
    is done when this returns. ``timed`` counts and times it as an
    ``allreduce``; a grouped allreduce times its parts as one."""
    group = process_set.group()
    n = process_set.size()
    timing = _begin("allreduce", process_set, buf, name,
                    buf.device) if timed else None
    _scale_(buf, prescale)
    if op is Adasum:
        from horovod_tpu_torch.ops.adasum import adasum_reduce_flat

        out = adasum_reduce_flat(buf.reshape(-1), segments or [buf.numel()],
                                 process_set).view(buf.shape)
        return _done(_scale_(out, postscale), timing)

    def finish():
        out = _average(buf, n) if op is Average else buf
        return _scale_(out, postscale)

    if n == 1:
        return _done(finish(), timing)
    header = _announce("allreduce", process_set, buf, arg=_WIRE_CODE[op])
    plan = _wire_plan(buf, op, process_set)
    if plan is not None:
        from horovod_tpu_torch.ops import hierarchical

        hierarchical.compressed_allreduce(
            buf, process_set, plan, names=names or [name or "allreduce"],
            segments=segments or [buf.numel()],
            op=Sum if op is Average else op)
        if header is not None:
            _collective(_wait, header)
        return _done(finish(), timing)
    work = _collective(dist.all_reduce, buf, op=_DIST_OP[op], group=group,
                       async_op=True)
    return Handle([header, work], finish, timing)


def _own_copy(tensor):
    """A contiguous copy that the collective may overwrite, out of the
    autograd graph."""
    return tensor.detach().clone(memory_format=torch.contiguous_format)


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set):
    """Start :func:`allreduce`; returns a handle (``torch/mpi_ops.py:130``).
    ``tensor`` is left as it was. ``name`` names its timeline lane."""
    return _allreduce_start(_own_copy(tensor), _resolve_op(op, average),
                            prescale_factor, postscale_factor, process_set,
                            name=name)


class _Allreduce(torch.autograd.Function):
    """The gradient is the allreduce of the cotangent with the same op and
    scales (``horovod_tpu/torch/mpi_ops.py:112``)."""

    @staticmethod
    def forward(ctx, tensor, op, prescale, postscale, process_set,
                name=None):
        ctx.args = (op, prescale, postscale, process_set)
        return allreduce_async(tensor, name=name, op=op,
                               prescale_factor=prescale,
                               postscale_factor=postscale,
                               process_set=process_set).wait()

    @staticmethod
    def backward(ctx, grad):
        return (_Allreduce.apply(grad, *ctx.args),) + (None,) * 5


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set):
    """Reduce ``tensor`` across the set's processes:
    ``postscale · reduce_op(prescale · tensor)``, where Average is the sum
    divided by the set's size, and Adasum the scale-invariant combine of
    ``ops/adasum.py``. An integer tensor under Average gives the float
    mean. Differentiable. ``name`` names the timeline lane."""
    return _Allreduce.apply(tensor, _resolve_op(op, average),
                            prescale_factor, postscale_factor, process_set,
                            name)


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
    op = _check_in_place(tensor, _resolve_op(op, average))
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()
    h = _allreduce_start(buf, op, prescale_factor, postscale_factor,
                         process_set, name=name)
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
    """Start :func:`grouped_allreduce`; returns a handle. The parts are
    counted and timed as one ``grouped_allreduce``."""
    op = _resolve_op(op, average)
    tensors = list(tensors)
    timing = _begin("grouped_allreduce", process_set, tensors, name,
                    tensors[0].device if tensors else None)
    wires = [compression.compress(t.detach()) for t in tensors]
    buckets = {}        # (device, wire dtype) -> indices, in order
    for i, (wire, _) in enumerate(wires):
        buckets.setdefault((wire.device, wire.dtype), []).append(i)
    parts = []
    base = name or "grouped_allreduce"
    for idx in buckets.values():
        flat = torch.cat([wires[i][0].reshape(-1) for i in idx])
        parts.append((idx, _allreduce_start(
            flat, op, prescale_factor, postscale_factor, process_set,
            segments=[wires[i][0].numel() for i in idx], timed=False,
            names=[f"{base}.{i}" for i in idx])))

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

    return Handle([w for _, h in parts for w in h._works], finish, timing)


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

def _allgather_start(tensor, process_set, name=None):
    """(Handle of the gathered tensor, every member's dim-0 rows)."""
    group = process_set.group()
    n = process_set.size()
    t = tensor.detach()
    t = (t.reshape(1) if t.dim() == 0 else t).contiguous()
    if t.dim() > _MAX_DIMS:
        raise ValueError(f"allgather takes at most {_MAX_DIMS} dims")
    timing = _begin("allgather", process_set, t, name, t.device)
    header = _announce("allgather", process_set, t, rows=False)
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

    return Handle([header, work], finish, timing), rows


def allgather_async(tensor, name=None, process_set=global_process_set):
    """Start :func:`allgather`. The shapes are exchanged before this
    returns; the data moves asynchronously."""
    return _allgather_start(tensor, process_set, name)[0]


class _Allgather(torch.autograd.Function):
    """The gradient is this rank's rows of the cotangent summed over the
    set (``horovod_tpu/torch/mpi_ops.py:225``)."""

    @staticmethod
    def forward(ctx, tensor, process_set, name=None):
        handle, rows = _allgather_start(tensor, process_set, name)
        ctx.shape, ctx.process_set, ctx.rows = tensor.shape, process_set, rows
        return handle.wait()

    @staticmethod
    def backward(ctx, grad):
        ps = ctx.process_set
        total = _Allreduce.apply(grad, Sum, 1.0, 1.0, ps)
        r = ps.rank_in_set(basics.rank())
        mine = total.narrow(0, sum(ctx.rows[:r]), ctx.rows[r])
        return mine.reshape(ctx.shape), None, None


def allgather(tensor, name=None, process_set=global_process_set):
    """Concatenate ``tensor`` from the set's processes along dim 0, in rank
    order (``torch/mpi_ops.py:502``). Dim 0 may differ per rank, as in the
    engine's allgatherv; the other dims must match. Differentiable."""
    return _Allgather.apply(tensor, process_set, name)


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
    if root_rank not in process_set.global_ranks():
        raise ValueError(f"root_rank {root_rank} is not in {process_set}")
    group = process_set.group()
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()
    timing = _begin("broadcast", process_set, buf, name, buf.device)
    header = _announce("broadcast", process_set, buf, arg=root_rank)
    work = _collective(dist.broadcast, buf, src=root_rank, group=group,
                       async_op=True)

    def finish():
        if buf is not tensor:
            tensor.copy_(buf)
        return tensor

    return Handle([header, work], finish, timing)


def broadcast_async(tensor, root_rank=0, name=None,
                    process_set=global_process_set):
    """Start :func:`broadcast`; returns a handle."""
    return broadcast_async_(_own_copy(tensor), root_rank, name=name,
                            process_set=process_set)


class _Broadcast(torch.autograd.Function):
    """The gradient is the cotangent summed over the set on the root and
    zeros elsewhere (``horovod_tpu/torch/mpi_ops.py:297``)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, process_set, name=None):
        ctx.root_rank, ctx.process_set = root_rank, process_set
        return broadcast_async(tensor, root_rank, name=name,
                               process_set=process_set).wait()

    @staticmethod
    def backward(ctx, grad):
        total = _Allreduce.apply(grad, Sum, 1.0, 1.0, ctx.process_set)
        if basics.rank() != ctx.root_rank:
            total = torch.zeros_like(total)
        return total, None, None, None


def broadcast_(tensor, root_rank, name=None, process_set=global_process_set):
    """Overwrite ``tensor`` on every member with ``root_rank``'s, in place.
    ``root_rank`` is a global rank and must be a member of the set."""
    return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                        process_set=process_set))


def broadcast(tensor, root_rank=0, name=None,
              process_set=global_process_set):
    """Out-of-place :func:`broadcast_`. Differentiable."""
    return _Broadcast.apply(tensor, root_rank, process_set, name)


# --------------------------------------------------------------------------
# alltoall
# --------------------------------------------------------------------------

def _alltoall_start(tensor, splits, process_set, name=None):
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
    timing = _begin("alltoall", process_set, t, name, t.device)
    header = _announce("alltoall", process_set, t, rows=False)
    send = torch.tensor(splits, dtype=torch.int64, device=t.device)
    recv = torch.empty_like(send)
    _blocking(dist.all_to_all_single, recv, send, group=group)
    recv_splits = recv.tolist()
    out = t.new_empty((sum(recv_splits),) + t.shape[1:])
    work = _collective(dist.all_to_all_single, out, t,
                       output_split_sizes=recv_splits,
                       input_split_sizes=splits, group=group, async_op=True)
    return Handle([header, work], lambda: (out, torch.tensor(recv_splits)),
                  timing)


def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set):
    """Start :func:`alltoall`; its result follows :func:`alltoall`'s rule
    (the output alone without ``splits``). The receive splits are
    exchanged before this returns; the data moves asynchronously."""
    h = _alltoall_start(tensor, splits, process_set, name)
    return h if splits is not None else _then(h, lambda pair: pair[0])


class _Alltoall(torch.autograd.Function):
    """The gradient is the alltoall of the cotangent back along the
    received splits (``horovod_tpu/torch/mpi_ops.py:345``)."""

    @staticmethod
    def forward(ctx, tensor, splits, process_set, name=None):
        out, recv_splits = _alltoall_start(tensor, splits, process_set,
                                           name).wait()
        ctx.recv_splits, ctx.process_set = recv_splits, process_set
        ctx.mark_non_differentiable(recv_splits)
        return out, recv_splits

    @staticmethod
    def backward(ctx, grad, _):
        back, _ = _Alltoall.apply(grad, ctx.recv_splits, ctx.process_set)
        return back, None, None, None


def alltoall(tensor, splits=None, name=None, process_set=global_process_set):
    """Send ``splits[j]`` consecutive dim-0 rows of ``tensor`` to the set's
    j-th member and concatenate what each member sent here, in rank order
    (``torch/mpi_ops.py:710``). Without ``splits`` dim 0 is split evenly
    and the output alone is returned; with ``splits``, ``(output,
    received_splits)``, the splits a CPU int64 tensor: the torch binding's
    rule (``horovod_tpu/torch/mpi_ops.py:366-372``). Differentiable in the
    output."""
    out, recv_splits = _Alltoall.apply(tensor, splits, process_set, name)
    return out if splits is None else (out, recv_splits)


# --------------------------------------------------------------------------
# reducescatter
# --------------------------------------------------------------------------

def _reducescatter_start(tensor, op, process_set, prescale_factor,
                         postscale_factor, name=None):
    op = Average if op is None else op
    if op not in _DIST_OP:
        raise ValueError(f"reducescatter does not support {op}")
    group = process_set.group()
    n = process_set.size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(f"reducescatter dim 0 of shape {tuple(tensor.shape)}"
                         f" must divide by the set's size ({n})")
    timing = _begin("reducescatter", process_set, tensor, name,
                    tensor.device)
    buf = _scale_(_own_copy(tensor), prescale_factor)
    out = buf.new_empty((buf.shape[0] // n,) + buf.shape[1:])
    header = _announce("reducescatter", process_set, buf,
                       arg=_WIRE_CODE[op])
    work = _collective(dist.reduce_scatter_tensor, out, buf,
                       op=_DIST_OP[op], group=group, async_op=True)

    def finish():
        # gloo completes this work only inside its wait(), so it is waited
        # for here and never polled
        _collective(work.wait)
        return _scale_(_average(out, n) if op is Average else out,
                       postscale_factor)

    h = Handle([header], finish, timing)
    h._input = buf      # alive until the collective completes
    return h


def reducescatter_async(tensor, op=None, name=None,
                        process_set=global_process_set,
                        prescale_factor=1.0, postscale_factor=1.0):
    """Start :func:`reducescatter`; returns a handle
    (``torch/mpi_ops.py:375``)."""
    return _reducescatter_start(tensor, op, process_set, prescale_factor,
                                postscale_factor, name)


class _Reducescatter(torch.autograd.Function):
    """The gradient is the allgather of the cotangent, scaled as the
    forward was: the pre- and postscale, and 1/size for Average
    (``horovod_tpu/torch/mpi_ops.py:387``)."""

    @staticmethod
    def forward(ctx, tensor, op, process_set, prescale, postscale,
                name=None):
        ctx.process_set = process_set
        ctx.scale = prescale * postscale / (
            process_set.size() if op in (None, Average) else 1)
        return _reducescatter_start(tensor, op, process_set, prescale,
                                    postscale, name).wait()

    @staticmethod
    def backward(ctx, grad):
        return (_Allgather.apply(grad, ctx.process_set) * ctx.scale,
                None, None, None, None, None)


def reducescatter(tensor, op=None, name=None, process_set=global_process_set,
                  prescale_factor=1.0, postscale_factor=1.0):
    """Reduce across the set and give the i-th member the i-th of ``size``
    equal dim-0 slices of the result. Dim 0 must divide by the set's size.
    Average divides by the set's size after the sum; pre/postscale as in
    :func:`allreduce`. An integer tensor under Average gives the float
    mean. Differentiable."""
    return _Reducescatter.apply(tensor, op, process_set, prescale_factor,
                                postscale_factor, name)


def grouped_reducescatter(tensors, op=None, name=None,
                          process_set=global_process_set):
    """:func:`reducescatter` of each tensor; returns the list."""
    del name
    return [reducescatter(t, op=op, process_set=process_set)
            for t in tensors]


def barrier(process_set=global_process_set):
    """Block until every member of the set reaches this call."""
    timing = _begin("barrier", process_set, None)
    header = _announce("barrier", process_set)
    _blocking(dist.barrier, group=process_set.group())
    if header is not None:
        _collective(_wait, header)
    _end(timing)


# --------------------------------------------------------------------------
# join
# --------------------------------------------------------------------------

def join(device=None) -> int:
    """Signal that this process has exhausted its data; until every rank
    has joined, the others' collectives on the global set proceed with this
    rank's stand-ins (zeros for an allreduce, whose Average still divides by
    the set's size; zero rows for an allgather; zero splits for an
    alltoall). Returns the last rank to join, the same on every rank, so
    every worker can e.g. broadcast final state from it (Horovod's
    ``torch/mpi_ops.py:846``; the JAX engine's ``JoinOp``).

    The last rank is the one that joined after the most global-set
    collectives; ranks that joined after the same number are ordered by
    the launcher-aligned clock at which they called ``join``, then by
    rank. ``device`` is accepted for API parity. A world of one returns 0
    at once. Not covered: collectives on another process set (the joined
    rank is not told of them), Adasum, and collectives replayed from a
    captured CUDA graph."""
    del device
    timing = _begin("join", global_process_set, None)
    try:
        if basics.size() == 1:
            return 0
        return _join_loop()
    finally:
        _end(timing)


def _join_loop() -> int:
    device = basics.device()
    group = global_process_set.group()
    joined_at, called_us = _join.headers, int(timeline.now_us())
    _join.joined = True
    timeline.activity_start("join", "JOIN")
    try:
        while True:
            header = torch.zeros(_HEADER_LEN, dtype=torch.int64,
                                 device=device)
            _blocking(dist.all_reduce, header, group=group)
            _join.headers += 1
            active, *desc = header.tolist()   # this rank is idle: it waits
            if active == 0:
                break
            _stand_in(desc, active)
        mine = torch.tensor([joined_at, called_us, basics.rank()],
                            dtype=torch.int64, device=device)
        keys = mine.new_empty(3 * basics.size())
        _blocking(dist.all_gather_into_tensor, keys, mine, group=group)
        return max(tuple(k) for k in keys.view(-1, 3).tolist())[2]
    finally:
        _join.joined = False
        timeline.activity_end("join")


def joined() -> bool:
    """Whether this rank is inside :func:`join`."""
    return _join.joined

