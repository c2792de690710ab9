"""Collective operations on ``torch.distributed`` (Horovod's
``torch/mpi_ops.py``; the JAX package's ``ops/collective_ops.py``):
allreduce, grouped allreduce, allgather, broadcast, alltoall,
reducescatter, barrier, their in-place and ``*_async`` forms, and
``synchronize`` / ``poll`` on the handles those return.

Each call is a collective over a process set (the global one by default):
NCCL on the GPU, gloo on the CPU. A non-member's call raises ``ValueError``
(``common/process_sets.py``). Over a set of more than one process each call
is first negotiated (``ops/negotiation.py``, the JAX engine's coordinator):
the members' requests are paired by call order and checked, and a
disagreement (op, dtype, shape, reduce op, root, scales, fusion group,
process set) raises the engine's ``ValueError`` on every member before any
data moves. A collective that the backend fails (a peer lost, or one
stalled past the process group's timeout) raises ``HorovodInternalError``,
as Horovod's torch ops do; NCCL may instead abort the process, as its
watchdog decides. After ``basics.abort`` every collective raises
``HorovodInternalError`` before it is issued.

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
Every member's rows of an allgather, and the splits of an alltoall, come
with the negotiation, so their ``*_async`` forms return once it is done.

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
for an alltoall). A joined rank, idle in :func:`join`, takes part in each
negotiation on the global set with a join record in place of a request; it
reads the active ranks' request there and issues the same call with its
stand-in, until every member's record is a join record.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HorovodTimeoutError)
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops import negotiation
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
_BY_NAME = {op.name: op for op in (Average, Sum, Adasum, Min, Max, Product)}


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
                 "device", "coord", "__weakref__")


_in_flight = weakref.WeakSet()     # _Timed of handles not yet waited for
_in_flight_lock = threading.Lock()  # collectives run from several threads


def _begin(op_name, process_set, tensors, name=None, device=None,
           outcome=None):
    """Count and start timing one eager collective; None for a joined
    rank's stand-in and under graph capture (counted there in
    ``hvt_traced_collectives_total``). ``outcome`` is its negotiation's,
    whose coordinator lane gets the exec span."""
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
    t.coord = outcome.lane if outcome is not None else None
    if t.coord is not None:
        if not outcome.negotiated:      # a set of one: no ENQUEUED yet
            timeline.instant(t.coord, "ENQUEUED",
                             args={"lane": outcome.lane_id})
        timeline.activity_start(t.coord, op_name,
                                args={"lane": outcome.lane_id})
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
    if t.coord is not None:
        timeline.activity_end(t.coord, t.op)
        timeline.instant(t.coord, "DONE")
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
# negotiation and join's stand-ins (see the module docstring)
# --------------------------------------------------------------------------

class _JoinState:
    def __init__(self):
        self.joined = False     # this rank is inside join()
        self.serving = False    # ... issuing a stand-in


_join = _JoinState()


def _reset_world():
    """A new world starts with no rank joined and no collective queued
    (``basics.init``)."""
    global _join
    _join = _JoinState()
    with _queue_lock:
        _queue.clear()


def _host_exchange(op_name):
    return ValueError(f"{op_name} over more than one process exchanges "
                      "its sizes on the host and cannot be captured in a "
                      "CUDA graph")


def _torch_dtype(name):
    return getattr(torch, name.split(".", 1)[1])


def _stand_in(outcome):
    """As a joined rank, issue with zeros the collective that the active
    ranks negotiated (their request, in ``outcome``)."""
    q = outcome.active()
    negotiation.follow(global_process_set, q)
    op = q[negotiation.OP]
    group = global_process_set.group()
    device = basics.device()
    dtypes = [_torch_dtype(d) if d else None for d in q[negotiation.DTYPES]]
    shapes = q[negotiation.SHAPES]
    _join.serving = True
    try:
        if op == "barrier":
            _blocking(dist.barrier, group=group)
        elif op == "allreduce":
            reduce = _BY_NAME[q[negotiation.REDUCE]]
            if reduce is Adasum:
                raise HorovodInternalError("join cannot stand in for an "
                                           "Adasum allreduce")
            buckets = {}    # as the grouped allreduce fuses: per dtype
            for dtype, shape in zip(dtypes, shapes):
                buckets[dtype] = buckets.get(dtype, 0) + \
                    int(torch.Size(shape).numel())
            for dtype, numel in buckets.items():
                zeros = torch.zeros(numel, dtype=dtype, device=device)
                plan = _wire_plan(zeros, reduce, global_process_set)
                if plan is not None:
                    from horovod_tpu_torch.ops import hierarchical

                    hierarchical.compressed_allreduce(
                        zeros, global_process_set, plan,
                        op=Sum if reduce is Average else reduce)
                else:
                    _blocking(dist.all_reduce, zeros,
                              op=_DIST_OP[reduce], group=group)
        elif op in ("broadcast", "reducescatter"):
            zeros = torch.zeros(shapes[0], dtype=dtypes[0], device=device)
            if op == "broadcast":
                _blocking(dist.broadcast, zeros, src=q[negotiation.ROOT],
                          group=group)
            else:
                out = zeros.new_empty(zeros.numel() // basics.size())
                _blocking(dist.reduce_scatter_tensor, out, zeros.reshape(-1),
                          op=_DIST_OP[_BY_NAME[q[negotiation.REDUCE]]],
                          group=group)
        else:
            zeros = torch.zeros((0,) + tuple(shapes[0][1:]),
                                dtype=dtypes[0], device=device)
            if op == "allgather":
                _allgather_start(zeros, global_process_set,
                                 rows=outcome.rows()).wait()
            else:
                _alltoall_start(zeros, [0] * basics.size(),
                                global_process_set,
                                recv_splits=outcome.recv_splits()).wait()
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
        # the backend's Work objects
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


class _Then(Handle):
    """A handle whose result is ``fn`` of other handles' results."""

    def __init__(self, handles, fn):
        super().__init__([], None)
        self._handles, self._fn = handles, fn
        self._finish = True     # pending until waited for

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self, timeout=None):
        if self._finish is None:
            return self._result
        deadline = None if timeout is None else time.monotonic() + timeout
        results = [h.wait(None if deadline is None else
                          max(0.0, deadline - time.monotonic()))
                   for h in self._handles]
        self._result, self._finish = self._fn(*results), None
        return self._result


# --------------------------------------------------------------------------
# negotiated collectives in call order (ops/negotiation.py)
# --------------------------------------------------------------------------

_queue = collections.deque()    # _Pending handles whose data is not issued
_queue_lock = threading.RLock()


class _Pending(Handle):
    """A negotiated collective: its request is posted, and its data is
    issued (``start(outcome)``, which returns the started collective's
    handle) once every member's request is there, after every collective
    called before it. A disagreement is raised by ``wait``."""

    def __init__(self, ticket, start):
        super().__init__([], None)
        self._ticket, self._start = ticket, start
        self._inner = self._error = None
        with _queue_lock:
            _queue.append(self)

    def _launch(self):
        """Read the negotiation and issue the data (the queue's head)."""
        _queue.popleft()
        try:
            self._inner = self._start(negotiation.finish(self._ticket))
        except Exception as e:
            self._error = e

    def _launched(self) -> bool:
        return self._inner is not None or self._error is not None

    def done(self) -> bool:
        if not self._launched():
            _pump(verdicts=True)
            if not self._launched():
                return False
        return self._error is not None or self._inner.done()

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._launched() and deadline is None:
            _flush(self)
        while not self._launched():
            _pump(verdicts=True)
            if self._launched():
                break
            if time.monotonic() >= deadline:
                raise HorovodTimeoutError(
                    f"collective '{self._ticket.name}' still pending after "
                    f"{timeout} s (its peers have not all submitted it)")
            time.sleep(1e-3)
        if self._error is not None:
            raise self._error
        return self._inner.wait(None if deadline is None else
                                max(0.0, deadline - time.monotonic()))


def _pump(verdicts=False):
    """Issue the queued collectives, in order, whose negotiations can be
    read without waiting."""
    with _queue_lock:
        while _queue and negotiation.ready(_queue[0]._ticket, verdicts):
            _queue[0]._launch()


def _flush(upto=None):
    """Issue every queued collective (up to ``upto``), in order, waiting
    for their negotiations."""
    with _queue_lock:
        while _queue:
            head = _queue[0]
            head._launch()
            if head is upto:
                return


def _issue(op_name, process_set, tensors, start, **request):
    """Negotiate one collective and start it; returns its handle.
    ``start(outcome)`` issues the data and returns the started
    collective's handle; ``outcome`` is the negotiation's
    (``ops/negotiation.py``). Nothing is negotiated for a joined rank's
    stand-in and under graph capture (every rank captures the same calls,
    and a replay runs no Python): ``outcome`` is None; nor over a set of
    one process, whose ``outcome`` only names the lifecycle's timeline
    lane. Otherwise the request is posted now and the data issued once
    every member's request is there: when this handle is waited for or
    polled, or a later collective is called; always in call order."""
    if _join.serving:
        return start(None)
    if process_set.size() == 1:
        return start(negotiation.local(op_name, process_set,
                                       request.get("name")))
    if _capturing(basics.device()):
        _flush()
        return start(None)
    reason = basics.aborted()
    if reason is not None:
        raise HorovodInternalError(f"{op_name}: the process group was "
                                   f"aborted: {reason}")
    earlier = bool(_queue)
    with _queue_lock:   # keep the set's posted and unread positions in
        while _queue and negotiation.window_full(process_set):  # its window
            _queue[0]._launch()
    h = _Pending(negotiation.post(op_name, process_set, tensors, **request),
                 start)
    if earlier:     # issue what has become ready
        _pump()
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
    """Negotiate and reduce ``buf`` (owned by the caller, may be reduced in
    place) and
    return a Handle whose result is the reduced tensor. Adasum combines
    each of the flat ``segments`` (lengths; default the whole tensor) with
    its own coefficients; ``names`` name them for error feedback. Over a
    set of one process every op but Adasum is the identity with the scales
    applied, so nothing is sent: the result is ready at once, as the JAX
    package's single-process path is, and a one-process step holds no
    collective (which a CUDA graph can then capture). An fp32 allreduce
    but Adasum under a lossy wire codec takes the compressed route, which
    is done when this returns. ``timed`` negotiates, counts and times it as
    an ``allreduce``; a grouped allreduce negotiates and times its parts as
    one."""
    if timed:
        return _issue("allreduce", process_set, buf, lambda outcome:
                      _allreduce_data(buf, op, prescale, postscale,
                                      process_set, segments, name, names,
                                      _begin("allreduce", process_set, buf,
                                             name, buf.device, outcome)),
                      name=name, reduce=op.name, prescale=prescale,
                      postscale=postscale)
    return _allreduce_data(buf, op, prescale, postscale, process_set,
                           segments, name, names, None)


def _allreduce_data(buf, op, prescale, postscale, process_set, segments,
                    name, names, timing):
    group = process_set.group()
    n = process_set.size()
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
    plan = _wire_plan(buf, op, process_set)
    if plan is not None:
        from horovod_tpu_torch.ops import hierarchical

        hierarchical.compressed_allreduce(
            buf, process_set, plan, names=names or [name or "allreduce"],
            segments=segments or [buf.numel()],
            op=Sum if op is Average else op)
        return _done(finish(), timing)
    work = _collective(dist.all_reduce, buf, op=_DIST_OP[op], group=group,
                       async_op=True)
    return Handle([work], finish, timing)


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
    return _Then([handle], fn)


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set,
                            compression=Compression.none):
    """Start :func:`grouped_allreduce`; returns a handle. The parts are
    counted and timed as one ``grouped_allreduce``."""
    op = _resolve_op(op, average)
    tensors = list(tensors)
    process_set.group()
    wires = [compression.compress(t.detach()) for t in tensors]

    def start(outcome):
        return _grouped_data(tensors, wires, op, name, prescale_factor,
                             postscale_factor, process_set, compression,
                             outcome)

    if not tensors:
        return start(None)
    return _issue("allreduce", process_set, [w for w, _ in wires], start,
                  name=name, reduce=op.name, prescale=prescale_factor,
                  postscale=postscale_factor, grouped=True,
                  label="grouped_allreduce")


def _grouped_data(tensors, wires, op, name, prescale_factor,
                  postscale_factor, process_set, compression, outcome):
    timing = _begin("grouped_allreduce", process_set, tensors, name,
                    tensors[0].device if tensors else None, outcome)
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

def _allgather_start(tensor, process_set, name=None, rows=None):
    """A handle whose result is ``(gathered tensor, every member's dim-0
    rows)``. The rows come from the negotiation, or as ``rows`` for a
    joined rank's stand-in."""
    process_set.group()
    t = tensor.detach()
    t = (t.reshape(1) if t.dim() == 0 else t).contiguous()

    def start(outcome):
        if outcome is not None and outcome.negotiated:
            got = outcome.rows()
        elif rows is not None:
            got = rows
        elif process_set.size() == 1:
            got = [t.shape[0]]
        else:
            raise _host_exchange("allgather")
        return _allgather_data(t, process_set, name, got, outcome)

    if rows is not None:
        return start(None)
    return _issue("allgather", process_set, t, start, name=name)


def _allgather_data(t, process_set, name, rows, outcome):
    timing = _begin("allgather", process_set, t, name, t.device, outcome)
    n = process_set.size()
    m = max(rows)
    if m != t.shape[0]:        # pad to the largest, trim after
        t = torch.cat([t, t.new_zeros((m - t.shape[0],) + t.shape[1:])])
    out = t.new_empty((n * m,) + t.shape[1:])
    work = _collective(dist.all_gather_into_tensor, out, t,
                       group=process_set.group(), async_op=True)

    def finish():
        if all(r == m for r in rows):
            return out, rows
        return torch.cat([out[i * m:i * m + r]
                          for i, r in enumerate(rows)]), rows

    return Handle([work], finish, timing)


def allgather_async(tensor, name=None, process_set=global_process_set):
    """Start :func:`allgather`. The gathered rows are issued once every
    member's request is there (see ``_issue``)."""
    return _then(_allgather_start(tensor, process_set, name),
                 lambda pair: pair[0])


class _Allgather(torch.autograd.Function):
    """The gradient is this rank's rows of the cotangent summed over the
    set (``horovod_tpu/torch/mpi_ops.py:225``)."""

    @staticmethod
    def forward(ctx, tensor, process_set, name=None):
        out, rows = _allgather_start(tensor, process_set, name).wait()
        ctx.shape, ctx.process_set, ctx.rows = tensor.shape, process_set, rows
        return out

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
    handles = [allgather_async(t, name=f"{name}.{i}" if name else None,
                               process_set=process_set)
               for i, t in enumerate(tensors)]
    return _Then(handles, lambda *outs: list(outs))


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
    group = process_set.group()
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()

    def start(outcome):
        if root_rank not in process_set.global_ranks():
            raise ValueError(f"root_rank {root_rank} is not in "
                             f"{process_set}")
        timing = _begin("broadcast", process_set, buf, name, buf.device,
                        outcome)
        work = _collective(dist.broadcast, buf, src=root_rank, group=group,
                           async_op=True)

        def finish():
            if buf is not tensor:
                tensor.copy_(buf)
            return tensor

        return Handle([work], finish, timing)

    return _issue("broadcast", process_set, buf, start, name=name,
                  root=int(root_rank))


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

def _alltoall_start(tensor, splits, process_set, name=None,
                    recv_splits=None):
    """A handle whose result is ``(output, received_splits)``, whatever
    ``splits`` is. The received splits come from the negotiation, or as
    ``recv_splits`` for a joined rank's stand-in."""
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

    def start(outcome):
        if outcome is not None and outcome.negotiated:
            got = outcome.recv_splits()
        elif recv_splits is not None:
            got = recv_splits
        elif n == 1:
            got = list(splits)
        else:
            raise _host_exchange("alltoall")
        timing = _begin("alltoall", process_set, t, name, t.device, outcome)
        out = t.new_empty((sum(got),) + t.shape[1:])
        work = _collective(dist.all_to_all_single, out, t,
                           output_split_sizes=got, input_split_sizes=splits,
                           group=group, async_op=True)
        return Handle([work], lambda: (out, torch.tensor(got)), timing)

    if recv_splits is not None:
        return start(None)
    return _issue("alltoall", process_set, t, start, name=name,
                  splits=splits)


def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set):
    """Start :func:`alltoall`; its result follows :func:`alltoall`'s rule
    (the output alone without ``splits``). The negotiation, which carries
    the splits, is done before this returns; the data moves
    asynchronously."""
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
    process_set.group()
    n = process_set.size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(f"reducescatter dim 0 of shape {tuple(tensor.shape)}"
                         f" must divide by the set's size ({n})")
    buf = _own_copy(tensor)
    return _issue("reducescatter", process_set, buf, lambda outcome:
                  _reducescatter_data(buf, op, process_set, prescale_factor,
                                      postscale_factor, _begin(
                                          "reducescatter", process_set, buf,
                                          name, buf.device, outcome)),
                  name=name, reduce=op.name, prescale=prescale_factor,
                  postscale=postscale_factor)


def _reducescatter_data(buf, op, process_set, prescale_factor,
                        postscale_factor, timing):
    group = process_set.group()
    n = process_set.size()
    _scale_(buf, prescale_factor)
    out = buf.new_empty((buf.shape[0] // n,) + buf.shape[1:])
    work = _collective(dist.reduce_scatter_tensor, out, buf,
                       op=_DIST_OP[op], group=group, async_op=True)

    def finish():
        # gloo completes this work only inside its wait(), so it is waited
        # for here and never polled
        _collective(work.wait)
        return _scale_(_average(out, n) if op is Average else out,
                       postscale_factor)

    h = Handle([], finish, timing)
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
    return [reducescatter(t, op=op, name=f"{name}.{i}" if name else None,
                          process_set=process_set)
            for i, t in enumerate(tensors)]


def barrier(process_set=global_process_set):
    """Block until every member of the set reaches this call."""
    group = process_set.group()

    def start(outcome):
        timing = _begin("barrier", process_set, None, outcome=outcome)
        _blocking(dist.barrier, group=group)
        return _done(None, timing)

    _issue("barrier", process_set, None, start).wait()


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

    The last rank is the one that joined after the most negotiated
    global-set collectives; ranks that joined after the same number are
    ordered by
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
    _flush()
    joined_at = negotiation.position(global_process_set)
    called_us = int(timeline.now_us())
    _join.joined = True
    negotiation.mark_joined(True)
    timeline.activity_start("join", "JOIN")
    try:
        while True:     # this rank is idle: it waits in the negotiation
            outcome = negotiation.join_round(global_process_set, joined_at,
                                             called_us)
            if all(q is None for q in outcome.reqs):
                return max((j[0], j[1], r)
                           for r, j in enumerate(outcome.joins))[2]
            _stand_in(outcome)
    finally:
        _join.joined = False
        negotiation.mark_joined(False)
        timeline.activity_end("join")


def joined() -> bool:
    """Whether this rank is inside :func:`join`."""
    return _join.joined

