"""ReplicaGang: the replica manager of the serving subsystem, on
``torch.distributed`` process sets (the JAX package's
``serving/replica_gang.py``).

Partitions the world into ``num_replicas`` contiguous process sets (one per
inference replica) plus a cross-replica **sync set** (the first rank of
every replica), and serves requests onto this rank's replica lane:

- every admitted request becomes one allreduce on the replica's process
  set, named by a per-replica sequence number (SPMD program order: members
  pair without coordination);
- admission is a bounded in-flight window: when the window is full an
  incoming request is **shed** instead of submitted. The shed decision is a
  pure function of the aligned submit/reap call history (never of local
  timing), so replica members always agree on which requests entered the
  collective stream; a timing-based decision would let one member shed what
  its peers submitted and wedge the lane;
- **request-level batching** (``HVT_SERVING_BATCH`` > 1): admitted requests
  queue locally and every ``batch_window`` of them flush as one grouped
  allreduce on the lane (one fused buffer, one collective). Batch
  boundaries are a pure function of the same call history: flush on the
  Nth admit, on a reap that finds only queued work, on a reduce-op change
  and on ``drain()``; ``flush()`` is public for callers with their own
  cadence. ``HVT_SERVING_BATCH=1`` (default) is request for request;
- reaping waits on the oldest slot with the **admission deadline**
  (``Handle.wait(timeout=)``), accounted per request from its own submit
  time; a deadline miss is recorded (the SLO signal) and the wait then
  completes unbounded: every member submitted the collective, so it will
  finish, and the slot must be drained to keep the window aligned;
- when an elastic rendezvous is configured (``HVT_RENDEZVOUS_ADDR``),
  :meth:`push_stats` PUTs the per-rank serving snapshot to
  ``/kv/serving/<rank>`` through ``metrics/telemetry.relay_put``: the
  backlog and latency signal the autoscaler
  (``runner/elastic/autoscaler.py``) scales on.

Where the port departs from the JAX package:

- ``torch.distributed.new_group`` is collective over the whole world, so the
  lanes cannot be registered lazily, by each rank on its first submit (each
  rank would register only its own replica's set, and only leaders the
  sync set: NCCL would deadlock). The default engine registers every
  replica's set, then the sync set, on every rank in ``member_lists``
  order, members or not, when the gang is made (an explicit ``partition=``
  too). ``add_process_set`` returns the registered set for ranks it has
  seen, so a second gang over the same lanes registers nothing.
- ``Handle.wait(timeout=)`` polls every millisecond, so a reap whose budget
  is positive and whose collective is not complete at its first look ends
  on a 1 ms tick, where the JAX engine's wait is not quantized. A reap
  waits for the result to be complete on the card (the default engine's
  ``wait``), not only ordered on the stream.
- Request and batch names cycle over ``2 * max_backlog`` as in the JAX
  package, where a reused name is a response-cache hit on the lane. The
  port has no response cache: on NCCL the cycling buys nothing, and the
  names only label timeline lanes and metrics. It stays because the names
  and the decision log are what the parity test holds.
- The JAX engine's per-lane execution pool (``HVT_LANE_WORKERS``) has no
  counterpart: each process group has its own NCCL stream.

The collective machinery sits behind a small **engine seam** (``engine=``):
anything with ``rank/size/submit/submit_batch/wait`` can stand in for the
default one, which is how the tests drive the same window, shed and batch
discipline through a recording engine.

Knobs (overridable per instance): ``HVT_SERVING_ADMISSION_MS``, the
admission deadline per request (default 1000); ``HVT_SERVING_MAX_BACKLOG``,
the in-flight window per replica member counted in requests (default 32);
``HVT_SERVING_BATCH``, requests coalesced per lane submission (default 1).
"""

from __future__ import annotations

import math
import os
import time

from horovod_tpu_torch.common.exceptions import HorovodTimeoutError


def partition_replicas(world_size: int, num_replicas: int):
    """Contiguous rank partition: replica i gets ranks
    ``[i*base + min(i, rem), ...)``; sizes differ by at most one. Returns a
    list of rank lists."""
    if num_replicas < 1:
        raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    if num_replicas > world_size:
        raise ValueError(
            f"cannot split {world_size} ranks into {num_replicas} "
            f"replicas (every replica needs at least one rank)")
    base, rem = divmod(world_size, num_replicas)
    out, start = [], 0
    for i in range(num_replicas):
        n = base + (1 if i < rem else 0)
        out.append(list(range(start, start + n)))
        start += n
    return out


def _percentile(values, q: float) -> float:
    """numpy.percentile's default linear interpolation, without numpy."""
    if not values:
        return 0.0
    vals = sorted(values)
    k = (len(vals) - 1) * (q / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return float(vals[int(k)])
    return float(vals[f] * (c - k) + vals[c] * (k - f))


class ReplicaStats:
    """Per-rank serving counters and a bounded latency reservoir (Vitter's
    algorithm R: once full, each new observation replaces a uniform-random
    slot with probability max_samples/seen, so the percentiles track a
    uniform sample of the whole stream)."""

    def __init__(self, max_samples: int = 65536):
        import random

        self.admitted = 0
        self.shed = 0
        self.completed = 0
        self.deadline_miss = 0
        self.batches = 0  # lane submissions (= window slots used)
        self.latencies_ms = []
        self._max_samples = max_samples
        self._seen = 0
        self._rng = random.Random(0)  # stats-local; never gang-visible
        self.started_sec = time.monotonic()

    def observe(self, latency_ms: float, met_deadline: bool):
        self.completed += 1
        if not met_deadline:
            self.deadline_miss += 1
        self._seen += 1
        if len(self.latencies_ms) < self._max_samples:
            self.latencies_ms.append(latency_ms)
        else:
            j = self._rng.randrange(self._seen)
            if j < self._max_samples:
                self.latencies_ms[j] = latency_ms

    def percentile(self, q: float) -> float:
        return _percentile(self.latencies_ms, q)

    def snapshot(self) -> dict:
        elapsed = max(time.monotonic() - self.started_sec, 1e-9)
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "completed": self.completed,
            "deadline_miss": self.deadline_miss,
            "batches": self.batches,
            "p50_ms": round(self.percentile(50), 4),
            "p99_ms": round(self.percentile(99), 4),
            "throughput_rps": round(self.completed / elapsed, 3),
        }


class HvtServingEngine:
    """The default engine seam: the port's eager collectives, one
    registered :class:`ProcessSet` per lane. ``lanes`` (lists of ranks) are
    registered at construction, in order, on every rank (``new_group`` is
    collective); submitting on a lane that was not registered raises."""

    def __init__(self, lanes):
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.common.process_sets import add_process_set

        self._basics = basics
        self._sets = {}
        for members in lanes:
            key = tuple(members)
            if key not in self._sets:
                self._sets[key] = add_process_set(list(members))

    def rank(self) -> int:
        return self._basics.rank()

    def size(self) -> int:
        return self._basics.size()

    def _lane(self, members):
        try:
            return self._sets[tuple(members)]
        except KeyError:
            raise ValueError(f"lane {list(members)} was not registered "
                             "when the engine was made") from None

    def _op(self, op):
        from horovod_tpu_torch.ops import collective_ops as co

        return {"sum": co.Sum, "avg": co.Average, "min": co.Min,
                "max": co.Max, "prod": co.Product,
                "adasum": co.Adasum}[op]

    def submit(self, name, tensor, members, op="sum"):
        from horovod_tpu_torch.ops.collective_ops import allreduce_async

        return allreduce_async(tensor, op=self._op(op), name=name,
                               process_set=self._lane(members))

    def submit_batch(self, name, tensors, members, op="sum"):
        """One lane submission for a whole request batch: a grouped
        allreduce, one fused buffer and one collective."""
        from horovod_tpu_torch.ops.collective_ops import \
            grouped_allreduce_async

        return grouped_allreduce_async(tensors, op=self._op(op), name=name,
                                       process_set=self._lane(members))

    def wait(self, handle, timeout=None):
        """The slot's result, complete on its device. On NCCL a finished
        ``Handle.wait()`` only orders the current stream after the
        collective, so the host then waits for the stream: a request is
        served when its result is on the card, as the JAX engine's wait
        returns a finished result."""
        import torch

        out = handle.wait() if timeout is None else handle.wait(
            timeout=timeout)
        first = out[0] if isinstance(out, (list, tuple)) else out
        if torch.is_tensor(first) and first.is_cuda:
            torch.cuda.current_stream(first.device).synchronize()
        return out


class ReplicaGang:
    """Partition the world into replica lanes and serve requests onto this
    rank's lane. See the module docstring for the semantics."""

    # decision-log cap: the (admitted, shed, batch-boundary) tuple sequence
    # is the cross-member determinism probe; past the cap the counters in
    # `stats` remain exact while the log stops growing
    DECISION_LOG_CAP = 65536

    def __init__(self, num_replicas: int, admission_timeout: float = None,
                 max_backlog: int = None, name: str = "serve",
                 batch_window: int = None, engine=None, partition=None):
        if engine is None:
            from horovod_tpu_torch.common import basics

            self._rank, self._world = basics.rank(), basics.size()
        else:
            self._rank, self._world = engine.rank(), engine.size()
        self.num_replicas = num_replicas
        self.name = name
        if admission_timeout is None:
            admission_timeout = float(
                os.environ.get("HVT_SERVING_ADMISSION_MS", "1000")) / 1e3
        if max_backlog is None:
            max_backlog = int(
                os.environ.get("HVT_SERVING_MAX_BACKLOG", "32"))
        if batch_window is None:
            batch_window = int(os.environ.get("HVT_SERVING_BATCH", "1"))
        self.admission_timeout = admission_timeout
        self.max_backlog = max_backlog
        self.batch_window = max(1, int(batch_window))

        # partition: an explicit list of member-rank lists (one per
        # replica) for non-contiguous tenant shapes, e.g. "column" lanes
        # that stride across hosts. Must cover the world disjointly and be
        # identical on every rank.
        if partition is not None:
            ranks = [sorted(int(x) for x in g) for g in partition]
            if len(ranks) != num_replicas:
                raise ValueError(
                    f"partition has {len(ranks)} groups for "
                    f"num_replicas={num_replicas}")
            flat = sorted(x for g in ranks for x in g)
            if flat != list(range(self._world)):
                raise ValueError(
                    f"partition must cover ranks 0..{self._world - 1} "
                    f"disjointly, got {flat}")
        else:
            ranks = partition_replicas(self._world, num_replicas)
        self.member_lists = ranks
        self.replica_id = next(
            i for i, r in enumerate(ranks) if self._rank in r)
        self.my_members = ranks[self.replica_id]
        # cross-replica sync lane: the first rank of every replica (the
        # replica "leaders"); with one replica it is that replica itself.
        # It is the same list on every rank.
        self.sync_members = (self.my_members if num_replicas == 1
                             else sorted(r[0] for r in ranks))
        # every lane on every rank, in one order (module docstring)
        self._eng = engine if engine is not None else HvtServingEngine(
            ranks + [self.sync_members])

        self._inflight = []  # [[first_seq, handle, [(seq, t)], n]]
        self._batch = []     # [(seq, tensor, t, op)] queued, unflushed
        self._seq = 0        # admitted-request counter (names)
        self._req_idx = 0    # every submit_request call (decision log)
        self._bseq = 0       # flushed-slot counter (batch names)
        self._sync_seq = 0
        self.stats = ReplicaStats()
        # the aligned decision history: ("admit", req_idx) /
        # ("shed", req_idx) / ("batch", first_seq, n_requests); every
        # member of a replica must produce the identical sequence
        self.decisions = []

    # ------------------------------------------------------------ serving

    def _note(self, *tup):
        if len(self.decisions) < self.DECISION_LOG_CAP:
            self.decisions.append(tup)

    def _inflight_requests(self) -> int:
        return sum(slot[3] for slot in self._inflight)

    def backlog(self) -> int:
        """Requests occupying the window: in flight + queued batch."""
        return self._inflight_requests() + len(self._batch)

    def submit_request(self, tensor, op=None):
        """Admit one request onto this rank's replica lane.

        Returns the async handle when the request was submitted (or flushed
        a full batch), ``True`` when it was admitted into a still-open
        batch, and ``None`` when the in-flight window was full and the
        request was shed. All three outcomes are pure functions of the
        aligned call history, so every member of the replica takes the same
        branch for the same request index.
        """
        idx = self._req_idx
        self._req_idx += 1
        if self.backlog() >= self.max_backlog:
            self.stats.shed += 1
            self._note("shed", idx)
            return None
        seq = self._seq
        self._seq += 1
        self.stats.admitted += 1
        self._note("admit", idx)
        opname = self._opname(op)
        if self.batch_window <= 1:
            # names cycle over 2x the window: slot seq-2W was reaped before
            # this submit could be admitted, so the name is free. In the
            # JAX engine a reused name is a response-cache hit on the lane;
            # on NCCL it only labels the timeline lane and the metrics
            slot = seq % (2 * self.max_backlog)
            h = self._eng.submit(
                f"{self.name}.r{self.replica_id}.{slot}", tensor,
                self.my_members, op=opname)
            now = time.monotonic()
            self._inflight.append([seq, h, [(seq, now)], 1])
            self.stats.batches += 1
            self._note("batch", seq, 1)
            return h
        # a reduce-op change closes the open batch: one grouped submission
        # carries one op, and the op sequence is part of the aligned call
        # history, so this boundary is member-identical too
        if self._batch and self._batch[0][3] != opname:
            self._flush()
        self._batch.append((seq, tensor, time.monotonic(), opname))
        if len(self._batch) >= self.batch_window:
            return self._flush()
        return True

    def _opname(self, op):
        """Canonical lowercase reduce-op name for the engine seam. The
        port's ReduceOp instances map by their ``.name``; an op the seam
        cannot express raises instead of silently riding as sum."""
        if op is None:
            return "sum"
        name = op if isinstance(op, str) else getattr(
            op, "name", getattr(op, "__name__", str(op)))
        name = str(name).lower()
        name = {"average": "avg", "product": "prod"}.get(name, name)
        if name not in ("sum", "avg", "min", "max", "prod", "adasum"):
            raise ValueError(f"unsupported serving reduce op: {op!r}")
        return name

    def flush(self):
        """Flush the open batch (if any) as one lane submission. Part of the
        aligned call history: call it at the same point in every member's
        request stream."""
        return self._flush()

    def _flush(self):
        if not self._batch:
            return None
        batch, self._batch = self._batch, []
        first_seq = batch[0][0]
        n = len(batch)
        # batch slots cycle over 2x max_backlog, assuming ONE request per
        # slot: partial flushes (a reap with only queued work, an op
        # change, flush()) allow up to max_backlog single-request slots in
        # flight, so a tighter cycle could reuse a pending slot's name
        bslot = self._bseq % (2 * self.max_backlog)
        self._bseq += 1
        opname = batch[0][3]
        h = self._eng.submit_batch(
            f"{self.name}.r{self.replica_id}.b{bslot}",
            [t for _, t, _, _ in batch], self.my_members, op=opname)
        self._inflight.append(
            [first_seq, h, [(s, t0) for s, _, t0, _ in batch], n])
        self.stats.batches += 1
        self._note("batch", first_seq, n)
        return h

    def reap(self):
        """Wait out the oldest in-flight slot against its admission
        deadline; record each request's latency and whether it met the SLO.
        Returns the slot's result (the request's result unbatched; the list
        of per-request results for a batch), or ``None`` with an empty
        window.

        The deadline runs from each request's admission (submit time), not
        from this call. It is an SLO, not a cancellation: every member
        already submitted the collective, so it will complete and is drained
        unbounded to keep the window aligned. A reap with nothing in flight
        flushes the open batch first (a pure function of the call
        history)."""
        if not self._inflight:
            if not self._batch:
                return None
            self._flush()
        _first_seq, h, reqs, _n = self._inflight.pop(0)
        budget = self.admission_timeout - (time.monotonic() - reqs[0][1])
        try:
            if budget <= 0:
                out = self._eng.wait(h)
            else:
                out = self._eng.wait(h, timeout=budget)
        except HorovodTimeoutError:
            out = self._eng.wait(h)
        now = time.monotonic()
        for _seq, t0 in reqs:
            latency_ms = (now - t0) * 1e3
            # each request's SLO runs from its own submit time: a slot-level
            # wait timeout means the oldest request blew its budget, not
            # that batch-mates admitted later missed theirs too
            met = latency_ms <= self.admission_timeout * 1e3
            self.stats.observe(latency_ms, met)
        return out

    def drain(self):
        """Reap every outstanding request (end-of-stream flush)."""
        self._flush()
        while self._inflight:
            self.reap()

    def sync(self, tensor, op=None):
        """Cross-replica sync over the leader set (a parameter refresh or
        an eviction broadcast). Only leaders take part; other ranks return
        the input unchanged."""
        if self._rank not in self.sync_members:
            return tensor
        self._sync_seq += 1
        h = self._eng.submit(f"{self.name}.sync.{self._sync_seq}",
                             tensor, self.sync_members,
                             op="avg" if op is None else self._opname(op))
        return self._eng.wait(h)

    # ---------------------------------------------------------- telemetry

    def snapshot(self) -> dict:
        s = self.stats.snapshot()
        s.update(rank=self._rank, replica=self.replica_id,
                 inflight=self.backlog(),
                 max_backlog=self.max_backlog,
                 batch_window=self.batch_window,
                 admission_ms=self.admission_timeout * 1e3,
                 # wall-clock stamp: every push changes the payload, which
                 # is how the autoscaler's staleness filter tells a live
                 # (even idle) rank from a shed one
                 ts=time.time())
        return s

    def push_stats(self, addr: str = None, timeout: float = 2.0) -> bool:
        """Best-effort PUT of this rank's serving snapshot to the rendezvous
        KV (``/kv/serving/<rank>``), the autoscaler's backlog and latency
        signal; routed through the host leader when the KV relay is active
        (``metrics/telemetry.py``). No-op outside an elastic launch."""
        addr = addr or os.environ.get("HVT_RENDEZVOUS_ADDR")
        if not addr:
            return False
        try:
            from horovod_tpu_torch.metrics.telemetry import relay_put

            return relay_put(addr, "serving", str(self._rank),
                             self.snapshot(), timeout=timeout)
        except Exception:
            return False
