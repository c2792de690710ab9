"""Chrome-trace timeline with the device spans of every collective: the
port's counterpart of the JAX package's ``utils/timeline.py`` (Horovod's
``common/timeline.{h,cc}``).

One "thread" lane per tensor, every event tagged ``pid=<rank>``, the JAX
package's activity scheme (``NEGOTIATE_<OP>``, ``EAGER_<OP>``, backend
spans named ``<BACKEND>_<OP>``, ``CYCLE`` instants and ``RECOVERY(...)``
events on a metadata-named lane), so shards from different ranks, and from
either package, merge into one clock-aligned view (``merge_files`` /
``python -m horovod_tpu_torch.utils.timeline merge``).

Producers:

- the **producer API** below (``negotiate_start`` / ``rank_ready`` /
  ``instant`` / ``activity_start`` / ``mark_cycle`` / ``record_recovery``),
  as in the JAX package; the coordinator (``ops/negotiation.py``) writes
  the engine's per-tensor lifecycle through it on the lane
  ``<tensor> (coordinator)``;
- the **eager collectives** (``ops/collective_ops.py``): each collective
  writes an ``EAGER_<OP>`` span (host clock, issue to wait) on its
  tensor's lane and, on CUDA, a ``NCCL_<OP>`` device span on the lane
  ``<tensor> (device)``; on gloo the wait blocks, so the host clock is the
  completion time and the span is ``GLOO_<OP>``;
- the **event drainer**, the counterpart of the JAX package's engine
  drainer: a thread that resolves each CUDA collective's pair of CUDA
  events (one recorded on the issuing stream before the collective is
  issued, one after it is waited for) with ``query()`` and then
  ``elapsed_time``, feeds the latency to the collective's histogram
  (``hvt_collective_latency_seconds``) and writes the device span. It runs
  whether or not a timeline records; the issuing thread never
  synchronizes for it. Device times are placed on the host's clock through
  an anchor event: the drainer polls an event recorded on the issuing
  stream until it completes and takes the host clock then; each later
  event's time is the anchor's plus ``elapsed_time``. Anchors are renewed
  every ``_ANCHOR_SEC`` so the card's and the host's clocks cannot drift
  apart over a long job. A CUDA graph captured in the default (global)
  mode forbids other threads to query events while it captures, so
  ``flush()`` the drainer before capturing, as ``bench.capture_step``
  does; a collective issued under capture records no event.

A writer thread drains the events to disk every ``_WRITE_SEC`` and flushes
after every batch, so a SIGKILLed worker still leaves a loadable shard
(``load_trace`` repairs a missing closing ``]``) that lacks at most the
last batch; producers only append to a queue, and wake no thread. Timestamps are wall-clock microseconds plus the
offset to the launcher's clock measured against its ``GET /clock``
(``measure_clock_offset_us``); a failed handshake is written into the
shard's metadata (``clock_sync``), not dropped.

``start(..., profiler=True)`` also arms a ``torch.profiler`` session whose
Chrome trace of host and device activity is written beside the timeline at
``stop()`` (``<path>.profiler.json``), the counterpart of the JAX package's
``xla_profiler=True``. The launcher's workers do not arm it (every worker's
session costs memory and time); set ``HVT_TIMELINE_TORCH_PROFILER=1`` to
opt back in.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

_state = None
_state_lock = threading.Lock()

# Microseconds to ADD to local wall-clock timestamps so every rank's events
# land on the launcher's clock (0 when no handshake ran; same-host ranks
# share a clock anyway).
_clock_offset_us = 0.0

# lanes of each shard path, kept across a stop and a restart on the same
# path (an elastic reset), so a tensor keeps its lane
_lanes_by_path = {}

_ANCHOR_SEC = 30.0     # renew the device-clock anchor this often
_WRITE_SEC = 0.05       # the writer's period
_DRAIN_POLL_SEC = 2e-3  # the drainer's poll while a pair is unresolved
_ANCHOR_POLL_SEC = 5e-5  # ... and while an anchor is (its clock's error)


def set_clock_offset_us(offset_us: float):
    global _clock_offset_us
    _clock_offset_us = float(offset_us)


def clock_offset_us() -> float:
    return _clock_offset_us


def now_us() -> float:
    """The timeline's clock: wall-clock µs plus the launcher offset."""
    return time.time_ns() / 1e3 + _clock_offset_us


def measure_clock_offset_us(addr: str, samples: int = 5,
                            timeout: float = 2.0) -> float:
    """Clock-offset handshake against the launcher's ``GET /clock``:
    offset = server_epoch_us + rtt/2 − local_now, taking the minimum-RTT
    sample (NTP's classic estimator)."""
    from horovod_tpu_torch.runner.http_client import get_json

    best_rtt, best_off = None, 0.0
    for _ in range(max(1, samples)):
        t0 = time.time_ns() / 1e3
        obj = get_json(addr, "/clock", timeout=timeout)
        t1 = time.time_ns() / 1e3
        rtt = t1 - t0
        off = float(obj["epoch_us"]) + rtt / 2.0 - t1
        if best_rtt is None or rtt < best_rtt:
            best_rtt, best_off = rtt, off
    return best_off


def _reopen_for_append(path):
    """Open a shard an earlier ``stop()`` closed so that new events extend
    its array: drop the closing ``]``. Returns (file, whether it already
    holds an event)."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - 64))
        tail = f.read()
        cut = tail.rfind(b"]")
        if cut >= 0:
            f.truncate(size - len(tail) + cut)
        f.seek(0)
        head = f.read(64).strip()
    return open(path, "a"), head not in (b"[", b"")


class _TimelineState:
    def __init__(self, path, mark_cycles, pid=0, upload_addr=None,
                 append=False, meta=None):
        self.path = path
        self.mark_cycles = mark_cycles
        self.pid = int(pid)
        self.upload_addr = upload_addr
        self.queue = collections.deque()   # appends are atomic
        self.lanes_lock = threading.Lock()
        self.cond = threading.Condition()  # the stop signal
        self.stopping = False
        self.tensor_lanes, next_lane = _lanes_by_path.get(path, ({}, 0))
        self.next_lane = next_lane
        self.cycle_lane = self.tensor_lanes.get(("__cycle__",))
        if append and os.path.exists(path) and os.path.getsize(path):
            self.file, has_events = _reopen_for_append(path)
            self.first = not has_events
        else:
            self.file = open(path, "w")
            self.file.write("[\n")
            self.first = True
            self.tensor_lanes, self.next_lane = {}, 0
            self.cycle_lane = None
        self._emit({"name": "process_name", "ph": "M", "pid": self.pid,
                    "args": {"name": f"rank {self.pid}"}})
        self._emit({"name": "process_sort_index", "ph": "M",
                    "pid": self.pid, "args": {"sort_index": self.pid}})
        if meta:
            for name, args in meta.items():
                self._emit({"name": name, "ph": "M", "pid": self.pid,
                            "args": args})
        self.profiler = None
        self.writer = threading.Thread(target=self._drain, daemon=True)
        self.writer.start()

    # ----------------------------------------------------------- lanes
    def _lane(self, key, display_name):
        with self.lanes_lock:
            tid = self.tensor_lanes.get(key)
            if tid is None:
                tid = self.tensor_lanes[key] = self.next_lane
                self.next_lane += 1
                self.queue.append({"name": "thread_name", "ph": "M",
                                   "pid": self.pid, "tid": tid,
                                   "args": {"name": display_name}})
            return tid

    def _cycle_lane(self):
        # dedicated metadata-named lane: cycle instants never land in a
        # tensor's lane
        if self.cycle_lane is None:
            self.cycle_lane = self._lane(("__cycle__",), "CYCLE")
        return self.cycle_lane

    # ------------------------------------------------------- producers
    def _emit(self, ev):
        self.queue.append(ev)

    def record(self, tensor_name, phase, name=None, ts=None, args=None):
        tid = self._lane(tensor_name, tensor_name)
        ev = {"ph": phase, "pid": self.pid, "tid": tid,
              "ts": now_us() if ts is None else ts}
        if name is not None:
            ev["name"] = name
        if phase == "i":
            ev["s"] = "t"
        if args:
            ev["args"] = args
        self._emit(ev)

    def span(self, lane, name, ts_us, dur_us, args=None):
        """A complete ("X") event: spans of one lane may overlap (async
        collectives), which B/E pairs could not express."""
        ev = {"ph": "X", "pid": self.pid, "tid": self._lane(lane, lane),
              "name": name, "ts": ts_us, "dur": max(0.0, dur_us)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def cycle_mark(self, name="CYCLE_START", ts=None, args=None, scope="p"):
        ev = {"ph": "i", "pid": self.pid, "tid": self._cycle_lane(),
              "name": name, "ts": now_us() if ts is None else ts,
              "s": scope}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ---------------------------------------------------------- writer
    def _drain(self):
        while True:
            with self.cond:
                self.cond.wait_for(lambda: self.stopping, _WRITE_SEC)
                stopping = self.stopping
            batch = []
            while self.queue:
                batch.append(self.queue.popleft())
            for ev in batch:
                if not self.first:
                    self.file.write(",\n")
                self.first = False
                self.file.write(json.dumps(ev))
            if batch:
                # crash-safety: everything up to here survives a SIGKILL
                self.file.flush()
            if stopping and not self.queue:
                break
        self.file.write("\n]\n")
        self.file.close()

    # ----------------------------------------------------------- close
    def close(self):
        with self.cond:
            self.stopping = True
            self.cond.notify()
        self.writer.join(timeout=10)
        _lanes_by_path[self.path] = (self.tensor_lanes, self.next_lane)
        self._upload()

    def _upload(self):
        """PUT the finished shard to the launcher's KV store
        (``/kv/timeline/<rank>``) so the launcher merges every rank's shard
        without a shared filesystem. A failure is reported, never raised:
        the local file is the launcher's fallback."""
        if not self.upload_addr:
            return
        try:
            from horovod_tpu_torch.runner.http_client import put_bytes

            with open(self.path, "rb") as f:
                put_bytes(self.upload_addr, f"/kv/timeline/{self.pid}",
                          f.read(), timeout=15)
        except Exception as e:
            print(f"horovod_tpu_torch: timeline shard upload to "
                  f"{self.upload_addr} failed ({type(e).__name__}: {e}); "
                  f"the shard remains at {self.path}", file=sys.stderr)


def _start_profiler(path):
    """A torch.profiler session of host and device activity; None when
    another session is already active (it belongs to the caller and is
    left alone, with a word on stderr)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd.profiler._is_profiler_enabled:
        print(f"horovod_tpu_torch: a torch.profiler session is already "
              f"active; the timeline at {path} records without its own",
              file=sys.stderr)
        return None
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def profiler_trace_path(path) -> str:
    """Where ``stop()`` writes the profiler's Chrome trace for the
    timeline at ``path``."""
    return path + ".profiler.json"


def start(path, mark_cycles=False, profiler=True, pid=None,
          upload_addr=None, append=False, meta=None):
    """Begin recording (Horovod's ``horovod_start_timeline``). A second
    start while recording is a no-op. A file that cannot be opened raises.

    ``pid`` tags every event (default the ``HVT_PROCESS_ID`` of the
    launcher, else 0); ``upload_addr`` makes ``stop()`` PUT the finished
    shard to ``http://<upload_addr>/kv/timeline/<pid>``; ``append`` extends
    a shard an earlier ``stop()`` closed (an elastic reset); ``meta``
    (``{name: args}``) adds metadata events. ``profiler=True`` arms a
    ``torch.profiler`` session whose Chrome trace ``stop()`` writes to
    :func:`profiler_trace_path`."""
    global _state
    with _state_lock:
        if _state is not None:
            return
        pid = int(os.environ.get("HVT_PROCESS_ID", "0")) if pid is None \
            else pid
        state = _TimelineState(path, mark_cycles, pid=pid,
                               upload_addr=upload_addr, append=append,
                               meta=meta)
        if profiler:
            try:
                state.profiler = _start_profiler(path)
            except Exception:
                state.close()
                raise
        _state = state


def stop():
    """Stop recording: drain the device spans of collectives already
    waited for, stop the profiler and write its trace, close the shard and
    upload it."""
    global _state
    with _state_lock:
        if _state is None:
            return
        drainer.flush(timeout=10.0)
        state, _state = _state, None
        try:
            if state.profiler is not None:
                state.profiler.stop()
                state.profiler.export_chrome_trace(
                    profiler_trace_path(state.path))
        finally:
            state.close()


def active() -> bool:
    return _state is not None


# --- producer API -----------------------------------------------------------

def negotiate_start(tensor_name, op_name, ts=None):
    s = _state
    if s:
        s.record(tensor_name, "B", name=f"NEGOTIATE_{op_name}", ts=ts)


def negotiate_end(tensor_name, ts=None, op_name=None):
    """End the negotiation span; ``op_name`` names the end event
    (``NEGOTIATE_<OP>``), so that it can be told from an exec span's end on
    the same lane."""
    s = _state
    if s:
        s.record(tensor_name, "E", ts=ts,
                 name=None if op_name is None else f"NEGOTIATE_{op_name}")


def rank_ready(tensor_name, rank, ts=None):
    """Rank ``rank``'s request reached the negotiation
    (``RANK_READY_<rank>``, the engine's ``NegotiateRankReady``)."""
    s = _state
    if s:
        s.record(tensor_name, "i", name=f"RANK_READY_{rank}", ts=ts)


def instant(tensor_name, name, args=None, ts=None):
    """An instant on a tensor's lane (``ENQUEUED``, ``DONE``,
    ``ERROR``)."""
    s = _state
    if s:
        s.record(tensor_name, "i", name=name, ts=ts, args=args)


def activity_start(tensor_name, activity, args=None):
    s = _state
    if s:
        s.record(tensor_name, "B", name=activity, args=args)


def activity_end(tensor_name, activity=None):
    """End the activity span; ``activity`` names the end event."""
    s = _state
    if s:
        s.record(tensor_name, "E", name=activity)


def span(lane, name, ts_us, dur_us, args=None):
    """A complete event on ``lane`` (a tensor's name)."""
    s = _state
    if s:
        s.span(lane, name, ts_us, dur_us, args)


def mark_cycle():
    s = _state
    if s and s.mark_cycles:
        s.cycle_mark()


def record_recovery(phase, outcome, seconds):
    """One elastic recovery phase as a ``RECOVERY(<phase>, <outcome>)``
    instant on the CYCLE lane, the event the JAX package stamps through
    its engine's flight recorder (``native.record_event("RECOVERY")``).
    Always recorded, like the JAX package's."""
    s = _state
    if s:
        s.cycle_mark(name=f"RECOVERY({phase}, {outcome})", scope="g",
                     args={"phase": phase, "outcome": outcome,
                           "duration_us": int(seconds * 1e6)})


# --- CUDA event drainer -----------------------------------------------------

class _Pair:
    """One CUDA collective's event pair and what to do once it resolves."""

    __slots__ = ("start", "end", "device", "lane", "name", "args",
                 "on_done", "t_issue")

    def __init__(self, start, end, device, lane, name, args, on_done,
                 t_issue):
        self.start, self.end, self.device = start, end, device
        self.lane, self.name, self.args = lane, name, args
        self.on_done, self.t_issue = on_done, t_issue


class _EventDrainer:
    """Resolves CUDA event pairs off the issuing thread (see the module
    docstring). ``start_event`` records the start of a collective on the
    current stream, ``submit`` hands over its end; the thread polls the
    end with ``query()`` and never blocks the card."""

    def __init__(self):
        self.cond = threading.Condition()
        self.pending = []           # _Pair, in submission order
        self.anchors = {}           # device index -> (event, host µs)
        self.unstamped = []         # (device index, event) to be anchored
        self.anchor_issued = {}     # device index -> monotonic s
        self.thread = None

    def start_event(self, device):
        """A timing event recorded now on ``device``'s current stream,
        after an anchor event when one is due."""
        import torch

        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        now = time.monotonic()
        if now - self.anchor_issued.get(idx, -_ANCHOR_SEC) >= _ANCHOR_SEC:
            self.anchor_issued[idx] = now
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            with self.cond:
                self.unstamped.append((idx, anchor))
                self._ensure_thread()
                self.cond.notify()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def submit(self, start, device, lane, name, args, on_done, t_issue):
        """Record the end event on the current stream and queue the pair."""
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record()
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        with self.cond:
            self.pending.append(_Pair(start, end, idx, lane, name, args,
                                      on_done, t_issue))
            self._ensure_thread()
            self.cond.notify()

    def _ensure_thread(self):
        if self.thread is None or not self.thread.is_alive():
            self.thread = threading.Thread(target=self._run, daemon=True,
                                           name="hvt-event-drainer")
            self.thread.start()

    def _stamp(self, idx, event):
        """The host time at which ``event`` completed: poll it (the stream
        may still be busy), then read the clock. The poll's sleep bounds
        the anchor's error and leaves the interpreter lock to the issuing
        thread."""
        while not event.query():
            time.sleep(_ANCHOR_POLL_SEC)
        self.anchors[idx] = (event, now_us())

    def _resolve(self, pair):
        ms = pair.start.elapsed_time(pair.end)
        try:
            pair.on_done(ms / 1e3)
        except Exception as e:     # a metric must never kill the drainer
            print(f"horovod_tpu_torch: collective metric failed: {e}",
                  file=sys.stderr)
        s = _state
        anchor = self.anchors.get(pair.device)
        if s is not None and anchor is not None:
            event, host_us = anchor
            ts = host_us + event.elapsed_time(pair.start) * 1e3
            s.span(pair.lane, pair.name, ts, ms * 1e3, pair.args)

    def _run(self):
        while True:
            with self.cond:
                while not self.pending and not self.unstamped:
                    self.cond.wait()
                unstamped, self.unstamped = self.unstamped, []
            try:
                for idx, event in unstamped:
                    self._stamp(idx, event)
                with self.cond:
                    batch = list(self.pending)
                # pairs complete in submission order on one stream: query
                # up to the first that has not, so a poll costs the pairs
                # it resolves and one more
                done = []
                for p in batch:
                    if not p.end.query():
                        break
                    done.append(p)
                for p in done:
                    self._resolve(p)
            except RuntimeError as e:
                # e.g. a CUDA graph captured in global mode from another
                # thread forbids the query: keep the pairs, try again
                print(f"horovod_tpu_torch: event drainer: {e}",
                      file=sys.stderr)
                time.sleep(0.1)
                continue
            with self.cond:
                finished = set(map(id, done))
                self.pending = [p for p in self.pending
                                if id(p) not in finished]
                if not self.pending and not self.unstamped:
                    self.cond.notify_all()
                    continue
            time.sleep(_DRAIN_POLL_SEC)

    def unresolved(self):
        """The pairs whose collective has not completed on the card."""
        with self.cond:
            batch = list(self.pending)
        return [p for p in batch if not p.end.query()]

    def flush(self, timeout=30.0) -> bool:
        """Wait until every submitted pair is resolved (its histogram
        observed, its span written). False on timeout."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.pending or self.unstamped:
                left = deadline - time.monotonic()
                if left <= 0:
                    print(f"horovod_tpu_torch: {len(self.pending)} "
                          f"collective(s) still unresolved after {timeout} "
                          f"s", file=sys.stderr)
                    return False
                self.cond.wait(min(left, 0.05))
        return True


drainer = _EventDrainer()


# --- shard loading / merging ------------------------------------------------

def load_trace(path):
    """Load one trace shard file (see :func:`parse_trace`)."""
    with open(path) as f:
        return parse_trace(f.read())


def parse_trace(text):
    """Parse one trace shard, tolerating truncation: a crashed writer
    leaves no closing ``]`` (and possibly a half-written last event)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    repaired = text.rstrip().rstrip(",")
    if repaired.startswith("["):
        try:
            return json.loads(repaired + "\n]")
        except json.JSONDecodeError:
            pass
    # last resort: the writer emits one event per line — keep every line
    # that parses, drop the torn tail
    events = []
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in "[]":
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(ev, dict):
            events.append(ev)
    return events


def merge_traces(shards):
    """Merge per-rank event lists into one chrome-trace event list.

    Metadata (``ph == "M"``) events sort first so lane/process names apply
    before their events; everything else orders by timestamp. A
    ``process_name`` metadata event is synthesized for any pid that lacks
    one."""
    merged, named_pids, seen_pids = [], set(), set()
    for events in shards:
        for ev in events:
            if not isinstance(ev, dict):
                continue
            merged.append(ev)
            pid = ev.get("pid")
            if pid is not None:
                seen_pids.add(pid)
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    named_pids.add(pid)
    for pid in sorted(seen_pids - named_pids):
        merged.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"rank {pid}"}})
    merged.sort(key=lambda e: (0 if e.get("ph") == "M" else 1,
                               e.get("ts", 0)))
    return merged


def merge_files(shard_paths, out_path) -> int:
    """Merge shard files into one chrome://tracing-loadable JSON file;
    returns the merged event count."""
    merged = merge_traces([load_trace(p) for p in shard_paths])
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return len(merged)


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.utils.timeline",
        description="offline timeline shard tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser(
        "merge",
        help="merge per-rank shards into one chrome://tracing file")
    m.add_argument("shards", nargs="+", help="per-rank shard files")
    m.add_argument("-o", "--output", default="timeline.merged.json")
    args = p.parse_args(argv)
    n = merge_files(args.shards, args.output)
    print(f"merged {len(args.shards)} shard(s), {n} events "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
