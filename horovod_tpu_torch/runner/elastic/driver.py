"""Elastic driver: the port's copy of the JAX package's
``runner/elastic/driver.py`` (Horovod's ``runner/elastic/driver.py``:
``ElasticDriver:68`` — discovery thread ``_discover_hosts:177`` (1 s
poll), ``_update_host_assignments:228`` (stable ranks, requires ≥1
surviving host), ``_start_worker_process:277``,
``_handle_worker_exit:292``).

Orchestrates a fault-tolerant job:

- polls a HostDiscovery source; on a host-set change notifies workers so
  their next ``state.commit()`` raises HostsUpdatedInterrupt;
- assigns ranks to (host, slot) pairs, keeping surviving workers' ranks
  stable across rounds;
- spawns one worker per slot via a pluggable ``create_worker_fn`` (the
  launcher passes an ssh/subprocess spawner; tests pass fakes);
- feeds worker exits into the WorkerStateRegistry, whose barrier calls
  back into ``resume()`` (new round) or ``stop()``;
- when a worker of the current round dies, tells every other registered
  worker first (``PUT /abort``), whose handler aborts its process group:
  a survivor blocked in an NCCL collective on the dead peer then gets
  HorovodInternalError at once instead of at the group's timeout;
- counts rounds, resets, preemptions and folded rounds and gauges the
  world and the hosts in ``horovod_tpu_torch.metrics`` (the JAX package's
  ``hvt_elastic_*`` families), served by the rendezvous's ``GET /metrics``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from horovod_tpu_torch.runner.elastic.discovery import HostManager
from horovod_tpu_torch.runner.elastic.registration import \
    WorkerStateRegistry
from horovod_tpu_torch.runner.elastic.settings import ElasticSettings
from horovod_tpu_torch.runner.hosts import (HostInfo, SlotInfo,
                                            get_host_assignments)

_NOTIFY_SCOPE = "workers"


def _elastic_metrics():
    """The driver's families (the JAX package's ``driver.py:35-57``)."""
    from horovod_tpu_torch import metrics

    return (
        metrics.counter("hvt_elastic_rounds_total",
                        "elastic rendezvous rounds activated"),
        metrics.counter("hvt_elastic_resets_total",
                        "elastic restarts after the initial round"),
        metrics.gauge("hvt_elastic_world_size",
                      "slots assigned in the current round"),
        metrics.gauge("hvt_elastic_alive_hosts",
                      "distinct hosts in the current assignment"),
        metrics.gauge("hvt_elastic_blacklisted_hosts",
                      "hosts currently blacklisted by the host manager"),
        metrics.counter("hvt_elastic_preemptions_total",
                        "hosts drained gracefully on a preemption "
                        "notice (/kv/failure/<host>/preempt)"),
        metrics.counter("hvt_elastic_folded_rounds_total",
                        "host changes folded into an in-flight "
                        "re-rendezvous instead of costing their own "
                        "restart round"),
    )


class ElasticDriver:
    def __init__(self, rendezvous, discovery, settings: ElasticSettings,
                 create_worker_fn: Optional[Callable] = None,
                 on_stop: Optional[Callable] = None):
        self._on_stop = on_stop
        self._rendezvous = rendezvous
        self._settings = settings
        self._host_manager = HostManager(
            discovery, cooldown_range=settings.cooldown_range)
        self._registry = WorkerStateRegistry(
            self, self._host_manager, reset_limit=settings.reset_limit,
            verbose=settings.verbose)
        self._create_worker_fn = create_worker_fn
        self._lock = threading.Lock()
        # re-rendezvous coalescing (see resume()): a host blacklisted
        # while a round activation is already in flight folds into that
        # activation's loop instead of buying its own restart round
        self._resume_lock = threading.Lock()
        self._resuming = False
        self._resume_pending = False
        self._last_round_view = None
        # hosts gracefully draining on a preemption notice: host ->
        # monotonic expiry. SOFT exclusion — a draining host leaves the
        # next assignment only while the remaining capacity still
        # covers min_np (the platform may give the notice and then not
        # follow through; hard-blacklisting would kill thin jobs), and
        # the mark expires so an un-preempted host can rejoin.
        self._draining: Dict[str, float] = {}
        self._assignments: Dict[Tuple[str, int], SlotInfo] = {}
        self._workers: Dict[Tuple[str, int], threading.Thread] = {}
        self._results: Dict[int, int] = {}     # rank → exit code
        self._shutdown = threading.Event()
        self._finished = threading.Event()
        self._error: Optional[str] = None
        # every activated round: number, size, wall time, (host/slot) →
        # rank; what a launch reports and the tests read
        self.rounds = []
        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, daemon=True)
        if hasattr(rendezvous, "set_put_hook"):
            rendezvous.set_put_hook(self._on_kv_put)

    # ------------------------------------------------------------------ API

    @property
    def registry(self) -> WorkerStateRegistry:
        return self._registry

    @property
    def host_manager(self) -> HostManager:
        return self._host_manager

    def start(self, np: int, create_worker_fn: Optional[Callable] = None):
        """Wait for min_np slots, assign ranks, spawn workers, start the
        discovery poll. ``np`` is the preferred initial world size."""
        if create_worker_fn is not None:
            self._create_worker_fn = create_worker_fn
        try:
            self._host_manager.update_available_hosts()
        except Exception:
            # transient discovery failure at startup: wait_for_available
            # _slots below keeps polling until the deadline
            pass
        self.wait_for_available_slots(self._settings.min_np)
        self._activate_round(np)
        self._discovery_thread.start()

    def resume(self):
        """Start a new rendezvous round after a failure or host update.

        Coalescing: only one activation loop runs at a time. A second
        ``resume()`` — or a host blacklisted via
        :meth:`_note_host_change` — while an activation is in flight
        sets the pending flag and returns; the in-flight loop picks the
        change up and re-activates with the updated host view before
        any worker has invested in the superseded assignment. Two
        near-simultaneous failure reports therefore cost the workers
        ONE restart, not two back-to-back rounds."""
        if self._shutdown.is_set():
            return
        with self._resume_lock:
            self._resume_pending = True
            if self._resuming:
                return  # folded into the in-flight activation loop
            self._resuming = True
        folded = -1  # first pass is the round itself, not a fold
        released = False  # did the normal exit already clear _resuming?
        try:
            while True:
                with self._resume_lock:
                    if not self._resume_pending:
                        # clearing _resuming must be atomic with the
                        # final pending check: a concurrent resume()
                        # between "no pending -> return" and a
                        # later-cleared flag would see _resuming still
                        # True, queue its change on the exiting loop,
                        # and lose the wakeup
                        self._resuming = False
                        released = True
                        return
                    self._resume_pending = False
                if self._shutdown.is_set():
                    return
                # fresh discovery snapshot so the new assignment
                # reflects hosts that died/joined since the last poll
                try:
                    self._host_manager.update_available_hosts()
                except Exception:
                    pass
                # a FOLD pass re-activates only when the usable host
                # view actually moved: redundant notifications (a host
                # blacklisted twice, late duplicate failure reports)
                # must not bump the round out from under workers that
                # are already rendezvousing on the one just published
                if folded >= 0 and self._host_view() == \
                        self._last_round_view:
                    continue
                folded += 1
                try:
                    # _update_host_assignments records the view the
                    # assignment actually consumed as _last_round_view
                    self._activate_round(self._preferred_np())
                except RuntimeError:
                    # stop(error=True) was already called with the reason
                    return
        finally:
            if not released:
                # exception paths only: a normal exit already released
                # ownership under the lock, and a NEW activation loop
                # may have legitimately taken it since — clobbering
                # the flag here would let two loops run concurrently
                with self._resume_lock:
                    self._resuming = False
            if folded > 0:
                _elastic_metrics()[6].inc(folded)

    def _note_host_change(self):
        """A host left/joined outside the barrier path (failure report,
        preemption drain, late worker exit). If a round activation is
        in flight, fold the change into it — the assignment it was
        about to publish is already stale."""
        with self._resume_lock:
            if self._resuming:
                self._resume_pending = True

    def stop(self, error: bool = False, reason: Optional[str] = None):
        if error:
            self._error = reason or "elastic job failed"
        self._shutdown.set()
        self._finished.set()
        if self._on_stop is not None:
            try:
                self._on_stop()
            except Exception:
                pass

    def finished(self) -> bool:
        return self._finished.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    @property
    def error(self) -> Optional[str]:
        return self._error

    def get_results(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._results)

    def world_size(self) -> int:
        with self._lock:
            return len(self._assignments)

    def get_slot_info(self, host: str, slot: int) -> Optional[SlotInfo]:
        with self._lock:
            return self._assignments.get((host, slot))

    def has_rank_assignment(self, host: str, slot: int) -> bool:
        return self.get_slot_info(host, slot) is not None

    def wait_for_available_slots(self, min_np: int,
                                 timeout: Optional[float] = None):
        """Block until discovery shows ≥ min_np usable slots (reference
        ``driver.py`` wait_for_available_slots with elastic_timeout)."""
        deadline = time.time() + (timeout if timeout is not None
                                  else self._settings.elastic_timeout)
        while True:
            hosts = self._host_manager.current_hosts
            if hosts.count_available_slots() >= min_np:
                return hosts
            if time.time() >= deadline:
                raise TimeoutError(
                    f"timed out waiting for {min_np} slots; discovered "
                    f"{hosts.count_available_slots()} "
                    f"({hosts.host_slots})")
            try:
                self._host_manager.update_available_hosts()
            except Exception:
                pass  # keep previous view; retry next interval
            time.sleep(self._settings.discovery_interval)

    # -------------------------------------------------- worker-facing hooks

    def record_ready(self, host: str, slot: int):
        self._registry.record_ready(host, slot)

    def _on_kv_put(self, scope: str, key: str, value: bytes):
        """Rendezvous PUT hook: live workers report READY when they hit a
        reset without exiting (reference workers PUT state to the
        rendezvous the same way, ``registration.py:28``). Reports carry
        the worker's round; stale-round reports are dropped so a slow
        READY can't leak into the next round's barrier."""
        if scope == "preempt":
            # a worker received a preemption notice (SIGTERM/maintenance
            # event); broadcast a host-update so every worker reaches its
            # commit point and re-rendezvous before the chips vanish
            self._notify_workers_host_changes()
            return
        if scope == "failure":
            # a surviving worker caught HorovodInternalError and named
            # the ranks it believes died (parsed from the engine's abort
            # reason); blacklist their hosts now rather than waiting for
            # the dead workers' exit codes to trickle in
            self._on_failure_report(key, value)
            return
        if scope != "state":
            return
        try:
            host, slot = key.rsplit("/", 1)
            body = json.loads(value)
            state = str(body.get("state", "")).upper()
            rnd = int(body.get("round", -1))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            return
        if rnd >= 0 and rnd != self._rendezvous_round():
            return
        if state == "READY":
            self._registry.record_ready(host, int(slot))

    def _on_failure_report(self, key: str, value: bytes):
        """A survivor's /kv/failure report (key = ``<host>/<slot>`` of
        the REPORTER): blacklist the hosts of the ranks it named as
        failed (the port's workers name none: their collectives do not
        say which peer died, so the dead worker's exit decides). A rank
        maps to a host through the CURRENT round's
        assignment. The reporter's own host is never blacklisted from
        its report — a process crash sharing the survivor's host is not
        a lost host (the worker-exit path applies the per-host policy
        there); this also keeps single-host jobs recoverable. Reports
        that name no rank (data-plane failures carry no attribution)
        blacklist nothing — the dead worker's exit handles that.

        A ``<host>/preempt`` key is a GRACEFUL drain notice from the
        preemption watcher, not a crash: the named host leaves the next
        assignment up front and workers get the host-update broadcast,
        so the whole job converges to commit points and re-forms
        without that host ever aborting a collective."""
        try:
            reporter_host, tail = key.rsplit("/", 1)
            body = json.loads(value)
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            return
        if tail == "preempt" or (isinstance(body, dict)
                                 and body.get("graceful")):
            if self._settings.verbose:
                print(f"[elastic driver] host {reporter_host} draining "
                      f"on a preemption notice")
            self._mark_draining(reporter_host)
            self._note_host_change()
            _elastic_metrics()[5].inc()
            self._notify_workers_host_changes()
            return
        try:
            ranks = [int(r) for r in body.get("failed_ranks") or []]
        except (ValueError, TypeError, AttributeError):
            return
        if not ranks:
            return
        with self._lock:
            by_rank = {s.rank: s.hostname
                       for s in self._assignments.values()}
        for r in ranks:
            host = by_rank.get(r)
            if host is not None and host != reporter_host:
                if self._settings.verbose:
                    print(f"[elastic driver] failure report names rank "
                          f"{r} ({host}); blacklisting")
                self._host_manager.blacklist(host)
                self._note_host_change()

    def _host_view(self):
        """The inputs an assignment depends on — the fold loop's
        change detector."""
        hosts = self._host_manager.current_hosts
        return (tuple(sorted(hosts.host_slots.items())),
                tuple(sorted(self._active_draining())))

    def _mark_draining(self, host: str):
        import os

        try:
            ttl = float(os.environ.get("HVT_PREEMPT_DRAIN_SEC", "")
                        or 300.0)
        except ValueError:
            ttl = 300.0
        with self._lock:
            self._draining[host] = time.monotonic() + ttl

    def _active_draining(self) -> set:
        now = time.monotonic()
        with self._lock:
            self._draining = {h: t for h, t in self._draining.items()
                              if t > now}
            return set(self._draining)

    def _rendezvous_round(self) -> int:
        return getattr(self._rendezvous, "round", -1)

    def _handle_worker_exit(self, host: str, slot: int, exit_code: int):
        """A worker process exited. Count it toward the current round's
        barrier iff its (host, slot) is still assigned — workers are
        long-lived across rounds, so exits are always 'current' unless the
        host was dropped from the assignment. A failed worker's peers are
        told to abort first, so they report READY instead of waiting on
        it."""
        slot_info = self.get_slot_info(host, slot)
        if slot_info is not None and exit_code != 0 \
                and not self._shutdown.is_set():
            self._notify_workers_abort(
                (host, slot), f"worker {host}/{slot} (rank "
                f"{slot_info.rank}) exited with {exit_code}")
        with self._lock:
            self._workers.pop((host, slot), None)
            if slot_info is not None:
                self._results[slot_info.rank] = exit_code
        if slot_info is None:
            if exit_code != 0 and not self._shutdown.is_set():
                self._host_manager.blacklist(host)
                self._note_host_change()
            return
        if exit_code == 0:
            self._registry.record_success(host, slot)
        else:
            self._registry.record_failure(host, slot)

    # ------------------------------------------------------------ internals

    def _preferred_np(self) -> int:
        avail = self._host_manager.current_hosts.count_available_slots()
        if self._settings.max_np is not None:
            avail = min(avail, self._settings.max_np)
        return max(avail, self._settings.min_np)

    def _activate_round(self, np: int):
        slots = self._update_host_assignments(np)
        self._rendezvous.init(slots)
        self._registry.reset(len(slots))
        with self._lock:
            # results are per-round: a rank that failed in a superseded
            # round must not make a successfully recovered job exit 1
            self._results = {}
            self.rounds.append({"round": self._rendezvous_round(),
                                "size": len(slots), "time": time.time(),
                                "ranks": {f"{s.hostname}/{s.local_rank}":
                                          s.rank for s in slots}})
        rounds, resets, world, alive, blacklisted = _elastic_metrics()[:5]
        rounds.inc()
        if rounds.value > 1:
            resets.inc()
        world.set(len(slots))
        alive.set(len({s.hostname for s in slots}))
        blacklisted.set(self._host_manager.blacklisted_count())
        if self._settings.verbose:
            print(f"[elastic driver] round {self._rendezvous_round()}: "
                  f"{len(slots)} slots")
        if self._create_worker_fn is not None:
            self._start_missing_workers()

    def _update_host_assignments(self, np: int):
        """Recompute rank assignments over the current hosts, keeping
        surviving (host, slot) pairs on their previous ranks where
        possible. Raises if no host survived — elastic recovery needs at
        least one live copy of the state (reference ``driver.py:228``)."""
        hosts_snapshot = self._host_manager.current_hosts
        host_list = [HostInfo(h, hosts_snapshot.host_slots[h])
                     for h in hosts_snapshot.host_assignment_order]
        draining = self._active_draining()
        # the change-detector baseline for resume()'s fold loop: the
        # exact inputs THIS assignment consumed — a blacklist landing
        # after this line must trigger a re-activation
        self._last_round_view = (
            tuple(sorted(hosts_snapshot.host_slots.items())),
            tuple(sorted(draining)))
        if draining:
            kept = [h for h in host_list if h.hostname not in draining]
            # soft drain: preempted hosts leave the assignment only
            # while the survivors still cover min_np — a thin job keeps
            # its draining host (and simply re-rendezvouses) rather
            # than dying on a notice the platform may not honor
            if sum(h.slots for h in kept) >= self._settings.min_np:
                host_list = kept
        avail = sum(h.slots for h in host_list)
        np = min(np, avail)
        if self._settings.max_np is not None:
            np = min(np, self._settings.max_np)
        if np < self._settings.min_np:
            self.stop(error=True,
                      reason=f"available slots ({avail}) fell below "
                             f"min_np ({self._settings.min_np})")
            raise RuntimeError(self._error)
        with self._lock:
            had_assignments = bool(self._assignments)
            surviving = [k for k in self._assignments
                         if k[0] in hosts_snapshot.host_slots
                         and k[1] < hosts_snapshot.host_slots[k[0]]]
            if had_assignments and not surviving:
                self.stop(error=True,
                          reason="no hosts from the previous round "
                                 "survived; training state is lost")
                raise RuntimeError(self._error)
            slots = get_host_assignments(host_list, np)
            self._assignments = {(s.hostname, s.local_rank): s
                                 for s in slots}
        return slots

    def _start_missing_workers(self):
        started = []
        with self._lock:
            to_start = [key for key in self._assignments
                        if key not in self._workers]
            for key in to_start:
                slot_info = self._assignments[key]
                t = threading.Thread(
                    target=self._run_worker,
                    args=(key[0], key[1], slot_info), daemon=True)
                self._workers[key] = t
                started.append(t)
        for t in started:
            t.start()

    def _run_worker(self, host: str, slot: int, slot_info: SlotInfo):
        try:
            exit_code = self._create_worker_fn(slot_info)
        except Exception:
            exit_code = 1
        self._handle_worker_exit(host, slot, exit_code)

    def _discover_hosts(self):
        while not self._shutdown.is_set():
            try:
                changed = self._host_manager.update_available_hosts()
            except Exception:
                changed = False
            _elastic_metrics()[4].set(self._host_manager.blacklisted_count())
            if changed:
                self._notify_workers_host_changes()
                self._start_missing_workers_if_growing()
            self._shutdown.wait(self._settings.discovery_interval)

    def _start_missing_workers_if_growing(self):
        # New hosts don't get workers until the next round — workers join
        # at rendezvous boundaries, exactly like the reference (spawn
        # happens in _activate_round via resume()).
        pass

    def _notify_workers_host_changes(self):
        """PUT a host-update to every registered worker notification
        server (reference ``driver.py:198-226`` notifies the coordinator;
        we notify all registered workers — same observable effect: the
        next commit raises HostsUpdatedInterrupt)."""
        addrs = self._worker_notify_addrs()
        if not addrs:
            return
        from horovod_tpu_torch.runner.http_client import put_json

        payload = {"timestamp": time.time(), "res": 1}
        for addr in addrs:
            try:
                # retries=0: this fans out to every registered worker,
                # dead ones included — backoff here would stall the
                # notification of the live ones
                put_json(addr, "/notify", payload, timeout=2, retries=0)
            except OSError:
                continue

    def _notify_workers_abort(self, dead, reason: str):
        """PUT ``/abort`` to every registered worker but ``dead`` (a
        ``(host, slot)``), for the current round: each aborts its process
        group before it answers."""
        from horovod_tpu_torch.runner.http_client import put_json

        payload = {"round": self._rendezvous_round(), "reason": reason}
        skip = f"{dead[0]}/{dead[1]}"
        for addr in self._worker_notify_addrs(exclude=skip):
            try:
                put_json(addr, "/abort", payload, timeout=10, retries=0)
            except OSError:
                continue

    def _worker_notify_addrs(self, exclude=None):
        store = getattr(self._rendezvous, "store", None)
        if store is None:
            return []
        addrs = []
        for key in store.keys(_NOTIFY_SCOPE):
            if key == exclude:
                continue
            raw = store.get(_NOTIFY_SCOPE, key)
            try:
                info = json.loads(raw)
                addrs.append(f"{info['host']}:{info['port']}")
            except (ValueError, KeyError, TypeError):
                continue
        return addrs
