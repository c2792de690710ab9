"""Worker state registry: the port's copy of the JAX package's
``runner/elastic/registration.py`` (Horovod's
``runner/elastic/registration.py:28`` WorkerStateRegistry —
READY/SUCCESS/FAILURE barrier that triggers ``driver.resume()``).

Each worker process reports a terminal state for the current rendezvous
round. When every worker of the round has reported:

- all SUCCESS            → the job is done; the driver stops.
- any FAILURE / READY    → a new rendezvous round is needed; the driver
                           resumes (re-assigns ranks, restarts workers)
                           unless ``reset_limit`` is exhausted.

READY means "I hit HostsUpdatedInterrupt and am waiting for the new
round" — it counts toward the barrier but is not a failure.
"""

from __future__ import annotations

import threading
from typing import Optional

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: Optional[int] = None,
                 verbose: bool = False):
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._verbose = verbose
        self._lock = threading.Lock()
        self._barrier_done = threading.Event()
        self._states = {}          # (host, slot) → state, current round
        self._round = 0
        self._reset_count = 0
        self._size = 0

    @property
    def reset_count(self) -> int:
        return self._reset_count

    @property
    def round(self) -> int:
        return self._round

    def reset(self, size: int):
        """Start a new round expecting ``size`` workers."""
        with self._lock:
            self._states = {}
            self._size = size
            self._round += 1
            self._barrier_done.clear()

    def record_ready(self, host: str, slot: int):
        return self._record(host, slot, READY)

    def record_success(self, host: str, slot: int):
        return self._record(host, slot, SUCCESS)

    def record_failure(self, host: str, slot: int):
        return self._record(host, slot, FAILURE)

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)

    def last_round_complete(self) -> bool:
        return self._barrier_done.is_set()

    def _record(self, host: str, slot: int, state: str) -> int:
        with self._lock:
            key = (host, slot)
            # first terminal state wins: a worker that failed and was then
            # torn down should not flip to SUCCESS
            if key not in self._states or self._states[key] == READY:
                self._states[key] = state
            complete = (self._size > 0
                        and len(self._states) >= self._size)
            rnd = self._round
        if complete:
            self._on_barrier(rnd)
        return rnd

    def _on_barrier(self, rnd: int):
        with self._lock:
            if self._barrier_done.is_set() or rnd != self._round:
                return
            self._barrier_done.set()
            states = dict(self._states)
        failures = sum(1 for s in states.values() if s == FAILURE)
        successes = sum(1 for s in states.values() if s == SUCCESS)
        if failures == 0 and successes == len(states) and successes > 0:
            self._driver.stop(error=False)
            return
        # blacklist hosts where every slot failed (reference blacklists the
        # failing host so ranks are not reassigned onto it)
        by_host = {}
        for (host, _slot), s in states.items():
            by_host.setdefault(host, []).append(s)
        for host, slot_states in by_host.items():
            if slot_states and all(s == FAILURE for s in slot_states):
                self._host_manager.blacklist(host)
        self._reset_count += 1
        if self._reset_limit is not None \
                and self._reset_count > self._reset_limit:
            self._driver.stop(
                error=True,
                reason=f"reset count {self._reset_count} exceeded limit "
                       f"{self._reset_limit}")
            return
        self._driver.resume()
