"""Preemption notice → elastic interrupt: the port's copy of the JAX
package's ``horovod_tpu/elastic/preemption.py``.

The earliest preemption signal lands on the worker itself (SIGTERM with a
grace window on preemptible and spot machines; maintenance events through
a metadata server), so the watcher lives worker-side and feeds the driver's
host-update machinery (Horovod's ``runner/elastic/driver.py:177-260``,
``common/elastic.py:73-93``):

- :meth:`PreemptionWatcher.install` registers a SIGTERM handler (main
  thread only, as Python allows) and a poll thread when a maintenance-event
  ``poll_fn`` is supplied.
- On a notice, every watched :class:`~horovod_tpu_torch.elastic.state.State`
  gets ``on_hosts_updated()``, so the next ``commit()`` raises
  ``HostsUpdatedInterrupt`` at a safe point and ``@hvt.elastic.run``
  re-rendezvouses through the reset path. Neither the handler nor the poll
  thread calls a collective.
- The notice is also reported to the elastic driver (PUT
  ``/kv/preempt/<host>/<slot>``), which tells every worker of the host
  change, so the whole job converges to its commit points.

Enabled by ``@hvt.elastic.run`` under an elastic launch;
``HVT_PREEMPTION_WATCH=0`` opts out, ``=1`` forces it on outside a
launcher.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time
from typing import Callable, Optional

_watcher: Optional["PreemptionWatcher"] = None
_lock = threading.Lock()


class PreemptionWatcher:
    """Worker-side preemption/maintenance watcher.

    Parameters
    ----------
    poll_fn:
        Optional zero-arg callable polled from a daemon thread; returning
        truthy means "this host has a pending maintenance/preemption
        event" (plug a cloud metadata-server probe in here).
    poll_interval:
        Seconds between ``poll_fn`` polls.
    signals:
        Signals treated as preemption notices (default: SIGTERM).
    """

    def __init__(self, poll_fn: Optional[Callable[[], bool]] = None,
                 poll_interval: float = 5.0,
                 signals=(signal.SIGTERM,)):
        self._poll_fn = poll_fn
        self._poll_interval = poll_interval
        self._signals = tuple(signals)
        self._states = []
        self._prev_handlers = {}
        self._installed = False
        self._triggered = threading.Event()
        self._poll_thread = None
        self._state_lock = threading.Lock()

    # ------------------------------------------------------------- states

    def watch(self, state):
        with self._state_lock:
            if state not in self._states:
                self._states.append(state)

    def unwatch(self, state):
        with self._state_lock:
            if state in self._states:
                self._states.remove(state)

    # ------------------------------------------------------------ install

    def install(self):
        """Register signal handlers (main thread only — elsewhere only the
        poll thread runs) and start the maintenance poll thread."""
        if self._installed:
            return self
        self._installed = True
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_signal)
        if self._poll_fn is not None:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="hvt-preemption-poll")
            self._poll_thread.start()
        return self

    def uninstall(self):
        if not self._installed:
            return
        self._installed = False
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    @property
    def installed(self) -> bool:
        return self._installed

    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    # ------------------------------------------------------------ trigger

    def trigger(self, reason: str = "preemption"):
        """Deliver a preemption notice: flag every watched state (the
        next ``commit()`` replicates its shards — ReplicatedState
        exchanges BEFORE the host-update check raises, so peers hold
        the final version when the cards vanish — then raises
        HostsUpdatedInterrupt) and tell the elastic driver so all peers
        converge to their commit points. The driver hears it twice, on
        purpose: ``/kv/preempt/<host>/<slot>`` broadcasts the
        host-update to every worker, and the ``/kv/failure/<host>/
        preempt`` notice marks this host as GRACEFULLY draining — the
        driver drops it from the next assignment up front, so a
        preempted host never has to look like a crash (no abort storm,
        no failure-report attribution) before it leaves."""
        self._triggered.set()
        now = time.time()
        with self._state_lock:
            states = list(self._states)
        for state in states:
            try:
                state.on_hosts_updated(now, reason)
            except Exception:
                pass
        self._report_driver(reason)

    def _on_signal(self, signum, frame):
        self.trigger(reason=f"signal:{signum}")

    def _poll_loop(self):
        while self._installed and not self._triggered.is_set():
            try:
                if self._poll_fn():
                    self.trigger(reason="maintenance-event")
                    return
            except Exception:
                pass
            time.sleep(self._poll_interval)

    def _report_driver(self, reason: str):
        addr = os.environ.get("HVT_RENDEZVOUS_ADDR")
        if not addr:
            return
        from horovod_tpu_torch.runner.http_client import put_json

        host = os.environ.get("HVT_HOSTNAME") or socket.gethostname()
        slot = os.environ.get("HVT_LOCAL_PROCESS_ID", "0")
        try:
            put_json(addr, f"/kv/preempt/{host}/{slot}",
                     {"reason": reason, "timestamp": time.time()},
                     timeout=2, retries=0)
            # graceful-drain notice: one per HOST (the preemption takes
            # the whole host's cards), keyed `<host>/preempt` so the
            # driver's failure hook can tell a drain from a crash and
            # drop the host from the next round without blaming anyone
            put_json(addr, f"/kv/failure/{host}/preempt",
                     {"reason": reason, "graceful": True,
                      "timestamp": time.time()}, timeout=2, retries=0)
        except OSError:
            pass


# ---------------------------------------------------------------- module API

def watch_state(state, poll_fn: Optional[Callable[[], bool]] = None):
    """Attach ``state`` to the process-wide watcher, creating/installing it
    if preemption watching is enabled (elastic launch, or
    ``HVT_PREEMPTION_WATCH=1``). Called by ``@hvt.elastic.run``."""
    global _watcher
    knob = os.environ.get("HVT_PREEMPTION_WATCH", "")
    if knob == "0":
        return None
    if not knob and not os.environ.get("HVT_RENDEZVOUS_ADDR"):
        return None
    with _lock:
        if _watcher is None:
            _watcher = PreemptionWatcher(poll_fn=poll_fn)
            _watcher.install()
        _watcher.watch(state)
    return _watcher


def get_watcher() -> Optional[PreemptionWatcher]:
    return _watcher


def _reset_for_tests():
    global _watcher
    with _lock:
        if _watcher is not None:
            _watcher.uninstall()
        _watcher = None
