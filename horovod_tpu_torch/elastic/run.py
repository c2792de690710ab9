"""The elastic run wrapper: the port's copy of the JAX package's
``horovod_tpu/elastic/run.py`` (Horovod's ``common/elastic.py:147``
``run_fn`` and the worker side of the re-rendezvous,
``runner/elastic/worker.py``)."""

from __future__ import annotations

import functools
import os
import random
import socket
import time
import urllib.error

from horovod_tpu_torch import metrics
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.utils import timeline

_LOCAL_NAMES = ("localhost", "127.0.0.1")

# every finished recovery episode of this process, oldest first:
# {"trigger", "round", "seconds", "phases": {phase: seconds}}
recoveries = []


def run(func):
    """Decorator: ``@hvt.elastic.run`` around ``train(state, ...)``.

    - HorovodInternalError (a collective failed, a peer was lost): abort
      the world (a communicator whose peer died is never waited on),
      restore() to the last commit, then re-initialize and retry.
    - HostsUpdatedInterrupt (a host change, told at commit()): keep the
      current state, re-initialize and retry (sync unless skip_sync).

    Under an elastic launch (``HVT_RENDEZVOUS_ADDR`` set), each
    re-initialization reports READY to the driver and waits on the
    rendezvous for the next round's slot (new rank, size and coordinator)
    before ``basics.reinit``; a worker whose slot was dropped exits
    cleanly. The re-initialization takes the device and timeout of the
    last ``init``.
    """

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        from horovod_tpu_torch.elastic import preemption
        from horovod_tpu_torch.runner.elastic import notification

        notification.init_worker_notification(state)
        # a preemption notice (SIGTERM, a maintenance event) surfaces as
        # HostsUpdatedInterrupt at the next commit
        preemption.watch_state(state)
        round_ = _sync_slot_from_rendezvous(0)
        reset_required = False
        skip_sync = False
        recovery = None  # _Recovery while a failure/update is in flight
        while True:
            if reset_required:
                round_ = _reset(round_, recovery)
                state.on_reset()
            try:
                if not skip_sync:
                    t0 = time.monotonic()
                    state.sync()
                    if recovery is not None:
                        recovery.phase("rebuild",
                                       time.monotonic() - t0,
                                       outcome=_sync_outcome(state))
                if recovery is not None:
                    recovery.finish(round_)
                    recovery = None
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                # a collective failed (a peer lost): tear the world down
                # without waiting on the dead peer, tell the driver, roll
                # back to the last commit and re-rendezvous
                recovery = _Recovery("failure")
                t0 = time.monotonic()
                basics.abort(f"recovering from: {e}")
                recovery.phase("abort", time.monotonic() - t0)
                _report_failure(round_, e)
                t0 = time.monotonic()
                state.restore()
                recovery.phase("restore", time.monotonic() - t0)
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                if recovery is None:
                    recovery = _Recovery("host_update")
                skip_sync = e.skip_sync
            reset_required = True

    return wrapper


class _Recovery:
    """One recovery episode's clock, by phase: ``abort`` (a failure's
    teardown of the world), ``restore``, ``shutdown``, ``rendezvous``
    (waiting for the next round), ``reinit`` and ``rebuild`` (``sync``).
    Each phase's seconds go to
    ``/kv/recovery/<host>/<slot>`` on the driver's rendezvous (under an
    elastic launch) and, when the episode ends, to :data:`recoveries`, to
    the timeline as ``RECOVERY(<phase>, <outcome>)`` events, and to the
    ``hvt_recovery_rounds_total{trigger}`` and
    ``hvt_recovery_end_to_end_seconds`` metrics."""

    def __init__(self, trigger: str):
        self.trigger = trigger
        self.t0 = time.monotonic()
        self.phases = []  # (phase, seconds, outcome)

    def phase(self, name: str, seconds: float, outcome: str = "ok"):
        self.phases.append((name, seconds, outcome))
        _report_recovery({"phase": name, "outcome": outcome,
                          "seconds": round(seconds, 4),
                          "trigger": self.trigger})

    def finish(self, round_: int):
        total = time.monotonic() - self.t0
        phases = {n: s for n, s, _ in self.phases}
        recoveries.append({"trigger": self.trigger, "round": round_,
                           "seconds": total, "phases": phases})
        _report_recovery({"phase": "recovered", "outcome": "ok",
                          "seconds": round(total, 4), "round": round_,
                          "trigger": self.trigger,
                          "phases": {n: round(s, 4)
                                     for n, s in phases.items()}})
        # the timeline was stopped with the world for most of the episode:
        # every phase is stamped now, as the JAX package stamps them into
        # its engine's ring after re-init
        for name, seconds, outcome in self.phases:
            timeline.record_recovery(name, outcome, seconds)
        timeline.record_recovery("recovered", "ok", total)
        metrics.counter(
            "hvt_recovery_rounds_total",
            "completed elastic recovery episodes by trigger",
            ("trigger",)).labels(trigger=self.trigger).inc()
        metrics.gauge(
            "hvt_recovery_end_to_end_seconds",
            "duration of the last recovery episode (failure/update "
            "detection to training resumed)").set(total)


def _sync_outcome(state) -> str:
    last = getattr(state, "last_recovery", None)
    if isinstance(last, dict):
        return str(last.get("outcome", "ok"))
    return "ok"


def _reset(last_round: int, recovery=None) -> int:
    """Re-initialize after a world change: report READY, shut the world
    down, wait for the new round's slot, then start the new world with
    the device and timeout of the last init (Horovod's shutdown/init cycle,
    ``common/elastic.py:95-109``)."""
    _report_state("READY", last_round)
    t0 = time.monotonic()
    basics.shutdown()
    t1 = time.monotonic()
    new_round = _sync_slot_from_rendezvous(last_round)
    t2 = time.monotonic()
    basics.reinit()
    if recovery is not None:
        recovery.phase("shutdown", t1 - t0)
        recovery.phase("rendezvous", t2 - t1)
        recovery.phase("reinit", time.monotonic() - t2)
    return new_round


def _elastic_addr():
    return os.environ.get("HVT_RENDEZVOUS_ADDR")


_identity = None


def _my_identity():
    """Spawn-time (host, local_rank) — cached, because it is this
    process's stable identity toward the driver even after
    ``_apply_slot_env`` rewrites the env for a new round."""
    global _identity
    if _identity is None:
        _identity = (os.environ.get("HVT_HOSTNAME") or socket.gethostname(),
                     os.environ.get("HVT_LOCAL_PROCESS_ID", "0"))
    return _identity


def _put_report(scope: str, obj: dict, retries: int = 0,
                timeout: float = 5.0) -> bool:
    """PUT one report to ``/kv/<scope>/<host>/<slot>`` on the driver's
    rendezvous; best-effort (the driver may itself be down)."""
    addr = _elastic_addr()
    if not addr:
        return False
    from horovod_tpu_torch.runner.http_client import put_json

    host, slot = _my_identity()
    try:
        put_json(addr, f"/kv/{scope}/{host}/{slot}", obj, timeout=timeout,
                 retries=retries)
        return True
    except OSError:
        return False


def _relay_report(scope: str, key: str, obj: dict, urgent: bool,
                  timeout: float = 5.0) -> bool:
    """PUT a worker report through the host leader's relay
    (``metrics/telemetry.py relay_put``: under ``HVT_TELEMETRY_AGG=1`` one
    ``/kvbulk`` request a host per flush), falling back to a direct PUT;
    best-effort, as the driver may itself be down."""
    addr = _elastic_addr()
    if not addr:
        return False
    try:
        from horovod_tpu_torch.metrics.telemetry import relay_put

        return relay_put(addr, scope, key, obj, urgent=urgent,
                         timeout=timeout)
    except Exception:
        return False


def _report_failure(round_: int, err: Exception):
    """A failure report to the driver (``/kv/failure/<host>/<slot>``),
    urgent. The port's collectives name no failed peer, so
    ``failed_ranks`` is empty and the dead worker's own exit tells the
    driver which slot it was."""
    host, slot = _my_identity()
    _relay_report("failure", f"{host}/{slot}",
                  {"round": round_, "error": str(err)[:2048],
                   "failed_ranks": []}, urgent=True)


def _report_state(state_name: str, round_: int):
    host, slot = _my_identity()
    body = {"state": state_name, "round": round_}
    if _relay_report("state", f"{host}/{slot}", body, urgent=True):
        return
    # the driver's round barrier counts READY reports: worth a retried
    # direct PUT when the relay and its direct fallback both failed
    _put_report("state", body, retries=4)


def _report_recovery(body: dict):
    """One recovery-phase report (``/kv/recovery/<host>/<slot>``); not
    urgent: it may ride the leader's next flush."""
    host, slot = _my_identity()
    _relay_report("recovery", f"{host}/{slot}",
                  dict(body, host=host, slot=slot, ts=time.time()),
                  urgent=False, timeout=3.0)


def _sync_slot_from_rendezvous(last_round: int,
                               timeout: float = 600.0) -> int:
    """Block until the rendezvous publishes a round newer than
    ``last_round`` containing our (host, local_rank) slot, then update the
    process env (rank/size/cross/coordinator) for ``basics.reinit``.

    Returns the new round number. No-op (returns ``last_round``) outside
    an elastic launch. Exits the process cleanly when our slot was
    dropped from the new assignment.
    """
    addr = _elastic_addr()
    if not addr:
        return last_round
    from horovod_tpu_torch.runner.http_client import get_json

    host, slot = _my_identity()
    deadline = time.time() + timeout
    # jittered exponential poll backoff (0.1 s → 2 s cap): workers poll
    # fast right after READY, then back off, so a large gang's polls do
    # not starve the reports the round is waiting on
    delay = 0.1
    last_ready = time.time()
    while time.time() < deadline:
        # re-report READY if no new round shows up for a while: the
        # driver's barrier dedupes repeats
        if time.time() - last_ready > 7.5:
            _report_state("READY", last_round)
            last_ready = time.time()
        info = world = None
        try:
            world = get_json(addr, "/world")
            info = get_json(addr, f"/rendezvous/{host}/{slot}")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        except OSError:
            pass
        if world and world.get("round", 0) > last_round:
            if info is None or info.get("round", 0) != world["round"]:
                if info is None:
                    # new round exists and we are not in it → retire
                    raise SystemExit(0)
            else:
                _apply_slot_env(info, world)
                return world["round"]
        time.sleep(delay * (0.5 + 0.5 * random.random()))
        delay = min(delay * 1.5, 2.0)
    raise TimeoutError(
        f"elastic worker {host}/{slot} timed out waiting for round "
        f"> {last_round} from rendezvous {addr}")


def _apply_slot_env(info: dict, world: dict):
    """The new round's identity, and ``HVT_COORDINATOR_ADDR`` on the TCP
    store port the launcher probed for this round (world info), where
    ``basics.init`` joins the processes."""
    env = os.environ
    env["HVT_PROCESS_ID"] = str(info["rank"])
    env["HVT_NUM_PROCESSES"] = str(info["size"])
    env["HVT_LOCAL_PROCESS_ID"] = str(info["local_rank"])
    env["HVT_LOCAL_SIZE"] = str(info["local_size"])
    env["HVT_CROSS_RANK"] = str(info["cross_rank"])
    env["HVT_CROSS_SIZE"] = str(info["cross_size"])
    env["HVT_ELASTIC_ROUND"] = str(world["round"])
    master_host = world["master_host"]
    addr = "127.0.0.1" if master_host in _LOCAL_NAMES or \
        master_host == socket.gethostname() else master_host
    env["HVT_COORDINATOR_ADDR"] = f"{addr}:{world['master_port']}"
