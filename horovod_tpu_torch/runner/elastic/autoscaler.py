"""Metrics-driven elastic autoscaler: the port's copy of the JAX package's
``runner/elastic/autoscaler.py``, the policy loop from telemetry to
elasticity.

Signals, all read from the rendezvous KV the elastic driver hosts:

- ``serving`` scope (``/kv/serving/<rank>``): per-rank in-flight backlog,
  shed counts, p99 latency, written by each rank's
  ``serving.ReplicaGang.push_stats`` (``horovod_tpu_torch.serving``; the
  load generator pushes after every phase) under an elastic launch;
- ``debugz`` scope (``/kv/debugz/<rank>``, the workers' telemetry pushes,
  ``common/basics.py``): each rank's queue depth (its pending collectives);
- ``failure`` scope (``/kv/failure/<host>/<slot>``, PUT by the elastic
  ``@run`` wrapper when a collective fails): failed-rank attributions. The
  port's reports name no rank, so the driver's own worker-exit path
  blacklists; a report that names ranks is handed to the driver as in the
  JAX package;
- ``telemetry`` scope (``/kv/telemetry/host/<host>``, one merged frame per
  host leader under ``HVT_TELEMETRY_AGG=1``): the same queue depths;
- the ``/statusz`` health engine's ``alerts`` (``metrics/telemetry.py``):
  a ``serving_backlog`` alert counts as a sustained backlog.

Decisions:

- **scale out**: when the backlog (max of serving in-flight and queue
  depth over workers) stays at or above ``HVT_AUTOSCALE_BACKLOG`` for
  ``HVT_AUTOSCALE_SUSTAIN_SEC`` and discovery shows spare slots within
  ``--max-np``, notify the workers; they reach their next commit, raise
  ``HostsUpdatedInterrupt`` and re-rendezvous into a bigger world through
  the elastic driver, state kept, nobody restarted.
- **shed**: when a failure report names broken ranks, hand it to the
  driver, which blacklists their hosts; the next round excludes them.

A cooldown (``HVT_AUTOSCALE_COOLDOWN_SEC``) separates decisions. Enable in
an elastic launch (``--min-np`` or ``--host-discovery-script``) with
``HVT_AUTOSCALE=1``; the loop polls every ``HVT_AUTOSCALE_INTERVAL_SEC``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


def _as_float(raw, default: float) -> float:
    try:
        return float(raw if raw not in (None, "") else default)
    except ValueError:
        return default


class AutoscalePolicy:
    """Thresholds for the decision loop (env-seeded, test-overridable).

    Env reads stay literal (no name indirection) so the env↔docs lint
    pass sees every knob."""

    def __init__(self, backlog_threshold: float = None,
                 sustain_sec: float = None, cooldown_sec: float = None,
                 interval_sec: float = None):
        self.backlog_threshold = (
            backlog_threshold if backlog_threshold is not None
            else _as_float(os.environ.get("HVT_AUTOSCALE_BACKLOG"), 8))
        self.sustain_sec = (
            sustain_sec if sustain_sec is not None
            else _as_float(os.environ.get("HVT_AUTOSCALE_SUSTAIN_SEC"),
                           10))
        self.cooldown_sec = (
            cooldown_sec if cooldown_sec is not None
            else _as_float(os.environ.get("HVT_AUTOSCALE_COOLDOWN_SEC"),
                           30))
        self.interval_sec = (
            interval_sec if interval_sec is not None
            else _as_float(os.environ.get("HVT_AUTOSCALE_INTERVAL_SEC"),
                           2))


def _metrics():
    from horovod_tpu_torch import metrics

    return (
        metrics.counter("hvt_autoscaler_decisions_total",
                        "autoscaler decisions by action",
                        ("action",)),
        metrics.gauge("hvt_autoscaler_backlog",
                      "current gang-wide backlog signal (max of serving "
                      "in-flight and engine queue depth over workers)"),
        metrics.gauge("hvt_autoscaler_spare_slots",
                      "discovered slots beyond the current world size"),
    )


class Autoscaler:
    """Policy loop over an :class:`ElasticDriver` and its rendezvous.

    ``step(now)`` is the whole brain and is synchronous — tests drive it
    directly with fake stores/drivers; ``start()`` wraps it in a daemon
    thread for the launcher.
    """

    def __init__(self, driver, rendezvous,
                 policy: Optional[AutoscalePolicy] = None,
                 verbose: bool = False):
        self._driver = driver
        self._rendezvous = rendezvous
        self.policy = policy or AutoscalePolicy()
        self._verbose = verbose
        self._backlog_since: Optional[float] = None
        self._last_action_t = 0.0
        self._last_err_t = -1e9
        # (scope, key) → (last raw payload, first-seen monotonic sec)
        self._payload_seen = {}
        self._seen_failures = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions = []  # (t, action, detail) — introspection/tests

    # ------------------------------------------------------------- signals

    def _store(self):
        return getattr(self._rendezvous, "store", None)

    # A snapshot whose payload has not CHANGED for this long (of the
    # driver's own monotonic clock) is treated as dead and ignored: the
    # "serving"/"debugz" KV scopes survive round resets (by design —
    # the autoscaler must not go blind at the rendezvous it caused), so
    # a shed rank's final push would otherwise pin the backlog signal
    # high forever. Change-detection rather than snapshot timestamps on
    # purpose: worker wall clocks skew across hosts (the timeline runs
    # a /clock offset handshake for exactly that reason), while a LIVE
    # worker re-pushes every few seconds with a changing payload (ts /
    # cycle counters), which this observes without trusting any remote
    # clock.
    STALE_SNAPSHOT_SEC = 15.0

    def _fresh(self, scope: str, key: str, raw, mono_now: float) -> bool:
        prev = self._payload_seen.get((scope, key))
        if prev is None or prev[0] != raw:
            self._payload_seen[(scope, key)] = (raw, mono_now)
            return True
        return mono_now - prev[1] <= self.STALE_SNAPSHOT_SEC

    def read_backlog(self, mono_now: Optional[float] = None) -> float:
        """Gang-wide backlog: max over workers of the serving in-flight
        depth and the engine client queue depth. Snapshots that stopped
        changing (dead rank) or whose rank id is outside the current
        world are discarded."""
        store = self._store()
        if store is None:
            return 0.0
        mono_now = time.monotonic() if mono_now is None else mono_now
        try:
            world = self._driver.world_size()
        except Exception:
            world = None
        worst = 0.0
        for scope, depth_of in (
                ("serving", lambda b: b.get("inflight", 0)),
                ("debugz",
                 lambda b: (b.get("engine") or {}).get("queue_depth", 0))):
            for key in store.keys(scope):
                try:
                    if world is not None and int(key) >= world:
                        continue  # rank id not in the current round
                    raw = store.get(scope, key)
                    if not self._fresh(scope, key, raw, mono_now):
                        continue  # a dead/shed rank's final push
                    worst = max(worst, float(depth_of(json.loads(raw))))
                except (ValueError, TypeError, AttributeError):
                    # AttributeError: valid JSON that is not an object
                    # (a buggy/old pusher) — skip it, never abort step()
                    continue
        # leader-aggregated gangs (HVT_TELEMETRY_AGG=1): per-rank
        # queue depths arrive inside ONE host frame per host instead of
        # per-rank debugz keys — the autoscaler reads both shapes so a
        # topology switch never blinds the backlog signal
        for key in store.keys("telemetry"):
            if not key.startswith("host/"):
                continue
            try:
                raw = store.get("telemetry", key)
                if not self._fresh("telemetry", key, raw, mono_now):
                    continue
                for r_str, rec in (json.loads(raw).get("ranks")
                                   or {}).items():
                    if world is not None and int(r_str) >= world:
                        continue
                    worst = max(worst,
                                float(rec.get("queue_depth", 0)))
            except (ValueError, TypeError, AttributeError):
                continue
        return worst

    def read_failed_ranks(self) -> dict:
        """Unseen failure reports: ``{(host_slot_key): [ranks]}``."""
        store = self._store()
        if store is None:
            return {}
        out = {}
        for key in store.keys("failure"):
            raw = store.get("failure", key)
            # dedup by (key, payload): the failure scope is cleared at
            # round resets, so a later round's genuinely-new report can
            # legitimately reuse the same <host>/<slot> key. Marked
            # seen BEFORE parsing: a malformed report is skipped once,
            # not re-tripped on every poll.
            sig = (key, raw)
            if sig in self._seen_failures:
                continue
            self._seen_failures.add(sig)
            try:
                body = json.loads(raw)
                ranks = [int(r) for r in body.get("failed_ranks") or []]
            except (ValueError, TypeError, AttributeError):
                continue
            out[key] = ranks
        return out

    def _shed_report(self, key: str):
        """Route a failure report through the driver's own handler —
        ONE home for the blacklist policy (reporter-host guard, rank →
        host mapping). Idempotent with the driver's live KV put-hook,
        which already ran for reports that arrived over HTTP; this path
        covers store-injected reports (tests, replayed KV)."""
        handler = getattr(self._driver, "_on_failure_report", None)
        if handler is None:
            return
        store = self._store()
        raw = store.get("failure", key) if store is not None else None
        if raw is None:
            return
        try:
            handler(key, raw)
        except Exception as e:
            self._log_error(f"failure-report handoff failed: {e!r}")

    def read_health_alerts(self) -> list:
        """Active health alerts from the rendezvous server's /statusz
        health engine (``metrics/telemetry.py``), or [] when the
        rendezvous has no statusz surface (tests with bare fakes).
        Building the snapshot also advances the health windows — the
        engine self-gates ingestion to the push interval, so the 2 s
        policy loop cannot fast-forward persistence rules."""
        snap_fn = getattr(self._rendezvous, "statusz_snapshot", None)
        if snap_fn is None:
            return []
        try:
            return list((snap_fn() or {}).get("alerts") or [])
        except Exception as e:
            self._log_error(f"statusz read failed: {e!r}")
            return []

    def spare_slots(self) -> int:
        hm = getattr(self._driver, "host_manager", None)
        if hm is None:
            return 0
        try:
            avail = hm.current_hosts.count_available_slots()
        except Exception:
            return 0
        # the driver caps every round at settings.max_np — slots beyond
        # it are not scalable capacity, and counting them would force a
        # disruptive re-rendezvous that changes nothing, every cooldown
        max_np = getattr(getattr(self._driver, "_settings", None),
                         "max_np", None)
        if max_np:
            avail = min(avail, max_np)
        return max(0, avail - self._driver.world_size())

    # ------------------------------------------------------------ decisions

    def _record(self, now: float, action: str, detail: str):
        self.decisions.append((now, action, detail))
        self._last_action_t = now
        try:
            decisions, _, _ = _metrics()
            decisions.labels(action=action).inc()
        except Exception:
            pass
        if self._verbose:
            print(f"[autoscaler] {action}: {detail}")

    def step(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now

        # shed-and-blacklist first: a broken rank is a correctness event,
        # not a load event — it never waits out a cooldown
        failures = self.read_failed_ranks()
        if failures:
            named = sorted({r for rs in failures.values() for r in rs})
            for key in failures:
                self._shed_report(key)
            self._record(now, "shed",
                         f"failure reports {sorted(failures)} named "
                         f"ranks {named}; hosts blacklisted, next round "
                         f"excludes them")

        # one clock governs the whole decision: the staleness filter
        # must tick with the same `now` the sustain/cooldown logic uses
        # (tests drive step() with a synthetic clock)
        backlog = self.read_backlog(mono_now=now)
        spare = self.spare_slots()
        try:
            _, backlog_g, spare_g = _metrics()
            backlog_g.set(backlog)
            spare_g.set(spare)
        except Exception:
            pass

        if backlog < self.policy.backlog_threshold:
            self._backlog_since = None
            return
        if self._backlog_since is None:
            self._backlog_since = now
        sustained = now - self._backlog_since
        # a serving_backlog health alert already encodes persistence
        # (strict growth over HVT_HEALTH_BACKLOG_WINDOWS push windows),
        # so it satisfies the sustain requirement directly — the
        # statusz health engine and this loop agree on "sustained"
        # instead of each waiting out the other. Checked ONLY when the
        # time-based test alone would block: building the statusz
        # snapshot parses every pushed blob, which is not a
        # per-2s-tick cost to pay when the answer cannot change the
        # decision.
        if sustained < self.policy.sustain_sec:
            if not any(a.get("rule") == "serving_backlog"
                       for a in self.read_health_alerts()):
                return
        if now - self._last_action_t < self.policy.cooldown_sec:
            return
        if spare <= 0:
            # nothing to scale onto; keep the sustain window armed so
            # a host arriving later triggers immediately
            return
        self._scale_out(now, backlog, spare)

    def _scale_out(self, now: float, backlog: float, spare: int):
        # the zero-downtime path: notify workers exactly like a
        # discovery change — they reach their next commit, report READY,
        # and the driver's barrier activates a round over ALL available
        # slots (state intact, nobody restarted)
        notify = getattr(self._driver, "_notify_workers_host_changes",
                         None)
        if notify is None:
            return
        # the driver's notify returns None unconditionally and swallows
        # per-worker send errors, so "nobody is registered to hear this"
        # must be checked up front — otherwise a no-op notification
        # would burn the sustain window + cooldown having told no one
        addrs_fn = getattr(self._driver, "_worker_notify_addrs", None)
        if addrs_fn is not None:
            try:
                if not addrs_fn():
                    self._log_error(
                        "scale-out pending: no worker notification "
                        "endpoints registered yet")
                    return
            except Exception:
                pass  # cannot tell — proceed and let notify try
        try:
            notify()
        except Exception as e:
            # leave the sustain window armed: the missed notification
            # retries on the very next step instead of re-earning
            # sustain_sec + cooldown_sec
            self._log_error(f"scale-out notify failed: {e!r}")
            return
        self._record(now, "scale_out",
                     f"backlog {backlog:.0f} ≥ "
                     f"{self.policy.backlog_threshold:.0f} sustained "
                     f"{self.policy.sustain_sec:.0f}s with {spare} spare "
                     f"slot(s); re-rendezvous requested")
        self._backlog_since = None

    # -------------------------------------------------------------- thread

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvt-autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _log_error(self, msg: str):
        """Rate-limited (60 s) stderr note: a persistently-failing
        policy loop must be visible, never silently inert."""
        import sys

        now = time.monotonic()
        if now - self._last_err_t < 60:
            return
        self._last_err_t = now
        print(f"[autoscaler] {msg}", file=sys.stderr)

    def _loop(self):
        while not self._stop.wait(self.policy.interval_sec):
            if getattr(self._driver, "finished", lambda: False)():
                return
            try:
                self.step()
            except Exception as e:
                # policy failures must never take the launcher down —
                # but they must not be invisible either
                self._log_error(f"step failed: {e!r}")


def maybe_start_autoscaler(driver, rendezvous, verbose=False):
    """Launcher hook: start the loop iff ``HVT_AUTOSCALE=1``. Returns
    the Autoscaler (started) or None."""
    if os.environ.get("HVT_AUTOSCALE", "0") != "1":
        return None
    scaler = Autoscaler(driver, rendezvous, verbose=verbose)
    scaler.start()
    return scaler
