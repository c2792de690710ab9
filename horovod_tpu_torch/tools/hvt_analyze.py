"""Critical-path analyzer for the port's timelines
(``python -m horovod_tpu_torch.tools.hvt_analyze``): the port's copy of the
JAX package's ``tools/hvt_analyze.py``. Which phase is slow, negotiation or
execution, and which rank arrives last?

Input: one merged timeline (``launch --timeline out.json``) or any number
of per-rank shards (``out.json.rank<r>``; a shard cut short by a killed
worker still loads), read with ``horovod_tpu_torch.utils.timeline``'s
parser. The events read are the coordinator's (``ops/negotiation.py``), on
the lane ``<tensor> (coordinator)`` of each rank (the JAX engine's
``<tensor> (engine)`` lanes are read the same way, so the JAX package's
timelines analyze here too):

- **phase breakdown** per tensor and overall: ``queue`` (the call to the
  data's issue, which holds the negotiation), ``negotiate`` (from the
  first member's arrival to the set's lowest rank reading every request),
  ``exec`` (issue to the wait's end, host clock) and ``e2e``;
- **straggler ranking**: whose ``RANK_READY`` comes last in each
  negotiation, how often and by how much; the set's lowest rank writes the
  arrivals, so each negotiation is scored once;
- **compute/comm overlap** per rank: the share of execution time during
  which other collectives of the rank were in flight;
- **per-lane percentiles** of execution, by process set (lane 0 is the
  global set, else the set's id).

Absent from the port's timelines, so empty in its reports: ``wire`` and
``reduce`` (the engine's ``WIRE_`` spans of its TCP pump; NCCL's device
time is in the ``NCCL_<OP>`` spans of the ``(device)`` lanes instead), the
per-cycle stats (``CYCLE`` and ``CTRL`` instants) and link recovery
(``RECONNECT``/``REPLAY``); the engine's response cache skips negotiation
on a hit, while the port negotiates every call, so every negotiation is
scored.

``--diff BASE CUR`` compares the ``metrics`` blocks of two reports with
ratio bands and exits 1 on a regression, as the JAX tool does: only
``p50`` keys gate, baselines below ``--min-base-us`` are skipped, a gated
key missing from the current report fails, and ``HVT_PERFGATE_MAX_RATIO``
overrides the 2.0x band.

Stdlib and ``utils/timeline.py`` only: it runs where neither torch nor a
card is.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from horovod_tpu_torch.utils import timeline as _tl

SCHEMA = "hvt-analyze-r1"

# phase keys in report order; "metrics" carries <phase>_us_p50 for each
PHASES = ("queue", "negotiate", "wire", "reduce", "exec", "e2e")

# the roles a CTRL instant of the JAX engine can carry (its
# utils/timeline.py CTRL_ROLES); the port writes none
CTRL_ROLES = ("root", "leader", "member")
# the per-tensor lifecycle lanes: the port's coordinator's, and the JAX
# engine's
_LANE_SUFFIXES = (" (coordinator)", " (engine)")

_CYCLE_RE = re.compile(r"ENGINE_CYCLE\((\d+) responses\)")
_CTRL_RE = re.compile(r"CTRL\((\d+) B tx, (\d+) B rx\)")
_READY_RE = re.compile(r"RANK_READY_(\d+)$")


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_events(paths):
    """One event list from a merged trace or N raw shards (each parsed
    with the truncation-tolerant loader)."""
    shards = [_tl.load_trace(p) for p in paths]
    if len(shards) == 1:
        return shards[0]
    return _tl.merge_traces(shards)


# ---------------------------------------------------------------------------
# statistics helpers
# ---------------------------------------------------------------------------

def _pctl(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _stats(vals):
    if not vals:
        return None
    s = sorted(vals)
    return {
        "count": len(s),
        "p50": round(_pctl(s, 0.50), 1),
        "p90": round(_pctl(s, 0.90), 1),
        "p99": round(_pctl(s, 0.99), 1),
        "mean": round(sum(s) / len(s), 1),
        "max": round(s[-1], 1),
    }


def _union(spans):
    """Total length of the union of (b, e) intervals."""
    total, cur_b, cur_e = 0.0, None, None
    for b, e in sorted(spans):
        if cur_b is None:
            cur_b, cur_e = b, e
        elif b <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_b
            cur_b, cur_e = b, e
    if cur_b is not None:
        total += cur_e - cur_b
    return total


def _overlap_len(b, e, spans):
    """Length of (b, e) covered by the union of `spans`."""
    covered, cur = 0.0, b
    for sb, se in sorted(spans):
        if se <= cur:
            continue
        if sb >= e:
            break
        covered += min(se, e) - max(sb, cur)
        cur = max(cur, min(se, e))
        if cur >= e:
            break
    return covered


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

class _Instance:
    """One lifecycle of one tensor on one rank (ENQUEUED → DONE)."""

    __slots__ = ("enq", "done", "exec_b", "exec_e", "neg_b", "neg_e",
                 "wire", "lane", "error")

    def __init__(self):
        self.enq = None
        self.done = None
        self.exec_b = None
        self.exec_e = None
        self.neg_b = None
        self.neg_e = None
        self.wire = []  # closed (b, e) wire-pump spans
        self.lane = 0
        self.error = False


def _walk_lane(events):
    """State-machine over one engine lane's time-ordered events →
    (instances, negotiations). A negotiation is (b, e, [(ts, rank)…]);
    it is also attached to the instance open at the time, when any.

    Finalization is lazy (next ENQUEUED or end of stream), NOT at DONE:
    the engine completes the entry from inside the response execution,
    so DONE lands *before* the EXEC_END event of the same instance.
    Unclosed spans (truncated shard, aborted gang) are dropped."""
    instances, negs = [], []
    cur = None
    open_neg = None   # [b, e, readies]
    wire_stack = []
    for ev in events:
        name = ev.get("name", "")
        ph = ev.get("ph")
        ts = ev.get("ts", 0)
        if ph == "i":
            if name == "ENQUEUED":
                if cur is not None and cur.enq is not None:
                    instances.append(cur)
                cur = _Instance()
                cur.enq = ts
                cur.lane = (ev.get("args") or {}).get("lane", 0)
            elif name in ("DONE", "ERROR"):
                if cur is not None:
                    cur.done = ts
                    cur.error = name == "ERROR"
            else:
                m = _READY_RE.match(name)
                if m and open_neg is not None:
                    open_neg[2].append((ts, int(m.group(1))))
        elif ph == "B":
            if name.startswith("NEGOTIATE_"):
                open_neg = [ts, None, []]
            elif name.startswith("WIRE_"):
                wire_stack.append(ts)
            elif name.startswith("EAGER_"):
                pass  # dispatch lanes are handled separately
            else:  # exec span (named after the op)
                if cur is None:
                    cur = _Instance()  # exec without a local ENQUEUED
                cur.exec_b = ts
                lane = (ev.get("args") or {}).get("lane")
                if lane is not None:
                    cur.lane = lane
        elif ph == "E":
            # close the span the end names (the port's coordinator names
            # them: a negotiation read after the next member already
            # posted ends after the last exec began); an unnamed end (the
            # engine's) closes the innermost open span: wire, then neg,
            # then exec
            if name and not name.startswith("NEGOTIATE_"):
                if cur is not None and cur.exec_b is not None \
                        and cur.exec_e is None:
                    cur.exec_e = ts
            elif wire_stack and not name:
                b = wire_stack.pop()
                if cur is not None:
                    cur.wire.append((b, ts))
            elif open_neg is not None and open_neg[1] is None:
                open_neg[1] = ts
                negs.append(tuple(open_neg))
                # attach to the live instance only — a negotiation seen
                # after this instance's DONE belongs to the next one
                if cur is not None and cur.neg_b is None \
                        and cur.done is None:
                    cur.neg_b, cur.neg_e = open_neg[0], ts
                open_neg = None
            elif cur is not None and cur.exec_b is not None \
                    and cur.exec_e is None:
                cur.exec_e = ts
    if cur is not None and (cur.enq is not None or
                            cur.done is not None):
        instances.append(cur)
    return instances, negs


def analyze(events):
    """Full report dict from a merged chrome-trace event list."""
    # lane names from metadata; lifecycle lanes end with a _LANE_SUFFIXES
    lane_name = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            lane_name[(ev.get("pid"), ev.get("tid"))] = \
                (ev.get("args") or {}).get("name", "")

    by_lane = {}
    ts_min, ts_max = None, None
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") == "M":
            continue
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            ts_min = ts if ts_min is None else min(ts_min, ts)
            ts_max = ts if ts_max is None else max(ts_max, ts)
        by_lane.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    wall_us = (ts_max - ts_min) if ts_min is not None else 0.0

    per_tensor = {}        # tensor -> {phase: [durations µs]}
    phase_all = {p: [] for p in PHASES}
    lane_exec = {}         # lane id -> [exec µs]
    negs_all = []          # (b, e, readies) across rank-0 lanes
    rank_windows = {}      # pid -> [(enq, done, key)]
    rank_exec = {}         # pid -> [(b, e, key)]
    cycles, ctrl_tx, ctrl_rx = [], 0, 0
    # per-role control-plane attribution (tree mode's leader hop shows
    # up here; bytes are counted once gang-wide, at the rank whose
    # sockets moved them — a leader's aggregate is never re-counted at
    # the members it batches)
    ctrl_by_role = {r: {"instants": 0, "tx_bytes": 0, "rx_bytes": 0}
                    for r in CTRL_ROLES}
    # self-healing link recovery (RECONNECT/REPLAY cycle-lane instants):
    # reconnect count, replay volume, and the stall time spent in
    # RECONNECTING — attributed per link plane
    recovery = {"reconnects": 0, "frames_replayed": 0,
                "replay_bytes": 0, "stall_us_total": 0.0,
                "by_plane": {}}
    reconnect_durs = []  # per-reconnect RECONNECTING time, µs
    ranks = set()

    for (pid, tid), evs in sorted(by_lane.items()):
        if pid is not None:
            ranks.add(pid)
        name = lane_name.get((pid, tid), "")
        evs.sort(key=lambda e: e.get("ts", 0))
        if name == "CYCLE":
            for ev in evs:
                nm = ev.get("name", "")
                if nm.startswith("RECONNECT(") or nm.startswith("REPLAY("):
                    args = ev.get("args") or {}
                    plane = args.get("plane", "?")
                    bp = recovery["by_plane"].setdefault(
                        plane, {"reconnects": 0, "replay_bytes": 0,
                                "stall_us": 0.0})
                    if nm.startswith("RECONNECT("):
                        recovery["reconnects"] += 1
                        dur = float(args.get("duration_us", 0))
                        recovery["stall_us_total"] += dur
                        reconnect_durs.append(dur)
                        bp["reconnects"] += 1
                        bp["stall_us"] += dur
                    else:
                        recovery["frames_replayed"] += int(
                            args.get("frames", 0))
                        recovery["replay_bytes"] += int(
                            args.get("bytes", 0))
                        bp["replay_bytes"] += int(args.get("bytes", 0))
                    continue
                m = _CYCLE_RE.match(nm)
                if m:
                    cycles.append(int(m.group(1)))
                    continue
                m = _CTRL_RE.match(ev.get("name", ""))
                if m:
                    tx, rx = int(m.group(1)), int(m.group(2))
                    ctrl_tx += tx
                    ctrl_rx += rx
                    role = (ev.get("args") or {}).get("role")
                    if role not in ctrl_by_role:
                        role = "member"  # pre-role shards: workers
                    ctrl_by_role[role]["instants"] += 1
                    ctrl_by_role[role]["tx_bytes"] += tx
                    ctrl_by_role[role]["rx_bytes"] += rx
            continue
        suffix = next((s for s in _LANE_SUFFIXES if name.endswith(s)), None)
        if suffix is None:
            continue  # eager dispatch lanes carry no phase data
        tensor = name[:-len(suffix)]
        instances, negs = _walk_lane(evs)
        negs_all.extend(negs)
        bucket = per_tensor.setdefault(tensor,
                                       {p: [] for p in PHASES})
        for k, inst in enumerate(instances):
            durs = {}
            if inst.enq is not None and inst.exec_b is not None:
                durs["queue"] = max(0.0, inst.exec_b - inst.enq)
            if inst.neg_b is not None and inst.neg_e is not None:
                durs["negotiate"] = max(0.0, inst.neg_e - inst.neg_b)
            if inst.exec_b is not None and inst.exec_e is not None:
                ex = max(0.0, inst.exec_e - inst.exec_b)
                durs["exec"] = ex
                lane_exec.setdefault(inst.lane, []).append(ex)
                rank_exec.setdefault(pid, []).append(
                    (inst.exec_b, inst.exec_e, (tensor, k)))
                if inst.wire:
                    w = sum(e - b for b, e in inst.wire)
                    durs["wire"] = max(0.0, w)
                    durs["reduce"] = max(0.0, ex - w)
            if inst.enq is not None and inst.done is not None:
                durs["e2e"] = max(0.0, inst.done - inst.enq)
                rank_windows.setdefault(pid, []).append(
                    (inst.enq, inst.done, (tensor, k)))
            for p, v in durs.items():
                bucket[p].append(v)
                phase_all[p].append(v)

    # ---- straggler ranking (cold negotiations on the coordinator) ----
    per_rank = {}
    scored = 0
    for b, e, readies in negs_all:
        if len(readies) < 2:
            continue
        scored += 1
        readies.sort()
        last_ts, last_rank = readies[-1]
        margin = last_ts - readies[-2][0]
        r = per_rank.setdefault(last_rank,
                                {"times_last": 0, "margins": []})
        r["times_last"] += 1
        r["margins"].append(margin)
    stragglers = []
    for rank, d in per_rank.items():
        stragglers.append({
            "rank": rank,
            "times_last": d["times_last"],
            "share": round(d["times_last"] / scored, 3) if scored else 0,
            "mean_margin_us": round(
                sum(d["margins"]) / len(d["margins"]), 1),
            "max_margin_us": round(max(d["margins"]), 1),
        })
    stragglers.sort(key=lambda s: (-s["times_last"],
                                   -s["mean_margin_us"]))

    # ---- compute/comm overlap: exec time covered by OTHER in-flight
    # collectives of the same rank ----
    overlap = {}
    for pid, execs in rank_exec.items():
        wins = rank_windows.get(pid, [])
        covered = total = 0.0
        for b, e, key in execs:
            others = [(wb, we) for wb, we, wk in wins if wk != key]
            total += e - b
            covered += _overlap_len(b, e, others)
        if total > 0:
            overlap[str(pid)] = round(covered / total, 3)

    # ---- assemble ----
    report = {
        "schema": SCHEMA,
        "ranks": sorted(ranks),
        "wall_us": round(wall_us, 1),
        "instances": sum(len(v) for v in rank_windows.values()),
        "phases": {p: _stats(v) for p, v in phase_all.items()
                   if _stats(v)},
        "per_tensor": {
            t: {p: _stats(v) for p, v in d.items() if _stats(v)}
            for t, d in sorted(per_tensor.items())},
        "stragglers": stragglers,
        "negotiations_scored": scored,
        "lanes": {str(lane): _stats(v)
                  for lane, v in sorted(lane_exec.items())},
        "overlap_efficiency": overlap,
        "cycles": {
            "count": len(cycles),
            "mean_responses": (round(sum(cycles) / len(cycles), 2)
                               if cycles else 0),
            "ctrl_tx_bytes": ctrl_tx,
            "ctrl_rx_bytes": ctrl_rx,
            # per-role attribution: the tree's leader hop vs the root's
            # fan-in/out vs member announces, each counted exactly once
            "ctrl_by_role": {r: d for r, d in ctrl_by_role.items()
                             if d["instants"]},
        },
        # self-healing links: 0s everywhere on a clean run; reconnects
        # with zero aborts = a flaky fabric being absorbed; stall_us is
        # the wall time spent in RECONNECTING across the gang
        "recovery": recovery,
    }
    if reconnect_durs:
        recovery["stall_us"] = _stats(reconnect_durs)
    metrics = {}
    for p, st in report["phases"].items():
        metrics[f"{p}_us_p50"] = st["p50"]
    for lane, st in report["lanes"].items():
        metrics[f"lane{lane}_exec_us_p50"] = st["p50"]
    # recovery p50s gate too: a chaos/soak baseline
    # carrying these keys fails --diff if a later change silently stops
    # recording RECONNECT/REPLAY events — the MISSING-gated-key rule
    # catches the vanished section instead of the key intersection
    # quietly shrinking past it
    if reconnect_durs:
        metrics["recovery_stall_us_p50"] = recovery["stall_us"]["p50"]
    report["metrics"] = metrics
    return report


def analyze_paths(paths):
    return analyze(load_events(paths))


# ---------------------------------------------------------------------------
# human report
# ---------------------------------------------------------------------------

def print_report(rep, out=None):
    w = (out or sys.stdout).write
    w(f"hvt-analyze: ranks {rep['ranks']}, {rep['instances']} tensor "
      f"instances, wall {rep['wall_us'] / 1e6:.3f} s\n")
    if rep["phases"]:
        w("\nphase breakdown (µs):\n")
        w(f"  {'phase':<10}{'count':>7}{'p50':>12}{'p90':>12}"
          f"{'p99':>12}{'mean':>12}{'max':>12}\n")
        for p in PHASES:
            st = rep["phases"].get(p)
            if not st:
                continue
            w(f"  {p:<10}{st['count']:>7}{st['p50']:>12}{st['p90']:>12}"
              f"{st['p99']:>12}{st['mean']:>12}{st['max']:>12}\n")
    if rep["stragglers"]:
        w(f"\nstraggler ranking ({rep['negotiations_scored']} "
          f"negotiations scored):\n")
        w(f"  {'rank':<6}{'last':>6}{'share':>8}{'mean margin µs':>16}"
          f"{'max margin µs':>15}\n")
        for s in rep["stragglers"]:
            w(f"  {s['rank']:<6}{s['times_last']:>6}"
              f"{s['share'] * 100:>7.1f}%{s['mean_margin_us']:>16}"
              f"{s['max_margin_us']:>15}\n")
    if rep["lanes"]:
        w("\nper-lane exec percentiles (µs; lane 0 = global set):\n")
        for lane, st in rep["lanes"].items():
            w(f"  lane {lane}: n={st['count']} p50={st['p50']} "
              f"p90={st['p90']} p99={st['p99']}\n")
    if rep["overlap_efficiency"]:
        pairs = ", ".join(f"rank {r}: {v}" for r, v in
                          sorted(rep["overlap_efficiency"].items()))
        w(f"\ncompute/comm overlap efficiency: {pairs}\n")
    rec = rep.get("recovery") or {}
    if rec.get("reconnects"):
        st = rec.get("stall_us") or {}
        per = (f" (p50 {st['p50']} µs/reconnect)" if st else "")
        w(f"\nrecovery: {rec['reconnects']} link reconnects, "
          f"{rec['frames_replayed']} frames / {rec['replay_bytes']} B "
          f"replayed, {rec['stall_us_total'] / 1e3:.1f} ms in "
          f"RECONNECTING{per}\n")
        for plane, d in sorted(rec.get("by_plane", {}).items()):
            w(f"  {plane}: {d['reconnects']} reconnects, "
              f"{d['replay_bytes']} B replayed, "
              f"{d['stall_us'] / 1e3:.1f} ms stalled\n")
    cy = rep["cycles"]
    if cy["count"] or cy["ctrl_tx_bytes"]:
        w(f"\ncycles: {cy['count']} with responses, mean "
          f"{cy['mean_responses']} responses/cycle; control plane "
          f"tx={cy['ctrl_tx_bytes']} B rx={cy['ctrl_rx_bytes']} B\n")
        for role, d in cy.get("ctrl_by_role", {}).items():
            w(f"  ctrl[{role}]: {d['instants']} working cycles, "
              f"tx={d['tx_bytes']} B rx={d['rx_bytes']} B\n")


# ---------------------------------------------------------------------------
# diff / perf gate
# ---------------------------------------------------------------------------

def _gate_value_us(key, val):
    """Normalize a metric to µs for the --min-base-us floor."""
    if key.endswith("_ms"):
        return float(val) * 1e3
    return float(val)


def diff_metrics(base, cur, max_ratio=2.0, min_base_us=200.0):
    """Compare two ``metrics`` dicts; returns (regressions, improved,
    skipped, missing) — (key, base, cur, ratio) rows plus the gated
    baseline keys absent from the current report. Only p50 keys gate —
    ratio-based bands generous enough for CI noise, per the perf-gate
    contract (fail only on >max_ratio p50 regressions). A MISSING gated
    key also fails: a regression severe enough to make a whole phase
    vanish (e.g. wire spans no longer recorded) must not pass the gate
    by shrinking the intersection."""
    regressions, improved, skipped, missing = [], [], [], []
    for key in sorted(base):
        if "p50" not in key:
            continue
        b = base[key]
        if not isinstance(b, (int, float)) or b <= 0:
            continue
        gated = _gate_value_us(key, b) >= min_base_us
        if key not in cur:
            if gated:
                missing.append(key)
            continue
        c = cur[key]
        if not isinstance(c, (int, float)):
            missing.append(key)
            continue
        if not gated:
            skipped.append((key, b, c, 0.0))
            continue
        ratio = c / b
        row = (key, b, c, round(ratio, 3))
        if ratio > max_ratio:
            regressions.append(row)
        elif ratio < 1.0 / max_ratio:
            improved.append(row)
    return regressions, improved, skipped, missing


def run_diff(base_path, cur_path, max_ratio, min_base_us,
             out=None) -> int:
    with open(base_path) as f:
        base = json.load(f)
    with open(cur_path) as f:
        cur = json.load(f)
    bm, cm = base.get("metrics", {}), cur.get("metrics", {})
    regs, improved, skipped, missing = diff_metrics(bm, cm, max_ratio,
                                                    min_base_us)
    w = (out or sys.stdout).write
    w(f"hvt-analyze diff: {base_path} -> {cur_path} "
      f"(band: p50 ratio <= {max_ratio}x, floor {min_base_us} µs)\n")
    for key, b, c, r in improved:
        w(f"  improved   {key}: {b} -> {c} ({r}x)\n")
    for key, b, c, _ in skipped:
        w(f"  skipped    {key}: baseline below floor ({b})\n")
    for key in missing:
        w(f"  MISSING    {key}: gated in the baseline but absent from "
          f"the current report (measurement broke?)\n")
    if regs or missing:
        for key, b, c, r in regs:
            w(f"  REGRESSION {key}: {b} -> {c} ({r}x > {max_ratio}x)\n")
        w(f"hvt-analyze diff: FAILED — {len(regs)} p50 regression(s), "
          f"{len(missing)} missing metric(s)\n")
        return 1
    ngate = sum(1 for k in bm if k in cm and "p50" in k) - len(skipped)
    w(f"hvt-analyze diff: OK ({ngate} metric(s) within band)\n")
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.hvt_analyze",
        description="critical-path analyzer for flight-recorder "
                    "timelines: phase breakdown, straggler ranking, "
                    "per-lane percentiles, perf-gate diff")
    ap.add_argument("traces", nargs="*",
                    help="merged timeline, or N raw per-rank shards "
                         "(truncation-damaged shards are tolerated)")
    ap.add_argument("-o", "--output",
                    help="write the JSON report here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human summary")
    ap.add_argument("--diff", nargs=2, metavar=("BASE", "CURRENT"),
                    help="compare two report JSONs ('metrics' blocks) "
                         "instead of analyzing traces; exit 1 on a "
                         "p50 regression beyond --max-ratio")
    ap.add_argument("--max-ratio", type=float,
                    default=float(os.environ.get(
                        "HVT_PERFGATE_MAX_RATIO", "2.0")),
                    help="regression band for --diff (default 2.0, or "
                         "HVT_PERFGATE_MAX_RATIO)")
    ap.add_argument("--min-base-us", type=float, default=200.0,
                    help="ignore metrics whose baseline is below this "
                         "many µs (scheduler noise floor)")
    args = ap.parse_args(argv)

    if args.diff:
        if args.traces:
            ap.error("--diff takes exactly two report files and no "
                     "trace arguments")
        return run_diff(args.diff[0], args.diff[1], args.max_ratio,
                        args.min_base_us)

    if not args.traces:
        ap.error("give at least one trace/shard file (or --diff)")
    try:
        rep = analyze_paths(args.traces)
    except OSError as e:
        print(f"hvt-analyze: cannot read trace: {e}", file=sys.stderr)
        return 2
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
    if not args.quiet:
        print_report(rep)
        if args.output:
            print(f"\nreport written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
