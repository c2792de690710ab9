"""Serving load generator: replay mixed open-loop traffic against a
:class:`~horovod_tpu_torch.serving.ReplicaGang` and record p50, p99 and
throughput to a JSON artifact (the JAX package's ``serving/loadgen.py``).

Run one generator per rank under the port's launcher::

    python -m horovod_tpu_torch.runner.launch -np 4 \\
        python -m horovod_tpu_torch.serving.loadgen \\
        --replicas 2 --requests 120 --bytes 16384 --output out.json

Traffic model: requests arrive in deterministic **bursts** (submit the burst
back to back, then reap the window down to its low watermark), so shed
decisions stay a pure function of the request index on every replica member
(``replica_gang.py`` says why timing-based shedding would wedge a lane).
Pacing sleeps between bursts shape the open-loop rate without entering any
decision. ``--saturate-replica N`` multiplies one replica's burst by
``--saturate-factor`` and drops its pacing gap: the contended half of the
lane-isolation experiment.

The phases (``--phases baseline,contended``) run back to back inside one
launch; the artifact's ``isolation`` block compares an idle replica's p99
across them.

Each request's payload is a float32 tensor on this rank's device
(``hvt.device()``), drawn once from ``default_rng(seed)`` as the JAX
loadgen draws it, plus the request's index ``k``, added on the device. An
admitted request's result is then ``len(members) * (payload + k)``, exact
for lanes of one or two ranks (a sum of two equal fp32 values is exact).
After each phase, outside the timed reaps, every result is checked
against it: each rank's snapshot carries ``checked``, ``wrong`` and
``max_abs_err``, and ``decisions_sha256``, a hash of its decision log,
which every member of a replica must share. ``main`` exits 1 when a result
is wrong.

``--check FILE`` validates an artifact against the schema (exit 0/1)
without starting anything; ``--smoke`` shrinks everything;
``--partition 0,2/1,3`` gives the replicas' ranks explicitly;
``--device cpu`` runs the gang on gloo.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

SCHEMA_NAME = "hvt-serving-loadtest"
SCHEMA_VERSION = 1

_RANK_KEYS = ("rank", "replica", "admitted", "shed", "completed",
              "deadline_miss", "p50_ms", "p99_ms", "throughput_rps")
_REPLICA_KEYS = ("ranks", "admitted", "shed", "completed",
                 "deadline_miss", "p50_ms", "p99_ms", "throughput_rps")


def validate_artifact(doc: dict) -> list:
    """Schema check for the loadtest artifact; returns a list of violations
    (empty = valid). Used by ``--check``."""
    errs = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    need(isinstance(doc, dict), "artifact is not a JSON object")
    if not isinstance(doc, dict):
        return errs
    need(doc.get("schema") == SCHEMA_NAME,
         f"schema must be {SCHEMA_NAME!r}, got {doc.get('schema')!r}")
    need(doc.get("version") == SCHEMA_VERSION,
         f"version must be {SCHEMA_VERSION}, got {doc.get('version')!r}")
    need(isinstance(doc.get("config"), dict), "config block missing")
    phases = doc.get("phases")
    need(isinstance(phases, dict) and phases, "phases block missing/empty")
    for pname, phase in (phases or {}).items():
        if not isinstance(phase, dict):
            errs.append(f"phase {pname!r} is not an object")
            continue
        ranks = phase.get("ranks")
        if not isinstance(ranks, list) or not ranks:
            errs.append(f"phase {pname!r}: ranks list missing/empty")
        else:
            for i, snap in enumerate(ranks):
                for k in _RANK_KEYS:
                    if k not in snap:
                        errs.append(
                            f"phase {pname!r} rank[{i}]: missing {k!r}")
        reps = phase.get("replicas")
        if not isinstance(reps, dict) or not reps:
            errs.append(f"phase {pname!r}: replicas block missing/empty")
        else:
            for rid, agg in reps.items():
                for k in _REPLICA_KEYS:
                    if k not in agg:
                        errs.append(
                            f"phase {pname!r} replica {rid}: missing {k!r}")
    iso = doc.get("isolation")
    if iso is not None:
        for k in ("observed_replica", "idle_p99_ms", "contended_p99_ms",
                  "ratio"):
            if k not in iso:
                errs.append(f"isolation block: missing {k!r}")
    return errs


def _aggregate_replica(snaps: list) -> dict:
    """Fold member-rank snapshots into one replica row (p99 = max over
    members: the conservative tenant-facing number)."""
    return {
        "ranks": sorted(s["rank"] for s in snaps),
        "admitted": sum(s["admitted"] for s in snaps),
        "shed": sum(s["shed"] for s in snaps),
        "completed": sum(s["completed"] for s in snaps),
        "deadline_miss": sum(s["deadline_miss"] for s in snaps),
        "p50_ms": round(float(np.median([s["p50_ms"] for s in snaps])), 4),
        "p99_ms": round(max(s["p99_ms"] for s in snaps), 4),
        "throughput_rps": round(sum(s["throughput_rps"] for s in snaps), 3),
    }


def decisions_digest(decisions) -> str:
    """A hash of a gang's decision log: equal on every member of a
    replica."""
    return hashlib.sha256(repr(decisions).encode()).hexdigest()


def check_results(results, admitted, payload, members: int) -> dict:
    """Hold the reaped ``results`` (in reap order: one tensor, or a batch's
    list of tensors) against ``members * (payload + k)`` for the
    ``admitted`` request indices ``k``: exact for ``members`` of one or
    two, within ``members`` fp32 epsilons otherwise."""
    import torch

    flat = []
    for out in results:
        flat.extend(out if isinstance(out, (list, tuple)) else [out])
    if len(flat) != len(admitted):
        return {"checked": len(flat), "wrong": max(len(flat),
                                                   len(admitted)),
                "max_abs_err": float("inf")}
    if not flat:
        return {"checked": 0, "wrong": 0, "max_abs_err": 0.0}
    got = torch.stack([o.reshape(-1) for o in flat])
    ks = torch.tensor(admitted, dtype=torch.float32, device=payload.device)
    want = (payload[None, :] + ks[:, None]) * members
    err = (got - want).abs()
    tol = 0.0 if members <= 2 else \
        members * torch.finfo(torch.float32).eps * want.abs()
    wrong = int((err > tol).any(dim=1).sum())
    return {"checked": len(flat), "wrong": wrong,
            "max_abs_err": float(err.max())}


def run_phase(gang, *, requests: int, payload_bytes: int, burst: int,
              gap_ms: float, sync_every: int, saturated: bool,
              saturate_factor: int, seed: int = 0):
    """Drive one traffic phase against ``gang`` from this rank; returns its
    snapshot with the results' check and the decision log's hash.

    Deterministic by construction: the submit/reap/sync sequence depends
    only on the request index, never on local timing, so every member of a
    replica plays the identical collective program.
    """
    import torch

    import horovod_tpu_torch as hvt

    device = hvt.device()
    rng = np.random.default_rng(seed)
    payload = torch.from_numpy(rng.standard_normal(
        max(payload_bytes // 4, 1)).astype(np.float32)).to(device)
    refresh = torch.ones(8, device=device)
    my_burst = burst * (saturate_factor if saturated else 1)
    # low watermark: leave headroom for the next burst, so a burst that
    # fits the window never sheds; only bursts larger than the whole
    # window (a genuine overload) shed their excess (deterministically)
    watermark = max(0, gang.max_backlog - min(my_burst, gang.max_backlog))
    admitted, results = [], []
    k = 0
    while k < requests:
        for _ in range(min(my_burst, requests - k)):
            if gang.submit_request(payload + k) is not None:
                admitted.append(k)
            k += 1
            if sync_every and k % sync_every == 0:
                gang.sync(refresh)
        while gang.backlog() > watermark:
            results.append(gang.reap())
        if gap_ms > 0 and not saturated:
            time.sleep(gap_ms / 1e3)
    # drain(), keeping the results
    gang.flush()
    while gang.backlog():
        results.append(gang.reap())
    gang.push_stats()
    # phase boundary: nobody starts the next phase's gang while a peer is
    # still reaping this one
    hvt.barrier()
    snap = gang.snapshot()
    snap.update(check_results(results, admitted, payload,
                              len(gang.my_members)))
    snap["decisions_sha256"] = decisions_digest(gang.decisions)
    return snap


def build_artifact(config: dict, phase_snaps: dict) -> dict:
    phases = {}
    for pname, snaps in phase_snaps.items():
        by_rep = {}
        for s in snaps:
            by_rep.setdefault(s["replica"], []).append(s)
        phases[pname] = {
            "ranks": sorted(snaps, key=lambda s: s["rank"]),
            "replicas": {str(rid): _aggregate_replica(group)
                         for rid, group in sorted(by_rep.items())},
        }
    doc = {
        "schema": SCHEMA_NAME,
        "version": SCHEMA_VERSION,
        "harness": "r07",
        "created_unix": int(time.time()),
        "config": config,
        "phases": phases,
    }
    # lane isolation: the idle replica observed across both phases
    sat = config.get("saturate_replica")
    if {"baseline", "contended"} <= set(phases) and sat is not None:
        observed = next(
            (int(rid) for rid in phases["contended"]["replicas"]
             if int(rid) != sat), None)
        if observed is not None:
            idle = phases["baseline"]["replicas"][str(observed)]["p99_ms"]
            busy = phases["contended"]["replicas"][str(observed)]["p99_ms"]
            doc["isolation"] = {
                "observed_replica": observed,
                "saturated_replica": sat,
                "idle_p99_ms": idle,
                "contended_p99_ms": busy,
                "ratio": round(busy / idle, 4) if idle > 0 else 0.0,
            }
    return doc


def parse_partition(spec):
    """``"0,2/1,3"`` -> ``[[0, 2], [1, 3]]``; None or empty -> None."""
    if not spec:
        return None
    return [[int(x) for x in group.split(",")] for group in spec.split("/")]


def run_loadtest(args) -> dict:
    """Worker entry: drive every phase, gather snapshots, and (on rank 0)
    return the artifact dict (other ranks return None)."""
    import os

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops.functions import allgather_object
    from horovod_tpu_torch.serving import ReplicaGang

    hvt.init(device=getattr(args, "device", None))
    partition = parse_partition(getattr(args, "partition", None))
    if args.warmup > 0:
        # a throwaway pass: first-touch costs (allocator growth, and each
        # lane's NCCL communicator, made at its first collective: the sync
        # lane's too, so the pass ends with one sync) must not land in the
        # phases
        warm = ReplicaGang(args.replicas, admission_timeout=5.0,
                           max_backlog=args.window, name="lg.warm",
                           partition=partition)
        run_phase(warm, requests=args.warmup, payload_bytes=args.bytes,
                  burst=1, gap_ms=0, sync_every=args.warmup,
                  saturated=False, saturate_factor=1)
    phase_names = [p.strip() for p in args.phases.split(",") if p.strip()]
    phase_snaps = {}
    for pname in phase_names:
        gang = ReplicaGang(args.replicas,
                           admission_timeout=args.admission_ms / 1e3,
                           max_backlog=args.window,
                           name=f"lg.{pname}", partition=partition)
        saturated = (pname == "contended"
                     and gang.replica_id == args.saturate_replica)
        snap = run_phase(
            gang, requests=args.requests, payload_bytes=args.bytes,
            burst=args.burst, gap_ms=args.gap_ms,
            sync_every=args.sync_every, saturated=saturated,
            saturate_factor=args.saturate_factor)
        phase_snaps[pname] = allgather_object(
            snap, name=f"lg.gather.{pname}")
    if hvt.rank() != 0:
        return None
    config = {
        "world": hvt.size(), "replicas": args.replicas,
        "requests": args.requests, "bytes": args.bytes,
        "burst": args.burst, "window": args.window,
        "admission_ms": args.admission_ms, "gap_ms": args.gap_ms,
        "sync_every": args.sync_every,
        "saturate_replica": args.saturate_replica,
        "saturate_factor": args.saturate_factor,
        "phases": phase_names, "partition": partition,
        "device": str(hvt.device()),
        "serving_batch": int(os.environ.get("HVT_SERVING_BATCH", "1")),
    }
    return build_artifact(config, phase_snaps)


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving.loadgen",
        description="serving-gang load generator (run under "
                    "python -m horovod_tpu_torch.runner.launch)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=120,
                    help="requests per rank per phase")
    ap.add_argument("--bytes", type=int, default=16384,
                    help="payload bytes per request")
    ap.add_argument("--burst", type=int, default=2,
                    help="baseline burst size (requests submitted "
                         "back-to-back before reaping)")
    ap.add_argument("--window", type=int, default=8,
                    help="in-flight window per replica member")
    ap.add_argument("--admission-ms", type=float, default=250.0)
    ap.add_argument("--gap-ms", type=float, default=2.0,
                    help="open-loop pacing gap between bursts")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="cross-replica sync every N requests (0 = off)")
    ap.add_argument("--phases", default="baseline,contended")
    ap.add_argument("--warmup", type=int, default=16,
                    help="throwaway warmup requests before the phases")
    ap.add_argument("--saturate-replica", type=int, default=0)
    ap.add_argument("--saturate-factor", type=int, default=8)
    ap.add_argument("--partition", default=None,
                    help="the replicas' ranks, e.g. 0,2/1,3 (default: "
                         "contiguous)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (gloo)")
    ap.add_argument("--output", default=None,
                    help="artifact path (rank 0 writes it)")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny preset")
    ap.add_argument("--check", metavar="FILE", default=None,
                    help="validate an artifact against the schema and "
                         "exit")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.check:
        with open(args.check) as f:
            doc = json.load(f)
        errs = validate_artifact(doc)
        for e in errs:
            print(f"loadgen: schema violation: {e}", file=sys.stderr)
        print(f"loadgen: {args.check}: "
              + ("OK" if not errs else f"{len(errs)} violation(s)"))
        return 1 if errs else 0
    if args.smoke:
        args.requests = min(args.requests, 24)
        args.bytes = min(args.bytes, 4096)
        args.saturate_factor = min(args.saturate_factor, 4)
        args.gap_ms = 0.5
    doc = run_loadtest(args)
    import horovod_tpu_torch as hvt

    rc = 0
    if doc is not None:
        out = json.dumps(doc, indent=1, sort_keys=True)
        if args.output:
            with open(args.output, "w") as f:
                f.write(out + "\n")
            print(f"loadgen: wrote {args.output}")
        else:
            print(out)
        if "isolation" in doc:
            iso = doc["isolation"]
            print(f"loadgen: replica {iso['observed_replica']} p99 "
                  f"{iso['idle_p99_ms']:.3f} ms idle -> "
                  f"{iso['contended_p99_ms']:.3f} ms contended "
                  f"(ratio {iso['ratio']:.2f})")
        wrong = sum(s.get("wrong", 0) for p in doc["phases"].values()
                    for s in p["ranks"])
        if wrong:
            print(f"loadgen: {wrong} result(s) wrong", file=sys.stderr)
            rc = 1
    hvt.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
