"""The telemetry push loop's cost on the launched main path, on one GPU.

``python tools/push_cost_probe.py [--rounds 3] [--steps 200] [--out DIR]``

The port's launcher runs ``-np 1 --timeline`` of the main path (the bench
GPT through ``train.train``, ``tests/torch_port_launch_worker.py fleet``),
so every worker has the launcher's KV server and starts the push loop at
``hvt.init``. Four variants run in turns, ``rounds`` times (in the order
below, then backwards, and so on):

- ``off``: ``HVT_DEBUGZ_INTERVAL_MS=1e9``: the loop pushes once at
  ``hvt.init`` and then sleeps through the run;
- ``5000``: the default interval;
- ``200``: the interval the fleet phase of ``chip_smoke.py`` uses;
- ``200_leader``: that interval under ``HVT_TELEMETRY_AGG=1``, as the
  fleet phase runs it: the worker is its host's leader and serves the
  host's pushes itself.

The first three push directly to the server (``HVT_TELEMETRY_AGG``
unset), as every elastic worker and every ``--timeline`` job does by
default. The worker
reads ``/statusz`` and ``/debugz`` and builds and PUTs one snapshot only
after its last step, which the statistics leave out: that read gives the
host ms of one push's work (building the snapshot, and the PUT).

Prints one JSON line a run and a summary line last: for each variant the
mean and the median step ms of each run (steps after the first two), and
the difference of each variant's mean of run means from ``off``'s beside
the spread of ``off``'s run means. Needs CUDA.
"""

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WARMUP = 2
# variant -> (HVT_DEBUGZ_INTERVAL_MS, HVT_TELEMETRY_AGG or None)
VARIANTS = {"off": ("1000000000", None), "5000": ("5000", None),
            "200": ("200", None), "200_leader": ("200", "1")}


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(variant, steps, batch, seq, out_dir):
    """One launched job under ``variant``: its step ms (the first two and
    the last left out) and the host ms of one push's work."""
    import torch

    d = tempfile.mkdtemp(prefix=f"push_{variant}_", dir=out_dir)
    out = os.path.join(d, "res")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "1", "--master-port", str(_free_port()), "--timeline",
           os.path.join(d, "timeline.json"), sys.executable,
           os.path.join(REPO, "tests", "torch_port_launch_worker.py"),
           "fleet", out, json.dumps({
               "device": "cuda", "config": "bench", "steps": steps,
               "poll_from": steps, "batch": batch, "seq": seq})]
    env = {k: v for k, v in os.environ.items()
           if k not in ("HVT_TELEMETRY_AGG",)}
    interval, agg = VARIANTS[variant]
    env.update(PYTHONPATH=REPO, HVT_DEBUGZ_INTERVAL_MS=interval)
    if agg:
        env["HVT_TELEMETRY_AGG"] = agg
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=env)
    if proc.returncode != 0:
        raise SystemExit(f"{variant}: the launcher exited "
                         f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    res = torch.load(out + ".0.pt", weights_only=False)
    shutil.rmtree(d, ignore_errors=True)
    ms = [s * 1e3 for s in res["step_s"][WARMUP:-1]]
    return {"variant": variant,
            "HVT_DEBUGZ_INTERVAL_MS": interval, "HVT_TELEMETRY_AGG": agg,
            "seconds": time.perf_counter() - t0, "steps_timed": len(ms),
            "step_ms_mean": statistics.fmean(ms),
            "step_ms_median": statistics.median(ms),
            "step_ms_max": max(ms),
            "snapshot_build_host_ms": res["snapshot_ms"],
            "push_put_host_ms": res["put_ms"],
            "snapshot_bytes": res["snapshot_bytes"],
            "losses_first_last": [res["losses"][0], res["losses"][-1]]}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "push_cost_probe"))
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, REPO)
    from horovod_tpu_torch.ops import _kernels as K

    K.build()       # the workers reuse the built libraries
    os.makedirs(a.out, exist_ok=True)
    smi = _smi()
    order = list(VARIANTS)
    runs = []
    for i in range(a.rounds):
        for variant in (order if i % 2 == 0 else order[::-1]):
            row = _run(variant, a.steps, a.batch, a.seq, a.out)
            row["nvidia_smi"] = smi
            print(json.dumps(row), flush=True)
            runs.append(row)
    means = {v: [r["step_ms_mean"] for r in runs if r["variant"] == v]
             for v in order}
    medians = {v: [r["step_ms_median"] for r in runs if r["variant"] == v]
               for v in order}
    off = statistics.fmean(means["off"])
    summary = {
        "summary": "push_cost_probe", "nvidia_smi": smi,
        "steps": a.steps, "rounds": a.rounds,
        "step_ms_mean_of_runs": means, "step_ms_median_of_runs": medians,
        "mean_minus_off_ms": {v: statistics.fmean(means[v]) - off
                              for v in order},
        "off_run_means_spread_ms": max(means["off"]) - min(means["off"]),
        "snapshot_build_host_ms": [r["snapshot_build_host_ms"]
                                   for r in runs],
        "push_put_host_ms": [r["push_put_host_ms"] for r in runs]}
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump({"runs": runs, **summary}, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
