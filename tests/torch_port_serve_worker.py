"""Jobs of the port's serving gang (``horovod_tpu_torch.serving``), shared
by tests/test_torch_port_serving.py (a 4-process gloo gang) and
tests/test_torch_port_cuda.py (SERVE4, four cards). Imports no JAX.

    python tests/torch_port_serve_worker.py gang OUT JSON_ARGV

runs, under the port's launcher, ``loadgen.run_loadtest`` on the loadgen
arguments ``JSON_ARGV`` and writes ``OUT.<rank>.json``: the rank, the ranks
of every process set registered in its world (in id order), and on rank 0
the artifact.

    python tests/torch_port_serve_worker.py fake-hosts L CMD...

re-labels the launched slot as one of hosts of ``L`` slots (``HVT_LOCAL_*``
and ``HVT_CROSS_*``; ``CUDA_VISIBLE_DEVICES``: its host's cards, so local
rank i drives its own card) and execs ``CMD``.

:class:`ServeLaunch` starts the gang job; :func:`run_serve4` runs SERVE4's
six launches of ``python -m horovod_tpu_torch.serving.loadgen``;
:func:`problems` lists what is wrong with an artifact.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# tests/test_serving.py:968's loadgen config (4 ranks, 2 replicas)
GANG_ARGV = ["--replicas", "2", "--requests", "18", "--bytes", "2048",
             "--burst", "6", "--window", "4", "--admission-ms", "500",
             "--gap-ms", "0.5", "--sync-every", "6",
             "--saturate-factor", "2"]
# r07's traffic (benchmarks/r07_serving_loadtest.json's config)
R07_ARGV = ["--replicas", "2", "--requests", "800", "--bytes", "8192",
            "--burst", "2", "--window", "4", "--admission-ms", "250",
            "--gap-ms", "0", "--sync-every", "50", "--saturate-replica", "0",
            "--saturate-factor", "2", "--phases", "contended,baseline"]
# SERVE4's launches: (name, extra loadgen arguments, extra env). no_poll
# has a zero admission budget, so every reap waits without the 1 ms
# deadline poll (each request then counts as a deadline miss); it runs in
# turns with the unbatched run, twice each, so that the poll's effect can
# be set against the spread of one setting's launches
NO_POLL = ["--admission-ms", "0"]
SERVE4_RUNS = (("unbatched", [], {}), ("no_poll", NO_POLL, {}),
               ("batch4", [], {"HVT_SERVING_BATCH": "4"}),
               ("columns", ["--partition", "0,2/1,3"], {}),
               ("no_poll.2", NO_POLL, {}), ("unbatched.2", [], {}))
FAKE_LOCAL_SIZE = 2


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang(out, argv):
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.serving import loadgen

    args = loadgen._parser().parse_args(argv)
    doc = loadgen.run_loadtest(args)
    sets = [ps.ranks for _, ps in sorted(basics._world().process_sets
                                         .items())]
    res = {"rank": basics.rank(), "size": basics.size(), "sets": sets,
           "artifact": doc}
    basics.shutdown()
    with open(f"{out}.{res['rank']}.json", "w") as f:
        json.dump(res, f)


def fake_hosts(local_size, cmd):
    r = int(os.environ["HVT_PROCESS_ID"])
    n = int(os.environ["HVT_NUM_PROCESSES"])
    host = r // local_size
    cards = os.environ.get("CUDA_VISIBLE_DEVICES",
                           ",".join(map(str, range(n)))).split(",")
    os.environ.update(
        HVT_LOCAL_PROCESS_ID=str(r % local_size),
        HVT_LOCAL_SIZE=str(local_size), HVT_CROSS_RANK=str(host),
        HVT_CROSS_SIZE=str(n // local_size),
        CUDA_VISIBLE_DEVICES=",".join(
            cards[host * local_size:(host + 1) * local_size]))
    os.execvp(cmd[0], cmd)


class ServeLaunch:
    """``python -m horovod_tpu_torch.runner.launch -np n python <this file>
    gang out argv``, started at construction; the launcher's output goes to
    ``out.log``."""

    def __init__(self, n, out, argv, timeout=240, env=None):
        self.n, self.out, self.timeout = n, out, timeout
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(n), "--master-port", str(free_port()),
               sys.executable, os.path.abspath(__file__), "gang", out,
               json.dumps(argv)]
        env = dict(os.environ if env is None else env, PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        self.log = out + ".log"
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                         stderr=subprocess.STDOUT)
        self._results = None

    def results(self):
        """Each rank's results; raises with the output's end if the job
        failed."""
        if self._results is None:
            try:
                self.proc.wait(timeout=self.timeout)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.wait()
            with open(self.log) as f:
                log = f.read()
            assert self.proc.returncode == 0, log[-20000:]
            self._results = []
            for r in range(self.n):
                with open(f"{self.out}.{r}.json") as f:
                    self._results.append(json.load(f))
        return self._results


def problems(doc, members=None):
    """What is wrong with a loadgen artifact: schema violations; a replica
    whose members differ in admitted or shed counts or in decision log; a
    result not exact, or not checked; the ranks of a replica other than
    ``members`` (a list per replica) when given."""
    from horovod_tpu_torch.serving import loadgen

    out = list(loadgen.validate_artifact(doc))
    for pname, phase in doc.get("phases", {}).items():
        by_rep = {}
        for s in phase["ranks"]:
            by_rep.setdefault(s["replica"], []).append(s)
            if s.get("wrong") != 0 or s.get("checked") != s["admitted"]:
                out.append(f"{pname}: rank {s['rank']} checked "
                           f"{s.get('checked')} of {s['admitted']} "
                           f"admitted, {s.get('wrong')} wrong")
        for rep, snaps in by_rep.items():
            states = {(s["admitted"], s["shed"], s["decisions_sha256"])
                      for s in snaps}
            if len(states) != 1:
                out.append(f"{pname}: replica {rep} members disagree: "
                           f"{states}")
            if members is not None and sorted(
                    s["rank"] for s in snaps) != sorted(members[rep]):
                out.append(f"{pname}: replica {rep} ranks "
                           f"{[s['rank'] for s in snaps]}")
    return out


def run_serve4(out_dir, device="cuda", n=4, argv=R07_ARGV, timeout=600):
    """SERVE4: ``python -m horovod_tpu_torch.serving.loadgen`` under the
    port's launcher ``-np n``, each slot on fake hosts of
    ``FAKE_LOCAL_SIZE``, once per :data:`SERVE4_RUNS` entry. Returns
    {name: (artifact, seconds of the launch)}."""
    import time

    out = {}
    for name, extra, env_extra in SERVE4_RUNS:
        path = os.path.join(out_dir, f"serve4_{name}.json")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(n), "--master-port", str(free_port()),
               sys.executable, os.path.abspath(__file__), "fake-hosts",
               str(FAKE_LOCAL_SIZE), sys.executable, "-m",
               "horovod_tpu_torch.serving.loadgen", *argv, *extra,
               "--device", device, "--output", path]
        env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
        env.pop("HVT_WIRE_COMPRESSION", None)
        if "HVT_SERVING_BATCH" not in env_extra:
            env.pop("HVT_SERVING_BATCH", None)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                              text=True, timeout=timeout)
        seconds = time.perf_counter() - t0
        assert proc.returncode == 0, (name, proc.stdout[-8000:],
                                      proc.stderr[-8000:])
        with open(path) as f:
            out[name] = (json.load(f), seconds)
    return out


def serve4_line(runs):
    """SERVE4's summary: per run and phase, each replica's ranks, p50, p99,
    requests/s, admitted and shed; the isolation block; whether every
    replica's members share their decision log."""
    line = {}
    for name, (doc, seconds) in runs.items():
        phases = {}
        for pname, phase in doc["phases"].items():
            phases[pname] = {rid: {k: agg[k] for k in (
                "ranks", "p50_ms", "p99_ms", "throughput_rps", "admitted",
                "shed", "deadline_miss")}
                for rid, agg in phase["replicas"].items()}
            by_rep = {}
            for s in phase["ranks"]:
                by_rep.setdefault(s["replica"], set()).add(
                    s["decisions_sha256"])
            phases[pname]["decision_logs_equal"] = all(
                len(v) == 1 for v in by_rep.values())
        line[name] = {"seconds": seconds, "phases": phases,
                      "isolation": doc.get("isolation"),
                      "partition": doc["config"].get("partition"),
                      "serving_batch": doc["config"].get("serving_batch")}
    return line


if __name__ == "__main__":
    if sys.argv[1] == "gang":
        gang(sys.argv[2], json.loads(sys.argv[3]))
    elif sys.argv[1] == "fake-hosts":
        fake_hosts(int(sys.argv[2]), sys.argv[3:])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]}")
