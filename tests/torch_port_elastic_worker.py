"""A worker of elastic horovod_tpu_torch jobs, started by the port's launcher
in elastic mode (``python -m horovod_tpu_torch.runner.launch --min-np ...``);
shared by tests/test_torch_port_elastic_driver.py, tests/test_torch_port_cuda.py
(``ELASTIC4``) and chip_smoke.py's ``elastic`` phase. Imports no JAX.

    python tests/torch_port_elastic_worker.py OUT JSON_ARGS

trains a GPT under ``@hvt.elastic.run`` with ``TorchState`` (model,
``DistributedOptimizer(AdamW)``, an ``ElasticSampler`` over a seeded dataset
of token rows; each rank records the rows of the whole world's step) or
``ReplicatedTorchState`` (model and optimizer, and a per-rank ``series``),
committing after every step. Arguments:

- ``device``, ``config`` (a name of ``train.GPT_CONFIGS``) or ``gpt`` (a
  ``GPTConfig`` dict), ``rows``, ``batch`` (rows a rank a step), ``seed``;
  ``state``: ``"torch"`` or ``"replicated"``; ``steps``: stop once the
  state counts this many steps (the replicated state reads each rank's
  own stream of rows; the sampler's epoch ends the torch state's run);
- ``kill``: ``{"slot", "after_commit", "hosts"}``: the worker of that spawn
  slot, in its first life, after its commit ``after_commit``, writes
  ``hosts`` (if any) to ``hosts_file`` and SIGKILLs itself;
- ``grow``: ``{"after_commit", "hosts"}``: rank 0, once the world shrank,
  after its ``after_commit``-th commit of that round writes ``hosts``;
- ``sigterm_after_commit``: the worker sends itself one SIGTERM after that
  commit (a preemption notice);
- ``backlog``: ``{"inflight", "until_size"}``: rank 0, before each step of a
  world smaller than ``until_size``, PUTs a serving report of ``inflight``
  requests to ``/kv/serving/0`` on the rendezvous (the autoscaler's backlog
  signal), and one of 0 once the world has grown;
- ``hosts_file``: the file the discovery script prints;
- ``sleep``: seconds to wait before each step, so that a host change
  lands mid-run on a fast CPU model;
- ``record_restored_step``: keep the model's and optimizer's state dicts
  before and after the first step that follows a recovery, with the rows
  of that step (for a small model: the test repeats the step in one
  process).

Every life of a worker writes ``OUT.slot<S>.<pid>.pt``: its events (train
entries with rank, size, round and a digest of the state; failures and
host updates; commits with their times), committed indices, losses, the
elastic run's recovery episodes and peak memory.
"""

import copy
import hashlib
import json
import os
import signal
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_START = time.time()


def digest(*objs):
    """sha256 over every tensor of ``objs`` (state dicts, nested), in order
    of sorted keys, plus the repr of everything else."""
    import torch

    h = hashlib.sha256()

    def walk(x):
        if torch.is_tensor(x):
            t = x.detach().cpu().contiguous().reshape(-1)
            h.update(str(x.dtype).encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())

    for o in objs:
        walk(o)
    return h.hexdigest()


def world_batch(sampler, position, batch, size):
    """Every rank's batch ``position`` of the sampler's current shards:
    each rank records the whole world's rows, so the rows a rank committed
    before it died stay recorded on the survivors."""
    total = sampler.total_size
    padded = list(sampler.remaining_indices)
    while padded and len(padded) < total:
        padded += padded[:total - len(padded)]
    rows = []
    for r in range(size):
        shard = padded[r:total:size]
        rows += shard[position * batch:(position + 1) * batch]
    return rows


def dataset(cfg, rows, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (rows, cfg.max_seq_len))


class Recorder:
    def __init__(self, out):
        self.slot = os.environ.get("HVT_LOCAL_PROCESS_ID", "0")
        self.path = f"{out}.slot{self.slot}.{os.getpid()}.pt"
        self.res = {"slot": int(self.slot), "pid": os.getpid(),
                    "t_start": T_START, "events": [], "committed": [],
                    "losses": [], "step_s": []}

    def event(self, kind, **kw):
        self.res["events"].append(dict(kind=kind, t=time.time(), **kw))

    def save(self):
        import torch

        import importlib

        erun = importlib.import_module("horovod_tpu_torch.elastic.run")
        self.res["recoveries"] = list(erun.recoveries)
        if torch.cuda.is_available():
            self.res["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
        torch.save(self.res, self.path)


def main():
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.models import GPT, GPTConfig
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.train import gpt_config, make_train_step

    out, args = sys.argv[1], json.loads(sys.argv[2])
    if args.get("stack_after"):     # where each thread waits, if still up
        import faulthandler

        faulthandler.dump_traceback_later(args["stack_after"])
    rec = Recorder(out)
    device = args.get("device", "cpu")
    hvt.init(device=device, timeout_s=args.get("timeout_s", 120))
    if device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (GPTConfig(**args["gpt"]) if "gpt" in args
           else gpt_config(args["config"], use_flash=True))
    data = torch.from_numpy(dataset(cfg, args["rows"], args.get("seed", 0)))
    batch = args["batch"]
    model = GPT(cfg, device=hvt.device(), seed=0)
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = make_train_step(model, opt)
    replicated = args.get("state", "torch") == "replicated"
    if replicated:
        state = hvt.elastic.ReplicatedTorchState(model=model, optimizer=opt,
                                                 steps=0, series=[])
    else:
        sampler = hvt.elastic.ElasticSampler(range(args["rows"]),
                                             shuffle=True, seed=1)
        state = hvt.elastic.TorchState(model=model, optimizer=opt,
                                       sampler=sampler, steps=0)
    kill, grow = args.get("kill"), args.get("grow")
    first_life = os.environ.get("HVT_ELASTIC_ROUND") == "1"
    K.reset_launches()
    lives = {"commits": 0, "round_commits": 0, "grown": False,
             "sizes": []}

    def report_backlog():
        from horovod_tpu_torch.runner.http_client import put_json

        grown = hvt.size() >= args["backlog"]["until_size"]
        inflight = 0 if grown else args["backlog"]["inflight"]
        put_json(os.environ["HVT_RENDEZVOUS_ADDR"], "/kv/serving/0",
                 {"rank": 0, "replica": 0, "inflight": inflight,
                  "ts": time.time()}, retries=0)
        if lives.get("backlog") != inflight:
            rec.event("backlog", inflight=inflight, size=hvt.size())
            lives["backlog"] = inflight

    def live_digest():
        return digest(model.state_dict(), opt.state_dict(),
                      state._tracked())

    def write_hosts(hosts):
        with open(args["hosts_file"], "w") as f:
            f.write(hosts + "\n")

    def commit(indices, loss):
        t0 = time.perf_counter()
        try:
            state.commit()
        except hvt.HostsUpdatedInterrupt:
            rec.res["committed"].append(
                (hvt.rank(), hvt.size(), indices))   # saved before it raised
            rec.event("hosts_updated", commit=lives["commits"] + 1)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        lives["commits"] += 1
        lives["round_commits"] += 1
        rec.res["committed"].append((hvt.rank(), hvt.size(), indices))
        info = {"commit": lives["commits"], "ms": ms, "size": hvt.size(),
                "rank": hvt.rank(), "loss": loss}
        if replicated:
            info["shard_bytes"] = state.replica_info()["shard_bytes"]
            info["payload_bytes"] = len(state._own_history[0][1])
        rec.event("commit", **info)
        n = lives["commits"]
        if kill and first_life and int(rec.slot) == kill["slot"] \
                and n == kill["after_commit"]:
            rec.res["killed_digest"] = live_digest()
            rec.res["launches"] = dict(K.LAUNCHES)
            if kill.get("hosts"):
                write_hosts(kill["hosts"])
            rec.event("killed")
            rec.save()
            os.kill(os.getpid(), signal.SIGKILL)
        if kill and n == kill["after_commit"]:
            rec.res["commit_digest"] = live_digest()
        if grow and not lives["grown"] and hvt.rank() == 0 \
                and len(lives["sizes"]) > 1 \
                and lives["sizes"][-1] < max(lives["sizes"]) \
                and lives["round_commits"] == grow["after_commit"]:
            lives["grown"] = True
            write_hosts(grow["hosts"])
            rec.event("grow_written")
        if args.get("sigterm_after_commit") == n and first_life:
            rec.event("sigterm")
            os.kill(os.getpid(), signal.SIGTERM)

    @hvt.elastic.run
    def train(state):
        lives["round_commits"] = 0
        lives["sizes"].append(hvt.size())
        rec.event("enter", rank=hvt.rank(), size=hvt.size(),
                  round=os.environ.get("HVT_ELASTIC_ROUND"),
                  digest=live_digest(), device=str(hvt.device()),
                  params_digest=digest(model.state_dict(), opt.state_dict()),
                  opt_set_size=opt._hvt_reduce_kwargs["process_set"].size(),
                  last_recovery=getattr(state, "last_recovery", None))
        # each entry follows a sync, which reshards the unprocessed rows:
        # this rank's batches start again at the first
        position = 0
        try:
            while args.get("steps") is None or \
                    state.steps < args["steps"]:
                if replicated:
                    i = state.steps * hvt.size() + hvt.rank()
                    idx = [(i * batch + j) % args["rows"]
                           for j in range(batch)]
                else:
                    idx = state.sampler.get_indices(position, batch)
                    if not idx:
                        break
                position += 1
                if args.get("backlog") and hvt.rank() == 0:
                    report_backlog()
                time.sleep(args.get("sleep", 0))   # a slower step
                restored = (args.get("record_restored_step")
                            and position == 1 and len(lives["sizes"]) > 1
                            and "restored_step" not in rec.res)
                if restored:
                    rec.res["restored_step"] = {
                        "rank": hvt.rank(), "size": hvt.size(),
                        "idx": list(idx),
                        "before": copy.deepcopy(
                            (model.state_dict(), opt.state_dict()))}
                t0 = time.perf_counter()
                loss = float(step(data[idx].to(hvt.device())))
                rec.res["step_s"].append((hvt.size(), time.perf_counter()
                                          - t0))
                if restored:
                    rec.res["restored_step"]["after"] = copy.deepcopy(
                        (model.state_dict(), opt.state_dict()))
                rec.res["losses"].append(loss)
                if replicated:
                    state.series.append((hvt.rank(), state.steps))
                else:
                    state.sampler.record_indices(world_batch(
                        state.sampler, position - 1, batch, hvt.size()))
                state.steps += 1
                commit(list(idx), loss)
        except hvt.HorovodInternalError as e:
            rec.event("internal_error", error=str(e)[:300])
            raise
        rec.res["launches"] = dict(K.LAUNCHES)
        return state.steps

    steps = train(state)
    rec.event("done", steps=steps, rank=hvt.rank(), size=hvt.size(),
              digest=live_digest())
    rec.res["final_params_digest"] = digest(model.state_dict())
    rec.res["final_processed"] = (None if replicated else
                                  sorted(state.sampler.processed_indices))
    rec.save()
    hvt.shutdown()


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ElasticLaunch:
    """``python -m horovod_tpu_torch.runner.launch -np n --min-np ...
    --host-discovery-script <script> python <this file> out args``,
    started at construction. The script prints ``out.hosts``, which starts
    as ``localhost:<slots or n>`` and which the workers rewrite (``kill``,
    ``grow``).
    The launcher's output goes to ``out.log``."""

    def __init__(self, n, out, args, min_np, max_np=None, timeout=240,
                 env=None, slots=None, launcher_args=()):
        self.out, self.timeout = out, timeout
        hosts, script = out + ".hosts", out + ".discover.sh"
        with open(hosts, "w") as f:
            f.write(f"localhost:{slots or n}\n")
        with open(script, "w") as f:
            f.write(f"#!/bin/sh\ncat {hosts}\n")
        os.chmod(script, 0o755)
        args = dict(args, hosts_file=hosts)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(n), "--min-np", str(min_np), "--max-np",
               str(max_np or n), "--host-discovery-script", script,
               "--master-port", str(free_port()), *launcher_args,
               sys.executable,
               os.path.abspath(__file__), out, json.dumps(args)]
        env = dict(os.environ if env is None else env, PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        self.log = out + ".log"
        import subprocess

        self.t0 = time.time()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                         stderr=subprocess.STDOUT)
        self._results = None

    def wait(self):
        """The launcher's exit code and output."""
        try:
            self.proc.wait(timeout=self.timeout)
        finally:
            self.kill()
        with open(self.log) as f:
            return self.proc.returncode, f.read()

    def results(self):
        """``(lives, rounds, seconds)``: every worker life's results, the
        driver's rounds, and the job's wall seconds; raises with the
        output's end if the job failed."""
        import glob

        import torch

        if self._results is None:
            rc, log = self.wait()
            seconds = time.time() - self.t0
            assert rc == 0, log[-20000:]
            rounds = json.loads(log.split("[launch] elastic rounds: ")[1]
                                .splitlines()[0])
            lives = [torch.load(f, weights_only=False)
                     for f in sorted(glob.glob(self.out + ".slot*.pt"))]
            self._results = (lives, rounds, seconds)
        return self._results

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def analyze(lives, rounds):
    """What the elastic tests hold, from every life's results and the
    driver's rounds."""
    events = [dict(e, slot=life["slot"], pid=life["pid"])
              for life in lives for e in life["events"]]
    killed = [e for e in events if e["kind"] == "killed"]
    t_kill = killed[0]["t"] if killed else None
    enters = [e for e in events if e["kind"] == "enter"]
    by_round = {}
    for e in enters:
        by_round.setdefault(int(e["round"]), []).append(e)
    counts = {}
    for life in lives:
        for _rank, _size, idx in life["committed"]:
            for i in idx:
                counts[i] = counts.get(i, 0) + 1
    out = {
        "round_sizes": [r["size"] for r in rounds],
        "round_ranks": [r["ranks"] for r in rounds],
        "round_times": [r["time"] for r in rounds],
        "entered_sizes": {r: sorted({e["size"] for e in es})
                          for r, es in sorted(by_round.items())},
        "params_agree": {r: len({e["params_digest"] for e in es}) == 1
                         for r, es in sorted(by_round.items())},
        # the optimizer reduces over the world of its round
        "opt_set_sizes_match": all(e["opt_set_size"] == e["size"]
                                   for e in enters),
        "committed_counts": counts,
        "kill_to_internal_error_s": {
            e["slot"]: e["t"] - t_kill for e in events
            if e["kind"] == "internal_error" and t_kill is not None},
        "losses_finite": all(np.isfinite(x) for life in lives
                             for x in life["losses"]),
        "devices": sorted({e["device"] for e in enters}),
        "devices_by_slot": {slot: sorted({e["device"] for e in enters
                                          if e["slot"] == slot})
                            for slot in sorted({e["slot"] for e in enters})},
    }
    # a survivor's state at its first entry after the kill against its
    # snapshot of the commit the killed worker made last
    out["restored_equals_commit"] = {}
    for life in lives:
        if "commit_digest" not in life or "killed_digest" in life \
                or life["t_start"] > t_kill:
            continue
        after = [e for e in life["events"] if e["kind"] == "enter"
                 and t_kill is not None and e["t"] > t_kill]
        if after:
            out["restored_equals_commit"][life["slot"]] = \
                after[0]["digest"] == life["commit_digest"]
    # a fresh worker's state after its first sync against the killed one's
    fresh = [life for life in lives if t_kill is not None
             and life["t_start"] > t_kill]
    killed_life = [life for life in lives if "killed_digest" in life]
    if fresh and killed_life:
        first = [e for e in fresh[0]["events"] if e["kind"] == "enter"][0]
        out["fresh_equals_killed"] = \
            first["digest"] == killed_life[0]["killed_digest"]
        out["fresh_last_recovery"] = first.get("last_recovery")
        out["fresh_start_to_enter_s"] = first["t"] - fresh[0]["t_start"]
    grow = [e for e in events if e["kind"] == "grow_written"]
    if grow:
        later = [e for e in enters if e["t"] > grow[0]["t"]]
        out["grow_written_to_resumed_s"] = (max(e["t"] for e in later)
                                            - grow[0]["t"]) if later else None
    return out


if __name__ == "__main__":
    main()
