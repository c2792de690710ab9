"""The port's launcher (the JAX package's ``runner/launch.py``, static
path: Horovod's ``horovodrun``).

    python -m horovod_tpu_torch.runner.launch -np 4 python train.py
    python -m horovod_tpu_torch.runner.launch -np 8 -H host1:4,host2:4 \\
        python train.py

Each slot gets the ``HVT_*`` identity of ``hosts.slot_env_vars`` and
``HVT_COORDINATOR_ADDR=host:port``, the first host's ``--master-port``,
where ``basics.init`` joins the processes on a TCP store. Local slots run as
child processes; remote ones over ssh with the env inlined. The first slot
to fail stops the rest, and the launcher exits 1.

Each process drives the card of its local rank, so a host runs at most as
many slots as it has cards (``-np`` on one host, or ``host:slots``).

``--min-np`` or ``--host-discovery-script`` make the job elastic (the JAX
package's ``_run_elastic``, Horovod's ``launch.py:619``): an
``ElasticDriver`` and its rendezvous server run here, one worker per
discovered slot is started, and a worker's death or a host change starts a
new rendezvous round, each on a TCP store port probed free for it. The
workers train under ``@hvt.elastic.run``::

    python -m horovod_tpu_torch.runner.launch -np 4 --min-np 2 --max-np 4 \\
        --host-discovery-script ./discover.sh python train.py

``--timeline PATH`` makes every worker record its timeline shard
``PATH.rank<r>`` (``utils/timeline.py``), aligned to this process's clock
and uploaded here when it shuts down; at the job's end the shards are
merged into ``PATH``, a killed worker's local shard standing in for its
upload. A static job starts a KV server of its own for this
(``HVT_DIAG_ADDR``); an elastic one uses the driver's rendezvous.
``--metrics-port P`` makes every worker serve ``GET /metrics`` at ``P`` +
its rank (0: ephemeral ports). ``--stall-warning-sec S`` sets every
worker's stall inspector threshold (``HVT_STALL_WARN_SEC``, default 60;
``ops/negotiation.py``).

``--use-mpi`` starts the job as one ``mpirun`` command and ``--use-jsrun``
as one ``jsrun`` command (``mpi_run.py``, ``js_run.py``); each rank then
takes its identity from MPI's environment in ``basics.init``. A job whose
hosts are not all this one first runs the probe (``probe.py``): a signed
task service on each host, a ring of reachability checks, and the
rendezvous on an address of the first host that the ring reached.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import socket
import sys

from horovod_tpu_torch.runner import safe_exec
from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                            parse_hostfile, parse_hosts,
                                            slot_env_vars)

_LOCAL_NAMES = ("localhost", "127.0.0.1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.launch",
        description="Launch a horovod_tpu_torch job: one process per GPU.")
    # not required by argparse, so --check-build answers alone; main()
    # requires it for a launch
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of processes (required unless "
                        "--check-build)")
    p.add_argument("-H", "--hosts", default=None,
                   help="host1:slots,host2:slots (default: localhost:np)")
    p.add_argument("--hostfile", default=None,
                   help="hostfile with 'host slots=N' lines")
    p.add_argument("--master-port", type=int, default=29510,
                   help="the TCP store's port on the first host")
    p.add_argument("--ssh-port", type=int, default=22)
    p.add_argument("--timeline", default=None,
                   help="merged chrome-trace timeline output path; each "
                        "worker records PATH.rank<r> (Horovod's "
                        "HOROVOD_TIMELINE)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus GET /metrics from every worker "
                        "at this base port (rank r binds port+r); 0 binds "
                        "ephemeral ports")
    p.add_argument("--stall-warning-sec", type=int, default=60,
                   help="stall inspector warning threshold "
                        "(HVT_STALL_WARN_SEC)")
    p.add_argument("--use-mpi", action="store_true",
                   help="launch through a single mpirun command")
    p.add_argument("--use-jsrun", action="store_true",
                   help="launch through IBM LSF jsrun")
    elastic = p.add_argument_group(
        "elastic", "fault-tolerant launch (Horovod's launch.py:392 "
        "--min-np/--max-np/--host-discovery-script)")
    elastic.add_argument("--min-np", type=int, default=None,
                         help="minimum world size; enables elastic mode")
    elastic.add_argument("--max-np", type=int, default=None,
                         help="maximum world size (default: -np)")
    elastic.add_argument("--host-discovery-script", default=None,
                         help="executable printing one 'host:slots' per "
                              "line; polled every second")
    elastic.add_argument("--reset-limit", type=int, default=None,
                         help="max re-rendezvous rounds before failing")
    elastic.add_argument("--elastic-timeout", type=float, default=600.0,
                         help="seconds to wait for min-np slots")
    elastic.add_argument("--slots", type=int, default=1,
                         help="default slots per discovered host")
    p.add_argument("--config-file", default=None,
                   help="YAML file supplying any of these flags; explicit "
                        "CLI flags win")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print what this installation can do and exit")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    args = p.parse_args(argv)
    if not args.command and not args.check_build:
        p.error("no training command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.config_file:
        from horovod_tpu_torch.runner.config_parser import apply_config

        args = apply_config(args, args.config_file, p)
    return args


def _is_local(hostname: str) -> bool:
    return hostname in _LOCAL_NAMES or hostname == socket.gethostname()


def _ssh_command(env, hostname, ssh_port, command):
    """The slot's ssh command, its env inlined."""
    inline = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items()
        if k.startswith("HVT_") or k in ("PATH", "PYTHONPATH"))
    remote = f"cd {shlex.quote(os.getcwd())} && env {inline} " + \
        " ".join(shlex.quote(c) for c in command)
    return ["ssh", "-o", "StrictHostKeyChecking=no", "-p",
            str(ssh_port), hostname, remote]


def slot_env(base_env, slot, args, master_addr):
    """One slot's environment: ``base_env``, its identity, the
    coordinator's address and the observability flags."""
    env = dict(base_env)
    env.update(slot_env_vars(slot))
    env["HVT_COORDINATOR_ADDR"] = f"{master_addr}:{args.master_port}"
    env["HVT_STALL_WARN_SEC"] = str(getattr(args, "stall_warning_sec", 60))
    if getattr(args, "timeline", None):
        env["HVT_TIMELINE_SHARD"] = args.timeline
    if getattr(args, "metrics_port", None) is not None:
        env["HVT_METRICS_PORT"] = str(args.metrics_port)
    return env


def _reach(hostname, port) -> str:
    """This host's ``host:port`` as a worker on ``hostname`` dials it."""
    here = "127.0.0.1" if _is_local(hostname) else socket.gethostname()
    return f"{here}:{port}"


def build_commands(args, slots, master_addr, base_env=None, diag_port=None):
    """``(command, env, rank)`` of every slot: the command itself for a
    local slot, ssh for a remote one. ``diag_port`` is the port of this
    launcher's KV server (``--timeline``), given to each worker as
    ``HVT_DIAG_ADDR``."""
    base_env = dict(os.environ if base_env is None else base_env)
    cmds = []
    for slot in slots:
        env = slot_env(base_env, slot, args, master_addr)
        if diag_port is not None:
            env["HVT_DIAG_ADDR"] = _reach(slot.hostname, diag_port)
        if _is_local(slot.hostname):
            cmds.append((list(args.command), env, slot.rank))
        else:
            cmds.append((_ssh_command(env, slot.hostname, args.ssh_port,
                                      args.command),
                         dict(base_env), slot.rank))
    return cmds


def merge_timeline_shards(timeline_path, store, expected_ranks=()):
    """Merge the per-rank timeline shards into ``timeline_path``: those the
    workers uploaded to ``store`` (``/kv/timeline/<rank>``), and for an
    expected rank that uploaded none, its local shard
    ``<timeline_path>.rank<r>`` (a killed worker never uploads, but its
    flushed shard still loads). Returns the number of shards merged."""
    from horovod_tpu_torch.utils import timeline as tl

    shards, found = [], set()
    if store is not None:
        for key in store.keys("timeline"):
            v = store.get("timeline", key)
            if v is not None:
                shards.append(tl.parse_trace(v.decode(errors="replace")))
                found.add(str(key))
    missing = []
    for r in expected_ranks:
        local = f"{timeline_path}.rank{r}"
        if str(r) in found:
            continue
        if os.path.exists(local):
            shards.append(tl.load_trace(local))
        else:
            missing.append(r)
    if not shards:
        print(f"[launch] timeline: no shards recorded; {timeline_path} "
              f"not written", file=sys.stderr)
        return 0
    merged = tl.merge_traces(shards)
    with open(timeline_path, "w") as f:
        json.dump(merged, f)
    note = f" (no shard from ranks {missing})" if missing else ""
    print(f"[launch] timeline: merged {len(shards)} shard(s), "
          f"{len(merged)} events -> {timeline_path}{note}", file=sys.stderr)
    return len(shards)


def round_master_port(first_host, round_, base) -> int:
    """The TCP store port of an elastic round whose rank 0 runs on
    ``first_host``. A store of an older round can still hold its port, so
    each round gets another: one probed free now on this host, else (a
    host this process cannot probe) ``base`` rotated by the round."""
    if _is_local(first_host):
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]
    return base + round_ % 2048


def _run_elastic(args) -> int:
    """Elastic launch: an ElasticDriver and its rendezvous server here, one
    training subprocess per assigned slot, a new round on a failure or a
    host change. Every child is stopped when the job ends."""
    import threading

    from horovod_tpu_torch.runner.elastic.discovery import (
        FixedHostDiscovery, HostDiscoveryScript)
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.elastic.settings import ElasticSettings
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        default_slots=args.slots)
    elif args.hosts:
        discovery = FixedHostDiscovery(args.hosts)
    else:
        discovery = FixedHostDiscovery(f"localhost:{args.num_proc}")
    settings = ElasticSettings(
        min_np=args.min_np or args.num_proc,
        max_np=args.max_np or args.num_proc,
        elastic_timeout=args.elastic_timeout,
        reset_limit=args.reset_limit, verbose=args.verbose)

    rendezvous = RendezvousServer(
        lambda slots, round_: round_master_port(slots[0].hostname, round_,
                                                args.master_port),
        verbose=args.verbose)
    rendezvous_port = rendezvous.start()
    children = set()
    children_lock = threading.Lock()

    def create_worker(slot):
        # a remote worker reaches the rendezvous on this host
        drv = _reach(slot.hostname, rendezvous_port)
        world = rendezvous.world
        mh = world.get("master_host") or slot.hostname
        master = "127.0.0.1" if _is_local(slot.hostname) and _is_local(mh) \
            else mh
        env = slot_env(dict(os.environ), slot, args, master)
        env["HVT_COORDINATOR_ADDR"] = f"{master}:{world['master_port']}"
        env.update({
            "HVT_ELASTIC": "1",
            "HVT_ELASTIC_ROUND": str(world["round"]),
            "HVT_ELASTIC_NOTIFY_ADDR": drv, "HVT_RENDEZVOUS_ADDR": drv})
        # the driver aborts a dead peer's survivors itself; NCCL's watchdog
        # must then clean up (2) rather than kill the survivor (1, 3)
        env.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        if _is_local(slot.hostname):
            cmd = list(args.command)
        else:
            cmd = _ssh_command(env, slot.hostname, args.ssh_port,
                               args.command)
            env = dict(os.environ)
        child = safe_exec.Child(cmd, env, tag=slot.rank)
        with children_lock:
            children.add(child)
        try:
            return child.wait()
        finally:
            with children_lock:
                children.discard(child)

    def terminate_children():
        with children_lock:
            live = list(children)
        for c in live:
            c.terminate()

    driver = ElasticDriver(rendezvous, discovery, settings,
                           create_worker_fn=create_worker,
                           on_stop=terminate_children)
    # HVT_AUTOSCALE=1: scale out on a sustained worker backlog, shed on
    # failure reports (runner/elastic/autoscaler.py)
    from horovod_tpu_torch.runner.elastic.autoscaler import \
        maybe_start_autoscaler
    autoscaler = maybe_start_autoscaler(driver, rendezvous,
                                        verbose=bool(args.verbose))
    try:
        driver.start(args.num_proc)
        driver.wait()
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        terminate_children()
        if args.timeline:
            # the world's size varies by round: merge what was uploaded
            # (the timeline scope survives round resets), with local shards
            # standing in over the last round's ranks
            merge_timeline_shards(
                args.timeline, rendezvous.store,
                expected_ranks=range(rendezvous.world.get("size")
                                     or args.num_proc))
        rendezvous.stop()
    print("[launch] elastic rounds: " + json.dumps(driver.rounds),
          file=sys.stderr)
    if driver.error:
        print(f"[launch] elastic job failed: {driver.error}",
              file=sys.stderr)
        return 1
    bad = {r: rc for r, rc in driver.get_results().items() if rc != 0}
    if bad:
        print(f"[launch] ranks failed: {sorted(bad.items())}",
              file=sys.stderr)
        return 1
    return 0


def check_build(verbose: bool = False) -> int:
    """Print what this installation can do (``horovodrun --check-build``):
    the framework, the backends torch.distributed has, and whether the
    CUDA kernels can be built and run here."""
    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import _kernels

    def mark(ok):
        return "X" if ok else " "

    import shutil

    cuda = torch.cuda.is_available()
    try:
        nvcc = bool(_kernels._nvcc())
    except RuntimeError:
        nvcc = False
    print(f"""\
horovod_tpu_torch (torch {torch.__version__}, CUDA {torch.version.cuda}):

Available Frameworks:
    [X] PyTorch

Available Controllers:
    [X] TCP store (HVT_COORDINATOR_ADDR)
    [X] Elastic HTTP rendezvous (--min-np, --host-discovery-script)
    [{mark(shutil.which("mpirun"))}] mpirun on PATH (--use-mpi)
    [{mark(shutil.which("jsrun"))}] jsrun on PATH (--use-jsrun)

Available Tensor Operations:
    [{mark(basics.nccl_built())}] NCCL
    [{mark(basics.gloo_built())}] Gloo
    [{mark(basics.mpi_built())}] MPI

Kernels:
    [{mark(cuda)}] CUDA device
    [{mark(nvcc)}] nvcc (sm_90a flash-attention kernels)""")
    if verbose:
        print(f"\nkernel sources: {_kernels.CSRC}; built into "
              f"{_kernels.BUILD_DIR}")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.check_build:
        return check_build(verbose=args.verbose)
    if args.num_proc is None:
        print("launch: error: -np/--num-proc is required", file=sys.stderr)
        return 2
    if args.min_np is not None or args.host_discovery_script:
        return _run_elastic(args)
    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = parse_hosts(args.hosts)
    else:
        hosts = parse_hosts(f"localhost:{args.num_proc}")
    slots = get_host_assignments(hosts, args.num_proc)
    master_addr = ("127.0.0.1" if _is_local(slots[0].hostname)
                   else slots[0].hostname)
    if args.use_mpi:
        from horovod_tpu_torch.runner.mpi_run import mpi_run

        return mpi_run(args, slots, master_addr)
    if args.use_jsrun:
        from horovod_tpu_torch.runner.js_run import js_run

        return js_run(args, slots, master_addr)
    names = list(dict.fromkeys(s.hostname for s in slots))
    if not all(_is_local(h) for h in names):
        # workers on other hosts: the rendezvous address is one that the
        # probe's ring reached on the first host
        from horovod_tpu_torch.runner.probe import rendezvous_address

        master_addr = rendezvous_address(names, _is_local, args.ssh_port)
    if args.verbose:
        for s in slots:
            print(f"[launch] rank {s.rank} -> {s.hostname} "
                  f"(local {s.local_rank}/{s.local_size}, "
                  f"cross {s.cross_rank}/{s.cross_size})", file=sys.stderr)
    diag = None
    if args.timeline:
        # a KV server for the shards' upload and the clock handshake
        from horovod_tpu_torch.runner.http_server import RendezvousServer

        diag = RendezvousServer(lambda slots_, round_: args.master_port)
        diag.init(slots)
        diag.start()
    try:
        exit_codes = safe_exec.run_all(build_commands(
            args, slots, master_addr,
            diag_port=diag.port if diag is not None else None))
        if diag is not None:
            merge_timeline_shards(args.timeline, diag.store,
                                  expected_ranks=range(args.num_proc))
    finally:
        if diag is not None:
            diag.stop()
    bad = [(i, rc) for i, rc in enumerate(exit_codes) if rc != 0]
    if bad:
        print(f"[launch] ranks failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
