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
"""

from __future__ import annotations

import argparse
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
    """One slot's environment: ``base_env``, its identity and the
    coordinator's address."""
    env = dict(base_env)
    env.update(slot_env_vars(slot))
    env["HVT_COORDINATOR_ADDR"] = f"{master_addr}:{args.master_port}"
    return env


def build_commands(args, slots, master_addr, base_env=None):
    """``(command, env, rank)`` of every slot: the command itself for a
    local slot, ssh for a remote one."""
    base_env = dict(os.environ if base_env is None else base_env)
    cmds = []
    for slot in slots:
        env = slot_env(base_env, slot, args, master_addr)
        if _is_local(slot.hostname):
            cmds.append((list(args.command), env, slot.rank))
        else:
            cmds.append((_ssh_command(env, slot.hostname, args.ssh_port,
                                      args.command),
                         dict(base_env), slot.rank))
    return cmds


def check_build(verbose: bool = False) -> int:
    """Print what this installation can do (``horovodrun --check-build``):
    the framework, the backends torch.distributed has, and whether the
    CUDA kernels can be built and run here."""
    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import _kernels

    def mark(ok):
        return "X" if ok else " "

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
    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = parse_hosts(args.hosts)
    else:
        hosts = parse_hosts(f"localhost:{args.num_proc}")
    slots = get_host_assignments(hosts, args.num_proc)
    master_addr = ("127.0.0.1" if _is_local(slots[0].hostname)
                   else slots[0].hostname)
    if args.verbose:
        for s in slots:
            print(f"[launch] rank {s.rank} -> {s.hostname} "
                  f"(local {s.local_rank}/{s.local_size}, "
                  f"cross {s.cross_rank}/{s.cross_size})", file=sys.stderr)
    exit_codes = safe_exec.run_all(build_commands(args, slots, master_addr))
    bad = [(i, rc) for i, rc in enumerate(exit_codes) if rc != 0]
    if bad:
        print(f"[launch] ranks failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
