"""The MPI launch path (Horovod's ``runner/mpi_run.py``: the implementation
probe ``_get_mpi_implementation:73``, the flag sets ``:32-44`` and the
``mpirun`` command ``:177-196`` with ``-x`` env forwarding; the JAX
package's ``runner/mpi_run.py``).

``launch --use-mpi`` builds ONE ``mpirun`` command that places every rank;
each rank then derives its ``HVT_*`` slot environment from MPI's
(``OMPI_COMM_WORLD_RANK`` and the like, :func:`env_from_mpi`) in
``basics.init``, and the processes join on the TCP store at
``HVT_COORDINATOR_ADDR`` as in a launch of the port's own. MPI only
places the processes: the data plane stays NCCL or gloo.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
from typing import List, Optional

OPENMPI = "OpenMPI"
SPECTRUM = "Spectrum MPI"
MPICH = "MPICH"
INTEL = "IMPI"
UNKNOWN = "Unknown"

# each implementation's flags (Horovod's mpi_run.py:32-44)
_BASIC_ARGS = {
    OPENMPI: ["--allow-run-as-root", "--tag-output"],
    SPECTRUM: ["--tag-output"],
    MPICH: [],
    INTEL: [],
    UNKNOWN: [],
}
# large-cluster flags, past 64 hosts
_LARGE_CLUSTER_ARGS = {
    OPENMPI: ["-mca", "plm_rsh_no_tree_spawn", "true"],
    SPECTRUM: [],
    MPICH: [],
    INTEL: [],
    UNKNOWN: [],
}
_LARGE_CLUSTER_THRESHOLD = 64


def get_mpi_implementation(mpirun: str = "mpirun") -> Optional[str]:
    """The implementation ``mpirun --version`` names; None when there is
    no ``mpirun``."""
    try:
        out = subprocess.run([mpirun, "--version"], capture_output=True,
                             text=True, timeout=10)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    text = out.stdout + out.stderr
    if "Open MPI" in text or "OpenRTE" in text:
        return OPENMPI
    if "IBM Spectrum MPI" in text:
        return SPECTRUM
    if "MPICH" in text or "HYDRA" in text:
        return MPICH
    if "Intel(R) MPI" in text:
        return INTEL
    return UNKNOWN


def env_forward_args(impl: str, env_keys: List[str]) -> List[str]:
    """Forward ``env_keys`` to every rank: ``-x`` for the OpenMPI family,
    ``-genvlist`` for MPICH and Intel MPI."""
    if impl in (OPENMPI, SPECTRUM, UNKNOWN):
        out = []
        for k in env_keys:
            out += ["-x", k]
        return out
    return ["-genvlist", ",".join(env_keys)] if env_keys else []


def build_mpirun_command(np: int, hosts: str, command: List[str],
                         env: dict, impl: str = OPENMPI,
                         ssh_port: Optional[int] = None,
                         extra_args: Optional[List[str]] = None
                         ) -> List[str]:
    """The one ``mpirun`` command (Horovod's mpi_run.py:177-196): the
    implementation's flags, the large-cluster flags past 64 hosts, the
    hosts, and the ``HVT_*``, ``PATH`` and ``PYTHONPATH`` variables of
    ``env`` forwarded."""
    host_list = [h for h in hosts.split(",") if h]
    cmd = ["mpirun", "-np", str(np)]
    cmd += _BASIC_ARGS.get(impl, [])
    if len(host_list) > _LARGE_CLUSTER_THRESHOLD:
        cmd += _LARGE_CLUSTER_ARGS.get(impl, [])
    if impl in (OPENMPI, SPECTRUM, UNKNOWN):
        cmd += ["-H", hosts]
        if ssh_port:
            cmd += ["-mca", "plm_rsh_args", f"-p {ssh_port}"]
    else:
        cmd += ["-hosts", ",".join(h.split(":")[0] for h in host_list)]
    forward = sorted(k for k in env
                     if k.startswith("HVT_") or k in ("PATH", "PYTHONPATH"))
    cmd += env_forward_args(impl, forward)
    cmd += extra_args or []
    cmd += command
    return cmd


def env_from_mpi(base_env: Optional[dict] = None) -> dict:
    """The ``HVT_*`` identity of a process that ``mpirun`` started, from
    MPI's environment (Open MPI's ``OMPI_COMM_WORLD_*``, else PMI's). A
    variable already set is never overridden: it is left out."""
    env = dict(os.environ if base_env is None else base_env)
    pairs = [
        ("HVT_PROCESS_ID", ["OMPI_COMM_WORLD_RANK", "PMI_RANK"]),
        ("HVT_NUM_PROCESSES", ["OMPI_COMM_WORLD_SIZE", "PMI_SIZE"]),
        ("HVT_LOCAL_PROCESS_ID", ["OMPI_COMM_WORLD_LOCAL_RANK",
                                  "MPI_LOCALRANKID"]),
        ("HVT_LOCAL_SIZE", ["OMPI_COMM_WORLD_LOCAL_SIZE",
                            "MPI_LOCALNRANKS"]),
    ]
    out = {}
    for hvt_key, mpi_keys in pairs:
        if env.get(hvt_key):
            continue
        for mk in mpi_keys:
            if env.get(mk):
                out[hvt_key] = env[mk]
                break
    return out


def job_env(args, master_addr: str) -> dict:
    """What every rank of an MPI or jsrun launch shares: this environment,
    the coordinator's address, the stall threshold, the observability
    flags, and ``HVT_FROM_MPI``."""
    env = dict(os.environ)
    env.update({"HVT_COORDINATOR_ADDR": f"{master_addr}:{args.master_port}",
                "HVT_STALL_WARN_SEC": str(args.stall_warning_sec),
                "HVT_FROM_MPI": "1"})
    if getattr(args, "timeline", None):
        env["HVT_TIMELINE_SHARD"] = args.timeline
    if getattr(args, "metrics_port", None) is not None:
        env["HVT_METRICS_PORT"] = str(args.metrics_port)
    return env


def mpi_run(args, slots, master_addr: str) -> int:
    """Run the job through ``mpirun`` (``launch --use-mpi``)."""
    impl = get_mpi_implementation()
    if impl is None:
        print("[launch] mpirun not found on PATH", file=sys.stderr)
        return 1
    env = job_env(args, master_addr)
    hosts = ",".join(sorted({f"{s.hostname}:{s.local_size}"
                             for s in slots}))
    cmd = build_mpirun_command(args.num_proc, hosts, list(args.command),
                               env, impl=impl, ssh_port=args.ssh_port)
    if args.verbose:
        print("[launch] " + " ".join(shlex.quote(c) for c in cmd),
              file=sys.stderr)
    return subprocess.run(cmd, env=env).returncode
