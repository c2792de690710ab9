"""The IBM LSF ``jsrun`` launch path (Horovod's ``runner/js_run.py`` and
``runner/util/lsf.py``; the JAX package's ``runner/js_run.py``): on an LSF
cluster the hosts come from ``LSB_MCPU_HOSTS`` or ``LSB_HOSTS`` and
``jsrun`` places one resource set a rank. Each rank derives its identity
from the MPI environment jsrun gives it (``mpi_run.env_from_mpi``), or
from jsrun's own ``JSM_NAMESPACE_*`` (:func:`env_from_jsm`)."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional


def in_lsf_env(env: Optional[dict] = None) -> bool:
    env = os.environ if env is None else env
    return "LSB_JOBID" in env


def lsf_hosts(env: Optional[dict] = None) -> Dict[str, int]:
    """LSF's allocation, host -> slots: ``LSB_MCPU_HOSTS`` is ``host1 n1
    host2 n2 ...``; else each entry of ``LSB_HOSTS`` counts one. LSF lists
    the batch (launch) host first, and it is dropped by its position, not
    by its name."""
    env = os.environ if env is None else env
    hosts: Dict[str, int] = {}
    mcpu = env.get("LSB_MCPU_HOSTS", "")
    first_host = None
    if mcpu:
        toks = mcpu.split()
        for i in range(0, len(toks) - 1, 2):
            if first_host is None:
                first_host = toks[i]
            hosts[toks[i]] = int(toks[i + 1])
    else:
        for h in env.get("LSB_HOSTS", "").split():
            if first_host is None:
                first_host = h
            hosts[h] = hosts.get(h, 0) + 1
    if first_host is not None and len(hosts) > 1:
        hosts.pop(first_host, None)
    return hosts


def build_jsrun_command(np: int, command: List[str],
                        smpiargs: str = "-disable_gpu_hooks"
                        ) -> List[str]:
    """One resource set a rank (Horovod's js_run.py: ``jsrun -n<np> -a1
    -cALL_CPUS``); the JAX package's CPU-only resource set, as its TPU
    hosts have no GPU."""
    cmd = ["jsrun", f"-n{np}", "-a1", "-cALL_CPUS"]
    if smpiargs:
        cmd += ["--smpiargs", smpiargs]
    cmd += command
    return cmd


def env_from_jsm(base_env: Optional[dict] = None) -> dict:
    """The ``HVT_*`` identity from jsrun's ``JSM_NAMESPACE_*`` variables;
    a variable already set is left out."""
    env = dict(os.environ if base_env is None else base_env)
    pairs = (("HVT_PROCESS_ID", "JSM_NAMESPACE_RANK"),
             ("HVT_NUM_PROCESSES", "JSM_NAMESPACE_SIZE"),
             ("HVT_LOCAL_PROCESS_ID", "JSM_NAMESPACE_LOCAL_RANK"),
             ("HVT_LOCAL_SIZE", "JSM_NAMESPACE_LOCAL_SIZE"))
    return {k: env[j] for k, j in pairs if not env.get(k) and env.get(j)}


def js_run(args, slots, master_addr: str) -> int:
    """Run the job through ``jsrun`` (``launch --use-jsrun``)."""
    from horovod_tpu_torch.runner.mpi_run import job_env

    del slots   # jsrun places the ranks
    if shutil.which("jsrun") is None:
        print("[launch] jsrun not found on PATH", file=sys.stderr)
        return 1
    cmd = build_jsrun_command(args.num_proc, list(args.command))
    return subprocess.run(cmd, env=job_env(args, master_addr)).returncode
