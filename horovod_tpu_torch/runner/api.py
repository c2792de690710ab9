"""The programmatic launch API (the JAX package's ``runner/api.py``;
Horovod's ``horovod/runner/__init__.py:91`` ``run()``, the "interactive
run" of notebooks and of the Spark and Ray layers): run ``fn`` in ``np``
processes through the port's launcher and return the per-rank results
ordered by rank."""

from __future__ import annotations

import os
import socket
import sys
import tempfile
from typing import Any, List, Optional

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def run(fn, args=(), kwargs=None, np: int = 1,
        hosts: Optional[str] = None, env: Optional[dict] = None,
        master_port: Optional[int] = None, device: Optional[str] = None,
        run_dir: Optional[str] = None,
        verbose: bool = False) -> List[Any]:
    """Launch ``fn(*args, **kwargs)`` across ``np`` processes through
    ``python -m horovod_tpu_torch.runner.launch``; inside ``fn`` the whole
    ``horovod_tpu_torch`` API (rank and size, collectives,
    DistributedOptimizer) is live.

    Workers run on the card of their local rank (NCCL) unless ``device``
    names another: ``device="cpu"`` runs them on gloo. (The JAX package's
    ``run`` pins its workers to the CPU by default, ``force_cpu=True``.)
    ``master_port`` is the TCP store's port on the first host (default: one
    free here).

    Remote ``hosts`` need a filesystem shared between this process and the
    workers: pass ``run_dir`` pointing into it (the pickled function and
    the per-rank results travel through that directory).
    """
    from horovod_tpu_torch.runner import launch as launch_mod
    from horovod_tpu_torch.runner.codec import dumps_base64
    from horovod_tpu_torch.runner.hosts import parse_hosts
    from horovod_tpu_torch.runner.launch import _is_local

    import cloudpickle

    if hosts and run_dir is None:
        remote = [h.hostname for h in parse_hosts(hosts)
                  if not _is_local(h.hostname)]
        if remote:
            raise ValueError(
                f"run(hosts=...) with remote hosts {remote} needs "
                f"run_dir= on a filesystem shared with those hosts: the "
                f"function and results are exchanged through it")

    kwargs = kwargs or {}
    with tempfile.TemporaryDirectory(prefix="hvt_run_",
                                     dir=run_dir) as tmp:
        fn_path = os.path.join(tmp, "fn.b64")
        with open(fn_path, "w") as f:
            f.write(dumps_base64((fn, args, kwargs)))
        port = _free_port() if master_port is None else master_port
        argv = ["-np", str(np), "--master-port", str(port)]
        if hosts:
            argv += ["-H", hosts]
        if verbose:
            argv += ["--verbose"]
        argv += [sys.executable, "-m", "horovod_tpu_torch.runner.task_runner",
                 fn_path, tmp]
        extra = dict(env or {})
        if device is not None:
            extra["HVT_RUN_DEVICE"] = str(device)
        old = {k: os.environ.get(k) for k in extra}
        os.environ.update(extra)
        try:
            rc = launch_mod.main(argv)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if rc != 0:
            raise RuntimeError(f"hvt.runner.run failed with exit code {rc}")
        results = []
        for rank in range(np):
            path = os.path.join(tmp, f"result_{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {rank} produced no result")
            with open(path, "rb") as f:
                results.append(cloudpickle.load(f))
        return results
