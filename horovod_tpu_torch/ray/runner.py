"""Ray executor (the JAX package's ``ray/runner.py``; Horovod's
``horovod/ray/runner.py``: ``RayExecutor:250``, Ray actors become job
slots; ``Coordinator:178``, rank and hostname maps and the rendezvous
env).

The Coordinator is pure logic (no ray import), so rank assignment and env
construction are testable anywhere; RayExecutor needs a live ``ray`` and is
import-gated.

Each worker joins the job's process group on its card (NCCL) by default,
``use_gpu=True``: Ray gives an actor only its own GPU, so the workers of a
node are shown all of that node's GPUs, in local-rank order
(``CUDA_VISIBLE_DEVICES``), and local rank i drives ``cuda:i``, its own.
``use_gpu=False`` runs them on gloo. (The JAX package's workers pin JAX to
the CPU.)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional


def _ray():
    try:
        import ray

        return ray
    except ImportError as e:
        raise ImportError(
            "RayExecutor requires ray (pip install 'ray[default]'); the "
            "machine-local equivalents are python -m "
            "horovod_tpu_torch.runner.launch (hvtrun's counterpart) and "
            "horovod_tpu_torch.runner.run (programmatic)") from e


class Coordinator:
    """Turns a list of per-worker hostnames into the slot env for each
    worker (Horovod's ``runner.py:178``): ranks are grouped so workers on
    one node get consecutive local ranks, and every worker learns the
    rendezvous (master) address."""

    def __init__(self, master_addr: str, master_port: int):
        self.master_addr = master_addr
        self.master_port = master_port
        self.hostnames: List[str] = []

    def register(self, hostname: str) -> int:
        """Register one worker; returns its registration index."""
        self.hostnames.append(hostname)
        return len(self.hostnames) - 1

    @property
    def world_size(self) -> int:
        return len(self.hostnames)

    def node_workers(self) -> "OrderedDict[str, List[int]]":
        """hostname -> registration indices, in first-seen node order."""
        nodes: "OrderedDict[str, List[int]]" = OrderedDict()
        for idx, host in enumerate(self.hostnames):
            nodes.setdefault(host, []).append(idx)
        return nodes

    def slot_envs(self) -> List[Dict[str, str]]:
        """Per-registration-index HVT_* env: the slot identity of
        ``hosts.get_host_assignments`` (the one rank assignment every launch
        path shares) mapped back onto registration order, the master's
        address as ``HVT_MASTER_ADDR``/``HVT_MASTER_PORT`` (the JAX
        package's keys) and as ``HVT_COORDINATOR_ADDR``, which the port's
        ``init`` reads."""
        from horovod_tpu_torch.runner.hosts import (HostInfo,
                                                    get_host_assignments,
                                                    slot_env_vars)

        nodes = self.node_workers()
        host_list = [HostInfo(host, len(members))
                     for host, members in nodes.items()]
        slots = get_host_assignments(host_list, self.world_size)
        by_key = {(s.hostname, s.local_rank): s for s in slots}
        envs: List[Optional[Dict[str, str]]] = [None] * self.world_size
        for host, members in nodes.items():
            for lr, idx in enumerate(members):
                env = slot_env_vars(by_key[(host, lr)])
                env.update({
                    "HVT_MASTER_ADDR": self.master_addr,
                    "HVT_MASTER_PORT": str(self.master_port),
                    "HVT_COORDINATOR_ADDR":
                        f"{self.master_addr}:{self.master_port}",
                })
                envs[idx] = env
        return [e for e in envs if e is not None]

    def visible_devices(self, gpu_ids) -> List[str]:
        """Per-registration-index ``CUDA_VISIBLE_DEVICES``: every GPU id of
        the worker's node, in the local-rank order of the workers that Ray
        gave them (``gpu_ids[i]`` is worker i's list), so that local rank i
        drives ``cuda:i``, its own GPU."""
        envs = self.slot_envs()
        out = [""] * self.world_size
        for members in self.node_workers().values():
            ordered = sorted(members, key=lambda i: int(
                envs[i]["HVT_LOCAL_PROCESS_ID"]))
            ids = ",".join(str(g) for i in ordered for g in gpu_ids[i])
            for i in members:
                out[i] = ids
        return out


class RayExecutor:
    """Run a horovod_tpu_torch job on Ray actors (Horovod's
    ``RayExecutor:250``).

    Usage::

        ex = RayExecutor(num_workers=4)
        ex.start()
        results = ex.run(train_fn, args=(cfg,))
        ex.shutdown()
    """

    def __init__(self, num_workers: int, cpus_per_worker: int = 1,
                 use_gpu: bool = True, master_port: int = 29560,
                 env: Optional[dict] = None):
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu
        self.master_port = master_port
        self.extra_env = dict(env or {})
        self._workers = []
        self._ranks = []

    def start(self):
        ray = _ray()

        @ray.remote(num_cpus=self.cpus_per_worker,
                    num_gpus=1 if self.use_gpu else 0)
        class Worker:
            def hostname(self):
                import socket

                return socket.gethostname()

            def ip(self):
                import ray as _r

                return _r.util.get_node_ip_address()

            def gpu_ids(self):
                import ray as _r

                return list(_r.get_gpu_ids())

            def set_env(self, env):
                import os

                os.environ.update(env)

            def execute(self, fn, args, kwargs):
                import os

                import horovod_tpu_torch as hvt

                hvt.init(device=os.environ.get("HVT_RUN_DEVICE") or None)
                try:
                    return fn(*(args or ()), **(kwargs or {}))
                finally:
                    hvt.shutdown()

        self._workers = [Worker.remote() for _ in range(self.num_workers)]
        hostnames = ray.get([w.hostname.remote() for w in self._workers])
        ips = ray.get([w.ip.remote() for w in self._workers])
        coord = Coordinator(master_addr=ips[0],
                            master_port=self.master_port)
        for h in hostnames:
            coord.register(h)
        envs = coord.slot_envs()
        if self.use_gpu:
            visible = coord.visible_devices(
                ray.get([w.gpu_ids.remote() for w in self._workers]))
            for env, ids in zip(envs, visible):
                env["CUDA_VISIBLE_DEVICES"] = ids
        # registration order != rank order (ranks are grouped by node);
        # remember each worker's rank so run() returns rank-ordered
        self._ranks = [int(e["HVT_PROCESS_ID"]) for e in envs]
        for w, env in zip(self._workers, envs):
            env = dict(env)
            env.update(self.extra_env)
            env["HVT_RUN_DEVICE"] = "cuda" if self.use_gpu else "cpu"
            w.set_env.remote(env)

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """Execute ``fn`` on every worker; results are ordered by rank
        (as runner.run and spark.run order them), not by actor creation."""
        ray = _ray()
        if not self._workers:
            raise RuntimeError("call start() before run()")
        futures = [w.execute.remote(fn, args, kwargs)
                   for w in self._workers]
        results = ray.get(futures)
        by_rank = sorted(zip(self._ranks, results), key=lambda p: p[0])
        return [r for _, r in by_rank]

    def shutdown(self):
        ray = _ray()
        for w in self._workers:
            ray.kill(w)
        self._workers = []
