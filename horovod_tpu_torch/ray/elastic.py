"""Elastic training on Ray (the JAX package's ``ray/elastic.py``; Horovod's
``horovod/ray/elastic.py``: ``RayHostDiscovery``, ``ElasticRayExecutor:300``):
the Ray cluster's state is the host-discovery source of the port's
ElasticDriver, so Ray's autoscaling grows and shrinks the training job."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from horovod_tpu_torch.runner.elastic.discovery import HostDiscovery


class RayHostDiscovery(HostDiscovery):
    """Discovers hosts from ``ray.nodes()`` (Horovod's RayHostDiscovery):
    every alive node with enough CPUs (or GPUs when ``use_gpu``)
    contributes ``slots`` workers.

    ``nodes_fn`` is injectable for tests; it defaults to ``ray.nodes``."""

    def __init__(self, use_gpu: bool = False, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1,
                 nodes_fn: Optional[Callable] = None):
        self.use_gpu = use_gpu
        self.cpus_per_slot = cpus_per_slot
        self.gpus_per_slot = gpus_per_slot
        self._nodes_fn = nodes_fn

    def _nodes(self):
        if self._nodes_fn is not None:
            return self._nodes_fn()
        import ray

        return ray.nodes()

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        hosts: Dict[str, int] = {}
        for node in self._nodes():
            if not node.get("Alive"):
                continue
            resources = node.get("Resources", {})
            hostname = node.get("NodeManagerHostname") or \
                node.get("NodeManagerAddress")
            if not hostname:
                continue
            if self.use_gpu:
                slots = int(resources.get("GPU", 0) // self.gpus_per_slot)
            else:
                slots = int(resources.get("CPU", 0) // self.cpus_per_slot)
            if slots > 0:
                hosts[hostname] = slots
        return hosts


class ElasticRayExecutor:
    """Fault-tolerant executor: the port's ElasticDriver over
    RayHostDiscovery (Horovod's ``ElasticRayExecutor:300``). Workers run
    the user function under ``@hvt.elastic.run``; a Ray node lost or gained
    starts a new rendezvous round through the elastic protocol. Slots are
    the nodes' GPUs by default (``use_gpu=True``: the port runs on the
    card), their CPUs with ``use_gpu=False``."""

    def __init__(self, min_np: int = 1, max_np: Optional[int] = None,
                 use_gpu: bool = True, cpus_per_slot: int = 1,
                 reset_limit: Optional[int] = None,
                 elastic_timeout: float = 600.0,
                 override_discovery: Optional[HostDiscovery] = None,
                 master_port: int = 29561):
        from horovod_tpu_torch.runner.elastic.settings import \
            ElasticSettings

        self.discovery = override_discovery or RayHostDiscovery(
            use_gpu=use_gpu, cpus_per_slot=cpus_per_slot)
        self.settings = ElasticSettings(
            min_np=min_np, max_np=max_np, reset_limit=reset_limit,
            elastic_timeout=elastic_timeout)
        self.master_port = master_port
        self.driver = None
        self.rendezvous = None

    def start(self):
        from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
        from horovod_tpu_torch.runner.http_server import RendezvousServer
        from horovod_tpu_torch.runner.launch import round_master_port

        self.rendezvous = RendezvousServer(
            lambda slots, round_: round_master_port(
                slots[0].hostname, round_, self.master_port))
        self.rendezvous.start()
        self.driver = ElasticDriver(self.rendezvous, self.discovery,
                                    self.settings)

    def run(self, worker_fn: Callable, np: Optional[int] = None) -> Dict:
        """Run ``worker_fn(slot_info) -> exit_code`` elastically on the
        discovered hosts; returns the final per-rank exit codes. On a live
        Ray cluster ``worker_fn`` typically submits a Ray task pinned to
        ``slot_info.hostname``; tests pass a local callable."""
        if self.driver is None:
            raise RuntimeError("call start() before run()")
        self.driver.start(np or self.settings.min_np,
                          create_worker_fn=worker_fn)
        self.driver.wait()
        if self.driver.error:
            raise RuntimeError(self.driver.error)
        return self.driver.get_results()

    def shutdown(self):
        if self.driver is not None:
            self.driver.stop()
        if self.rendezvous is not None:
            self.rendezvous.stop()
