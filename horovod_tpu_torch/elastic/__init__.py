"""Elastic (fault-tolerant) training: the port's copy of the JAX package's
``horovod_tpu/elastic`` and ``horovod_tpu/torch/elastic`` (Horovod's
``common/elastic.py`` and ``torch/elastic/``).

A lost card surfaces as :class:`HorovodInternalError` (a collective failed,
or the elastic driver saw the worker die and aborted the survivors'
communicators) or as :class:`HostsUpdatedInterrupt` (a host change, told at
a commit). :func:`run` restores the last committed state, re-initializes
on the next rendezvous round, syncs from the new rank 0 and re-enters the
train function. The driver side is ``horovod_tpu_torch/runner/elastic``,
started by ``python -m horovod_tpu_torch.runner.launch --min-np ...``.
"""

from horovod_tpu_torch.elastic.run import run
from horovod_tpu_torch.elastic.sampler import ElasticSampler
from horovod_tpu_torch.elastic.state import (ObjectState,
                                             ReplicaUnavailableError,
                                             ReplicatedState,
                                             ShardCorruptError, State)
from horovod_tpu_torch.elastic.torch_state import (ModelStateHandler,
                                                   OptimizerStateHandler,
                                                   ReplicatedTorchState,
                                                   SamplerStateHandler,
                                                   TorchState)

__all__ = ["State", "ObjectState", "TorchState", "ElasticSampler",
           "ReplicatedState", "ReplicatedTorchState",
           "ReplicaUnavailableError", "ShardCorruptError", "run",
           "ModelStateHandler", "OptimizerStateHandler",
           "SamplerStateHandler"]
