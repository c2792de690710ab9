"""Multi-tenant serving gangs (the JAX package's ``serving/``).

Turns a job's ranks into N independent inference **replicas** (one process
set, one lane, each) plus a cross-replica sync set, with admission control
and load shedding at the request layer:

- :class:`ReplicaGang` partitions the world, serves requests onto this
  rank's replica lane as allreduces, enforces a bounded in-flight window
  (``Handle.wait(timeout=)`` admission deadlines, deterministic
  shed-on-backlog), and pushes per-rank serving stats to the elastic
  rendezvous KV for the autoscaler;
- :mod:`horovod_tpu_torch.serving.loadgen` replays mixed open-loop traffic
  against a ReplicaGang and records p50/p99/throughput to a JSON artifact
  (``python -m horovod_tpu_torch.serving.loadgen`` under the port's
  launcher).
"""

from horovod_tpu_torch.serving.replica_gang import ReplicaGang, ReplicaStats

__all__ = ["ReplicaGang", "ReplicaStats"]
