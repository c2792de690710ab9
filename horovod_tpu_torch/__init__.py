"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

A Horovod-style data-parallel training framework on ``torch.distributed``
(one process per GPU, NCCL), whose attention kernels are hand-written for
Hopper. The JAX package ``horovod_tpu`` is the reference this package is
held against; nothing here imports it or JAX. Names follow the JAX
package's.

    import horovod_tpu_torch as hvt

    hvt.init()                                   # NCCL on cuda:{local_rank}
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    hvt.broadcast_parameters(model.state_dict(), root_rank=0)

Launch a job with ``python -m horovod_tpu_torch.runner.launch -np N
python train.py``; shard a model with ``parallel.fsdp.shard_module``; save
and resume with ``hvt.checkpoint.CheckpointManager``.
"""

from horovod_tpu_torch import callbacks, checkpoint
from horovod_tpu_torch.common.basics import (
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, device,
    gloo_built, gloo_enabled, init, is_homogeneous, is_initialized,
    local_rank, local_size, mpi_built, mpi_enabled, mpi_threads_supported,
    nccl_built, process_rank, process_size, rank, rocm_built, shutdown, size,
    xla_built)
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HorovodTimeoutError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.common.process_sets import (
    ProcessSet, add_process_set, global_process_set,
    process_set_included_ranks, remove_process_set)
from horovod_tpu_torch.ops.adasum import adasum_reduce, pairwise_adasum
from horovod_tpu_torch.ops.collective_ops import (
    Adasum, Average, Max, Min, Product, ReduceOp, Sum, allgather,
    allgather_async, allreduce, allreduce_, allreduce_async,
    allreduce_async_, alltoall, alltoall_async, barrier, broadcast,
    broadcast_, broadcast_async, broadcast_async_, grouped_allgather,
    grouped_allgather_async, grouped_allreduce, grouped_allreduce_,
    grouped_allreduce_async, grouped_allreduce_async_, grouped_reducescatter,
    poll, reducescatter, reducescatter_async, synchronize)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_with_lse)
from horovod_tpu_torch.ops.functions import (allgather_object,
                                             broadcast_object,
                                             broadcast_object_fn,
                                             broadcast_optimizer_state,
                                             broadcast_parameters,
                                             broadcast_variables)
from horovod_tpu_torch.ops.hierarchical import (hierarchical_allgather,
                                                hierarchical_allreduce)
from horovod_tpu_torch.ops.sparse import (apply_sparse, sparse_allreduce,
                                          sparse_allreduce_apply)
from horovod_tpu_torch.optimizer import (DistributedOptimizer,
                                         PartialDistributedOptimizer)
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "device",
    "process_rank", "process_size", "is_homogeneous",
    "nccl_built", "gloo_built", "gloo_enabled", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "cuda_built", "rocm_built", "ccl_built",
    "ddl_built", "xla_built",
    "HorovodInternalError", "HorovodTimeoutError", "HostsUpdatedInterrupt",
    "ProcessSet", "global_process_set", "add_process_set",
    "remove_process_set", "process_set_included_ranks",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_", "allgather", "allgather_async",
    "grouped_allgather", "grouped_allgather_async", "broadcast",
    "broadcast_", "broadcast_async", "broadcast_async_", "alltoall",
    "alltoall_async", "reducescatter", "reducescatter_async",
    "grouped_reducescatter", "barrier", "synchronize", "poll",
    "adasum_reduce", "pairwise_adasum",
    "hierarchical_allreduce", "hierarchical_allgather",
    "allgather_object", "broadcast_object", "broadcast_object_fn",
    "broadcast_parameters", "broadcast_variables",
    "broadcast_optimizer_state",
    "sparse_allreduce", "apply_sparse", "sparse_allreduce_apply",
    "Compression", "flash_attention", "flash_attention_with_lse",
    "DistributedOptimizer", "PartialDistributedOptimizer", "SyncBatchNorm",
    "callbacks", "checkpoint",
]
