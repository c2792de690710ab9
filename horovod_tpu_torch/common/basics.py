"""Process topology and lifecycle on ``torch.distributed``.

One process drives one GPU, as in Horovod: ``rank``/``size`` count
processes and each process owns ``cuda:{local_rank}``. This differs from
the JAX package (``horovod_tpu/common/basics.py``), where one process drives
every chip of its host and ``size`` counts chips.

``init`` reads the identity env that the ``hvtrun`` launcher gives each slot
(``HVT_PROCESS_ID``, ``HVT_NUM_PROCESSES``, ``HVT_LOCAL_PROCESS_ID``,
``HVT_LOCAL_SIZE``, ``HVT_CROSS_RANK``, ``HVT_CROSS_SIZE``, and
``HVT_COORDINATOR_ADDR`` as ``host:port``). With more than one process it
joins them on a TCP store at the coordinator's address; without that env it
starts a world of one process on an in-memory store. The backend is NCCL
on the GPU, or gloo when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

_lock = threading.Lock()
_state = None  # the running world's _World, or None


class _World:
    def __init__(self, rank, size, local_rank, local_size, cross_rank,
                 cross_size, device):
        self.rank, self.size = rank, size
        self.local_rank, self.local_size = local_rank, local_size
        self.cross_rank, self.cross_size = cross_rank, cross_size
        self.device = device
        # registered process sets by id (common/process_sets.py) and the
        # groups derived from the topology (ops/hierarchical.py)
        self.process_sets = {}
        self.next_process_set_id = 1
        self.groups = {}


def _env_int(name, default):
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for and missing; it never falls
    back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return device


def init(comm=None, process_sets=None, device=None, timeout_s=300):
    """Start the process group (idempotent).

    ``device`` is ``None``/``"cuda"`` (NCCL on ``cuda:{local_rank}``) or
    ``"cpu"`` (gloo). ``comm`` is accepted for API parity and must be
    ``None``: process placement belongs to the launcher. ``process_sets``
    (lists of ranks or ``ProcessSet`` objects) are registered in order
    after the global set, as ``add_process_set`` does; every process
    passes the same.
    """
    if comm not in (None, 0):
        raise ValueError("horovod_tpu_torch.init(comm=...) is not "
                         "supported: process placement is owned by the "
                         "launcher (hvtrun)")
    _start(device, timeout_s)
    from horovod_tpu_torch.common import process_sets as _ps

    for ps in process_sets or ():
        _ps.add_process_set(ps)


def _start(device, timeout_s):
    global _state
    with _lock:
        if _state is not None:
            return
        size = _env_int("HVT_NUM_PROCESSES", 1)
        rank = _env_int("HVT_PROCESS_ID", 0)
        local_rank = _env_int("HVT_LOCAL_PROCESS_ID", 0)
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            backend = "gloo"
        timeout = timedelta(seconds=timeout_s)
        coordinator = os.environ.get("HVT_COORDINATOR_ADDR")
        if size > 1:
            if not coordinator:
                raise ValueError("HVT_NUM_PROCESSES > 1 needs "
                                 "HVT_COORDINATOR_ADDR (host:port)")
            dist.init_process_group(backend,
                                    init_method=f"tcp://{coordinator}",
                                    world_size=size, rank=rank,
                                    timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=timeout)
        _state = _World(rank, size, local_rank,
                        _env_int("HVT_LOCAL_SIZE", 1),
                        _env_int("HVT_CROSS_RANK", 0),
                        _env_int("HVT_CROSS_SIZE", 1), dev)
        from horovod_tpu_torch.common.process_sets import \
            global_process_set

        global_process_set.process_set_id = 0
        _state.process_sets[0] = global_process_set


def shutdown():
    """Destroy the process group and every process set's group; a later
    ``init`` starts a new world with only the global set."""
    global _state
    with _lock:
        if _state is None:
            return
        for ps in _state.process_sets.values():
            ps.process_set_id, ps._group = None, None
        dist.destroy_process_group()
        _state = None


def is_initialized() -> bool:
    return _state is not None


def _world() -> _World:
    if _state is None:
        raise ValueError("horovod_tpu_torch has not been initialized; run "
                         "hvt.init() first.")
    return _state


def rank() -> int:
    return _world().rank


def size() -> int:
    return _world().size


def local_rank() -> int:
    return _world().local_rank


def local_size() -> int:
    return _world().local_size


def cross_rank() -> int:
    return _world().cross_rank


def cross_size() -> int:
    return _world().cross_size


def device() -> torch.device:
    """The device this process's collectives run on."""
    return _world().device


def process_rank() -> int:
    """This process's index: :func:`rank`, since one process drives one
    GPU (in the JAX package a process drives a host's chips)."""
    return rank()


def process_size() -> int:
    """The number of processes: :func:`size`."""
    return size()


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes: an
    allgather of each process's ``local_size``, so every process calls
    it."""
    from horovod_tpu_torch.ops.collective_ops import allgather

    sizes = allgather(torch.tensor([local_size()], device=device()))
    return len(set(sizes.tolist())) == 1


# What this build can do (Horovod's ``basics.py:216-258``): the data plane is
# torch.distributed, NCCL on the GPU and gloo on the CPU.

def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    return gloo_built()


def mpi_built() -> bool:
    return dist.is_mpi_available()


def mpi_enabled() -> bool:
    """MPI is never the port's controller: processes join on a TCP store."""
    return False


def mpi_threads_supported() -> bool:
    return False


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def xla_built() -> bool:
    return False
