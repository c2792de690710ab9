"""Object and parameter collectives (Horovod's ``torch/functions.py``; the
JAX package's ``ops/functions.py``). Objects travel pickled, as uint8
tensors on the process's device, through the port's own allgather and
broadcast: the sizes first, then the payload."""

from __future__ import annotations

import pickle
from collections.abc import Mapping
from typing import NamedTuple

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import collective_ops as C


def _serialize(obj) -> torch.Tensor:
    data = bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    return torch.frombuffer(data, dtype=torch.uint8).to(basics.device())


def _deserialize(payload: torch.Tensor):
    # only bytes that a rank of this job pickled reach here
    return pickle.loads(payload.cpu().numpy().tobytes())


def allgather_object(obj, name=None, process_set=C.global_process_set):
    """One picklable object from each member, as a list in rank order
    (``torch/functions.py:163``); the payloads may differ in size."""
    del name
    payload = _serialize(obj)
    sizes = C.allgather(torch.tensor([payload.numel()],
                                     device=payload.device),
                        process_set=process_set).tolist()
    gathered = C.allgather(payload, process_set=process_set)
    return [_deserialize(part) for part in gathered.split(sizes)]


def broadcast_object(obj=None, root_rank=0, name=None,
                     process_set=C.global_process_set):
    """``root_rank``'s picklable object on every member
    (``torch/functions.py:122``)."""
    del name
    root = basics.rank() == root_rank
    payload = _serialize(obj) if root else None
    size = torch.tensor([payload.numel() if root else 0],
                        device=basics.device())
    C.broadcast_(size, root_rank, process_set=process_set)
    if not root:
        payload = torch.empty(int(size), dtype=torch.uint8,
                              device=basics.device())
    return _deserialize(C.broadcast_(payload, root_rank,
                                     process_set=process_set))


def broadcast_object_fn(root_rank=0, name=None,
                        process_set=C.global_process_set):
    """``bcast(obj)`` with the root and set fixed up front
    (``torch/functions.py:155``)."""

    def _bcast(obj=None):
        return broadcast_object(obj, root_rank=root_rank, name=name,
                                process_set=process_set)

    return _bcast


def broadcast_parameters(params, root_rank=0,
                         process_set=C.global_process_set):
    """Overwrite every tensor of ``params`` in place with ``root_rank``'s,
    so all processes start identical (``torch/functions.py:32``).
    ``params`` is a ``state_dict()`` (broadcast in sorted key order) or
    ``(name, tensor)`` pairs such as ``named_parameters()``."""
    items = sorted(params.items()) if isinstance(params, Mapping) \
        else list(params)
    handles = []
    for name, p in items:
        if not torch.is_tensor(p):
            raise TypeError(f"broadcast_parameters: {name} is a "
                            f"{type(p).__name__}, not a tensor")
        handles.append(C.broadcast_async_(p.detach(), root_rank,
                                          process_set=process_set))
    for h in handles:
        C.synchronize(h)


def broadcast_variables(variables, root_rank=0,
                        process_set=C.global_process_set):
    """The JAX package's alias of :func:`broadcast_parameters`
    (``horovod_tpu/ops/functions.py:109``): overwrite ``variables`` (a state
    dict or ``(name, tensor)`` pairs) in place with ``root_rank``'s and
    return them, as the JAX function returns the broadcast tree."""
    broadcast_parameters(variables, root_rank=root_rank,
                         process_set=process_set)
    return variables


class _Leaf(NamedTuple):
    """A tensor of a state dict, as its structure is sent to other ranks."""

    index: int
    shape: tuple
    dtype: torch.dtype
    on_cpu: bool


def _map_tensors(tree, fn):
    """``tree`` with every tensor (or _Leaf) ``x`` replaced by ``fn(x)``;
    dicts, lists and tuples are walked in order."""
    if torch.is_tensor(tree) or isinstance(tree, _Leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def broadcast_optimizer_state(optimizer, root_rank=0,
                              process_set=C.global_process_set):
    """Load ``root_rank``'s optimizer ``state_dict()`` into ``optimizer`` on
    every other member (``torch/functions.py:59``): its per-parameter
    tensors and its hyperparameters. The structure travels as a pickled
    object, each tensor by a broadcast on the process's device."""
    root = basics.rank() == root_rank
    tensors = []

    def strip(t):
        tensors.append(t)
        return _Leaf(len(tensors) - 1, tuple(t.shape), t.dtype,
                     t.device.type == "cpu")

    skeleton = broadcast_object(
        _map_tensors(optimizer.state_dict(), strip) if root else None,
        root_rank, process_set=process_set)
    leaves = []
    _map_tensors(skeleton, leaves.append)
    bufs = [tensors[leaf.index].to(basics.device()).contiguous() if root
            else torch.empty(leaf.shape, dtype=leaf.dtype,
                             device=basics.device()) for leaf in leaves]
    handles = [C.broadcast_async_(b, root_rank, process_set=process_set)
               for b in bufs]
    for h in handles:
        C.synchronize(h)
    if not root:
        optimizer.load_state_dict(_map_tensors(
            skeleton, lambda leaf: bufs[leaf.index].cpu() if leaf.on_cpu
            else bufs[leaf.index]))
