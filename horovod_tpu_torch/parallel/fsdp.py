"""Fully-sharded data parallelism (FSDP / ZeRO-3) over a mesh's ``fsdp``
axis (the JAX package's ``parallel/fsdp.py``).

In the JAX package FSDP is a sharding annotation: each parameter shards its
largest divisible dim over the ``fsdp`` axis and XLA inserts the all-gather
before each use and the reduce-scatter after each gradient. Here PyTorch's
FSDP2 (``torch.distributed.fsdp.fully_shard``) runs that schedule, on a
``DeviceMesh`` built from the port's :class:`~.mesh.Mesh`:

- :func:`fsdp_partition_spec` is the JAX rule, as ``{name: dim or None}``;
- :func:`shard_module` shards a module by that map: one FSDP unit per
  transformer block, then the root (the GPT's tied embedding is used by
  the root's forward twice, so it is gathered once and its gradient is
  whole);
- :func:`init_sharded_state` gives Adam's moments the parameters' shards
  (ZeRO-1/2 falls out, as in the reference).

The map is the JAX rule; the placement differs for the leaves it keeps
replicated (None: fewer than ``min_shard_elements`` elements or no
divisible dim, as the RMSNorm scales). FSDP2 has no replicated placement,
so :func:`placement_dim` shards them on dim 0. That costs no collective:
FSDP2 gathers all of a unit's parameters in one all-gather, so a small
leaf adds bytes to it, not the latency the JAX rule avoids. Only a 0-d
leaf, which no ``Shard`` splits, stays whole outside FSDP
(``ignored_params``); its gradient is averaged over the data ranks (the
``dp`` × ``fsdp`` line) at the end of each backward pass, as FSDP averages
the sharded ones. On the GPU an optimizer over both kinds of parameter
needs ``foreach=False`` (PyTorch's foreach kernels do not mix DTensors and
tensors); the GPT has no 0-d parameter.

So the module's gradients are reduced already: train it with a plain
optimizer; ``DistributedOptimizer`` refuses its parameters.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import collective_ops as C

FSDP_AXIS = "fsdp"
DP_AXIS = "dp"


def fsdp_partition_spec(params, mesh, axis_name: str = FSDP_AXIS,
                        min_shard_elements: int = 1024):
    """``{name: dim}`` sharding each leaf's largest dim divisible by the
    size of ``mesh``'s ``axis_name`` over that axis, or ``{name: None}`` for
    a leaf that stays replicated: fewer than ``min_shard_elements``
    elements, or no divisible dim (the JAX function's ``PartitionSpec``
    rule, ``horovod_tpu/parallel/fsdp.py:30-56``). ``params`` is a module
    (its ``named_parameters()``) or a mapping of names to tensors."""
    return _spec_map(params, mesh.axis_size(axis_name), min_shard_elements)


def _spec_map(params, n, min_shard_elements):
    """:func:`fsdp_partition_spec` for an axis of ``n`` ranks."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    elif not isinstance(params, Mapping):
        raise TypeError("params must be a module or a mapping of tensors")

    def spec(shape):
        if int(np.prod(shape, dtype=np.int64)) < min_shard_elements:
            return None
        divisible = [i for i, d in enumerate(shape) if d % n == 0 and d >= n]
        return max(divisible, key=lambda i: shape[i]) if divisible else None

    return {name: spec(tuple(p.shape)) for name, p in params.items()}


def placement_dim(spec_dim, shape):
    """The dim FSDP2 shards a leaf on: the map's, or dim 0 for a leaf the
    map keeps replicated; None for a 0-d leaf, which stays whole."""
    if spec_dim is not None:
        return spec_dim
    return 0 if len(shape) else None


def device_mesh(mesh, axis_name: str = FSDP_AXIS):
    """The ``DeviceMesh`` of this rank's data lines on ``mesh``: 1-D over
    ``axis_name``, or 2-D ``(dp, fsdp)`` when the mesh has a ``dp`` axis of
    more than one rank (FSDP2 then shards over fsdp and replicates over
    dp, HSDP). Built on the mesh's own process-set groups, so shard *i* of
    a line is on the line's *i*-th rank, as on the JAX mesh. Other axes
    of more than one rank are refused."""
    from torch.distributed.device_mesh import DeviceMesh

    others = [a for a in mesh.axis_names
              if a not in (axis_name, DP_AXIS) and mesh.axis_size(a) > 1]
    if others:
        raise ValueError(f"shard_module takes a mesh of dp and {axis_name} "
                         f"only; {others} have more than one rank")
    kind = basics.device().type
    line = mesh.process_set(axis_name)
    if mesh.axis_size(DP_AXIS) == 1:
        return DeviceMesh.from_group(line.group(), kind,
                                     mesh=line.global_ranks(),
                                     mesh_dim_names=(axis_name,))
    data = mesh.process_set((DP_AXIS, axis_name))
    ranks = np.asarray(data.global_ranks()).reshape(
        mesh.axis_size(DP_AXIS), mesh.axis_size(axis_name))
    return DeviceMesh.from_group(
        [mesh.process_set(DP_AXIS).group(), line.group()], kind,
        mesh=ranks.tolist(), mesh_dim_names=(DP_AXIS, axis_name))


def _average_whole_grads(params, process_set):
    """At the end of every backward pass that reaches ``params``, average
    their gradients over ``process_set`` in one grouped allreduce; a
    parameter without a gradient takes part with zeros. The allreduce is
    queued behind FSDP's own end-of-backward callback, so on every rank
    it follows the reduce-scatters."""
    queued = [False]

    def sync():
        queued[0] = False
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        C.grouped_allreduce_([p.grad for p in params], op=C.Average,
                             process_set=process_set)

    def hook(_):
        if not queued[0]:
            queued[0] = True
            torch.autograd.Variable._execution_engine.queue_callback(sync)

    for p in params:
        p.register_post_accumulate_grad_hook(hook)


def shard_module(module, mesh, axis_name: str = FSDP_AXIS,
                 min_shard_elements: int = 1024):
    """Shard ``module``'s parameters over ``mesh``'s ``axis_name`` by
    :func:`fsdp_partition_spec` (the JAX package's ``shard_pytree``) and
    return it. Each entry of the module's ``blocks`` (the GPT's transformer
    blocks) becomes an FSDP unit of its own, gathered just before its
    forward and again before its backward; the root takes the rest.
    The module must already be on this process's device.

    Each rank feeds its own batch; FSDP averages the gradients over the
    data ranks (``fsdp``, and ``dp`` on a 2-D mesh), so the step is that of
    the batches' mean. Each leaf is sharded on :func:`placement_dim` of its
    map entry (module docstring). Every rank of the mesh calls this, in the
    same order."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    spec = fsdp_partition_spec(module, mesh, axis_name, min_shard_elements)
    dims, whole = {}, []
    for name, p in module.named_parameters():
        dim = placement_dim(spec[name], p.shape)
        if dim is None:
            whole.append(p)
        else:
            dims[id(p)] = dim
    dm = device_mesh(mesh, axis_name)

    def placement(param):
        return Shard(dims[id(param)])

    ignored = set(whole)
    for unit in getattr(module, "blocks", ()):
        fully_shard(unit, mesh=dm, shard_placement_fn=placement,
                    ignored_params=ignored & set(unit.parameters()))
    fully_shard(module, mesh=dm, shard_placement_fn=placement,
                ignored_params=ignored)
    for p in module.parameters():
        p._hvt_fsdp = True
    data = mesh.process_set((DP_AXIS, axis_name))
    if whole and data.size() > 1:
        _average_whole_grads(whole, data)
    return module


def init_sharded_state(optimizer):
    """Create an Adam or AdamW optimizer's state now, as a fresh one would
    hold it before its first step (zero moments, step 0), and return it.
    Over a module sharded by :func:`shard_module` each moment is a shard
    like its parameter's (the JAX package's ``init_sharded_state``: ZeRO-1/2
    falls out of ZeRO-3). Made by the optimizer's own step on zero
    gradients at lr 0 and weight decay 0, then zeroed, so the moments take
    its devices, dtypes and layouts."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError("init_sharded_state takes Adam or AdamW, whose "
                        "fresh state is zero moments and step 0")
    if optimizer.state:
        return optimizer.state
    saved = [(g["lr"], g["weight_decay"]) for g in optimizer.param_groups]
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    for group in optimizer.param_groups:
        group["lr"], group["weight_decay"] = 0.0, 0.0
    grads = [p.grad for p in params]
    try:
        for p in params:
            p.grad = torch.zeros_like(p)
        optimizer.step()
    finally:
        for group, (lr, wd) in zip(optimizer.param_groups, saved):
            group["lr"], group["weight_decay"] = lr, wd
        for p, g in zip(params, grads):
            p.grad = g
    with torch.no_grad():
        for state in optimizer.state.values():
            for value in state.values():
                if torch.is_tensor(value):
                    value.zero_()
    return optimizer.state
