"""Checkpoint and resume on ``torch.distributed.checkpoint`` (the JAX
package's ``checkpoint.py``, which runs on orbax).

A state is a dict that may hold modules, optimizers, tensors (sharded
DTensors too), numpy arrays and Python values, nested in dicts. A module
with its optimizer is saved through ``get_state_dict``, so the optimizer's
state is keyed by parameter names and a module sharded by
``parallel.fsdp.shard_module`` saves each rank's shards; the same sharding
restores them. Every rank writes its own files into a step's directory, so
the directory is on storage that every rank sees.

Usage::

    mgr = hvt.checkpoint.CheckpointManager("/ckpts", max_to_keep=3)
    mgr.save(step, {"model": model, "optim": opt, "step": step})
    mgr.wait()
    state = mgr.restore_latest(template={"model": model, "optim": opt,
                                         "step": 0})

``restore`` loads modules and optimizers in place and returns the state:
the template's modules and optimizers, and new values for its other
leaves. With ``broadcast`` (the default) the leaves that are not sharded
are broadcast from ``root_rank`` afterwards, as the JAX package broadcasts
a restore (``checkpoint.py:105-114``); outside an initialized job of more
than one process that is a no-op.

The manager keeps the JAX package's bookkeeping (orbax's rules): a step is
saved when it is after the latest and a multiple of
``save_interval_steps``, or when nothing is saved yet, or with ``force``;
``max_to_keep`` removes the oldest steps once the newer save is durable.
With ``async_save`` a save copies the state to host memory, then writes in
a thread; the next ``save``, ``wait``, ``restore`` or ``close`` waits for
it. The copy is taken before ``save`` returns, so training may go on at
once, but eagerly: the copy must not overlap a CUDA graph replaying into
the same parameters.

Collectives: in a process group the checkpoint runs on a gloo group of
every rank of its own (``dcp.async_save`` needs a CPU backend, and its
thread must not share a group with training's collectives), created once
for each world, by its first manager or one-shot call, however
``torch.distributed`` was started; every rank makes the same calls in the
same order.
"""

from __future__ import annotations

import os
import shutil
import weakref
from collections.abc import Mapping

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics

_METADATA = ".metadata"


# the default process group -> the checkpoints' gloo group of that world
_GROUPS = weakref.WeakKeyDictionary()


def _group():
    """The gloo group of every rank that checkpoints coordinate on (its own,
    so an async save's thread never shares a group with training's
    collectives), or None outside a process group. Made once for each
    default process group, however ``torch.distributed`` was started."""
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    if world not in _GROUPS:
        _GROUPS[world] = dist.new_group(backend="gloo")
    return _GROUPS[world]


def _is_root():
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier(group):
    if group is not None:
        dist.barrier(group=group)


def _walk(tree, path=()):
    """(path, leaf) of every leaf of nested dicts, in order."""
    if isinstance(tree, Mapping) and not isinstance(tree, torch.nn.Module):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_structure(tree):
    if isinstance(tree, Mapping) and not isinstance(tree, torch.nn.Module):
        return {k: _copy_structure(v) for k, v in tree.items()}
    return tree


def _owners(state):
    """``{path of a module: path of its optimizer}``; raises when an
    optimizer's module is missing or a module has two."""
    leaves = list(_walk(state))
    modules = [(p, m) for p, m in leaves if isinstance(m, torch.nn.Module)]
    owners = {}
    for path, opt in leaves:
        if not isinstance(opt, torch.optim.Optimizer):
            continue
        first = next(p for g in opt.param_groups for p in g["params"])
        found = [mp for mp, m in modules
                 if any(first is p for p in m.parameters())]
        if not found:
            raise ValueError(f"the optimizer at {'/'.join(map(str, path))} "
                             "needs its module in the same state")
        if found[0] in owners:
            raise ValueError("a module may have one optimizer in a state")
        owners[found[0]] = path
    return owners


def _state_dict(state, template=False):
    """The state as DCP's nested dict: each module (with its optimizer) as
    its state dict through ``get_state_dict``. A template's other tensors
    are replaced by empty ones of the same layout, so loading does not
    overwrite the caller's."""
    from torch.distributed.checkpoint.state_dict import (get_model_state_dict,
                                                         get_state_dict)

    if not isinstance(state, Mapping):
        raise TypeError("a checkpoint state is a dict")
    owners = _owners(state)
    out = _copy_structure(state)
    for path, leaf in _walk(state):
        if isinstance(leaf, torch.nn.Module):
            if path in owners:
                model_sd, optim_sd = get_state_dict(
                    leaf, _get(state, owners[path]))
                _set(out, owners[path], optim_sd)
            else:
                model_sd = get_model_state_dict(leaf)
            _set(out, path, model_sd)
        elif template and torch.is_tensor(leaf):
            _set(out, path, torch.empty_like(leaf))
    return out, owners


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _broadcast(flat_tree, root_rank):
    """Broadcast every leaf that is not a sharded DTensor from
    ``root_rank``, in place where it is a tensor."""
    from torch.distributed.tensor import DTensor

    from horovod_tpu_torch.ops.functions import (broadcast_object,
                                                 broadcast_parameters)

    if not basics.is_initialized() or basics.size() <= 1:
        return
    leaves = list(_walk(flat_tree))
    tensors = [(p, t) for p, t in leaves
               if torch.is_tensor(t) and not isinstance(t, DTensor)]
    on_device = {i: t if t.device == basics.device()
                 else t.to(basics.device())
                 for i, (_, t) in enumerate(tensors)}
    broadcast_parameters(on_device, root_rank=root_rank)
    for i, (_, t) in enumerate(tensors):
        if on_device[i] is not t:
            t.copy_(on_device[i])
    others = [(p, v) for p, v in leaves if not torch.is_tensor(v)]
    values = broadcast_object([v for _, v in others], root_rank=root_rank)
    for (path, _), value in zip(others, values):
        _set(flat_tree, path, value)


def _template_from_metadata(path):
    """A nested dict of empty CPU tensors (and None for pickled values)
    shaped as the checkpoint at ``path`` was saved."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(path).read_metadata()
    tree = {}
    for fqn, md in meta.state_dict_metadata.items():
        *parents, last = meta.planner_data[fqn]
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = (torch.empty(md.size, dtype=md.properties.dtype)
                      if isinstance(md, TensorStorageMetadata) else None)
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 (a saved list's items) back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _save(path, state, group, async_save):
    import torch.distributed.checkpoint as dcp

    sd, _ = _state_dict(state)
    if async_save:
        return dcp.async_save(sd, checkpoint_id=path, process_group=group,
                              no_dist=group is None)
    dcp.save(sd, checkpoint_id=path, process_group=group,
             no_dist=group is None)
    return None


def _restore(path, template, broadcast, root_rank, group):
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import (set_model_state_dict,
                                                         set_state_dict)

    if template is None:
        sd, owners = _template_from_metadata(path), {}
    else:
        sd, owners = _state_dict(template, template=True)
    dcp.load(sd, checkpoint_id=path, process_group=group,
             no_dist=group is None)
    if broadcast:
        _broadcast(sd, root_rank)
    if template is None:
        return sd
    out = _copy_structure(template)
    for p, leaf in _walk(template):
        if isinstance(leaf, torch.nn.Module):
            if p in owners:
                set_state_dict(leaf, _get(template, owners[p]),
                               model_state_dict=_get(sd, p),
                               optim_state_dict=_get(sd, owners[p]))
            else:
                set_model_state_dict(leaf, _get(sd, p))
        elif not isinstance(leaf, torch.optim.Optimizer):
            _set(out, p, _get(sd, p))
    return out


def _wait(future):
    """Block on what ``dcp.async_save`` returned (a Future, or a response
    whose upload completes last)."""
    upload = getattr(future, "upload_completion", future)
    upload.result()


class CheckpointManager:
    """Steps saved under ``directory/<step>`` with orbax's bookkeeping (the
    JAX package's ``CheckpointManager``): ``save``, ``wait``,
    ``latest_step``, ``all_steps``, ``restore``, ``restore_latest`` and
    ``close``. Every rank constructs it and makes the same calls."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self._group = _group()
        self._steps = sorted(
            int(d) for d in os.listdir(self.directory) if d.isdigit()
            and os.path.exists(os.path.join(self.directory, d, _METADATA)))
        self._pending = None        # the in-flight async save
        self._to_remove = []        # steps deleted once it is durable

    def _path(self, step):
        return os.path.join(self.directory, str(step))

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` at ``step`` if the bookkeeping says so (or
        ``force``); returns whether it did. Waits for the previous async
        save first. Saving a step that exists raises ``ValueError``."""
        if not force and not self.should_save(step):
            return False
        self.wait()
        if step in self._steps:
            raise ValueError(f"Checkpoint for step {step} already exists.")
        self._steps.append(step)
        self._steps.sort()
        if self.max_to_keep and len(self._steps) > self.max_to_keep:
            self._to_remove = self._steps[:-self.max_to_keep]
            self._steps = self._steps[-self.max_to_keep:]
        self._pending = _save(self._path(step), state, self._group,
                              self.async_save)
        if self._pending is None:
            self._finish()
        return True

    def _finish(self):
        if self._pending is not None:
            future, self._pending = self._pending, None
            _wait(future)
        if self._to_remove:
            if _is_root():
                for step in self._to_remove:
                    shutil.rmtree(self._path(step), ignore_errors=True)
            self._to_remove = []
            _barrier(self._group)

    def wait(self):
        """Block until every save is durable and the retention applied."""
        self._finish()

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def all_steps(self):
        return list(self._steps)

    def restore(self, step: int, template=None, broadcast: bool = True,
                root_rank: int = 0):
        """The state saved at ``step``. With a ``template`` (a state of the
        same structure) its modules and optimizers are loaded in place and
        its other leaves come back as the template's types and layouts;
        without one, nested dicts of CPU tensors and the saved Python
        values."""
        self.wait()
        return _restore(self._path(step), template, broadcast, root_rank,
                        self._group)

    def restore_latest(self, template=None, broadcast: bool = True,
                       root_rank: int = 0):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template=template, broadcast=broadcast,
                            root_rank=root_rank)

    def close(self):
        self.wait()


def save(path: str, state):
    """One synchronous save into ``path``, replacing what is there."""
    path = os.path.abspath(path)
    group = _group()
    if _is_root() and os.path.exists(path):
        shutil.rmtree(path)
    _barrier(group)
    _save(path, state, group, async_save=False)


def restore(path: str, template=None, broadcast: bool = True,
            root_rank: int = 0):
    """One restore from ``path``, as :meth:`CheckpointManager.restore`."""
    return _restore(os.path.abspath(path), template, broadcast, root_rank,
                    _group())
