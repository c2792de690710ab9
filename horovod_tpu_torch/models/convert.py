"""Carry weights between the JAX package's flax trees and the port's
``state_dict``: the GPT's params, and the vision models' params and
``batch_stats`` (:func:`vision_state_from_flax`,
:func:`vision_state_to_flax`).

The flax tree is taken as nested dicts of arrays (anything ``np.asarray``
reads, so no JAX is needed here). Layouts are kept exactly: the port stores
every kernel in its flax layout (``q``/``k``/``v`` ``(d_model, heads,
head_dim)``, ``o`` ``(heads, head_dim, d_model)``, ``up``/``down``
``(in, out)``), so only the names change::

    embedding                    ↔ embedding
    block_{i}/attn/q/kernel      ↔ blocks.{i}.attn.q
    block_{i}/ln1/scale          ↔ blocks.{i}.ln1.scale
    ln_f/scale                   ↔ ln_f.scale
    router_block/router/kernel   ↔ router_block.router   (MoEMlp)
    wi, wo                       ↔ wi, wo                (MoEMlp)
    w, b (stacked stages)        ↔ w, b

:func:`shard_state_dict` and :func:`gather_state_dict` compose with that
mapping: a spec (``{name: tuple}``, one entry per dim, an axis name on a
sharded dim; ``param_partition_spec``, ``moe_param_partition_spec``,
``stage_partition_spec``) says which dims a mesh axis splits.

The vision models (``models/resnet.py``, ``models/vision.py``) name their
submodules as flax does, so a path maps to a name by joining it with dots;
only the leaves and the layouts change::

    .../kernel  (kh, kw, in, out)  ↔  .../weight  [out, in, kh, kw]   (conv)
    .../kernel  (in, out)          ↔  .../weight  [out, in]           (dense)
    .../scale                      ↔  .../weight                      (norm)
    .../bias                       ↔  .../bias
    batch_stats .../mean, var      ↔  .../running_mean, running_var
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_BLOCK = "block_"


def _torch_name(path):
    parts = list(path)
    if parts[-1] == "kernel":
        parts.pop()
    if parts[0].startswith(_BLOCK):
        parts[0:1] = ["blocks", parts[0][len(_BLOCK):]]
    return ".".join(parts)


def flax_path(name):
    """A ``state_dict`` name → its flax params path, as a list of keys."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts[0:2] = [_BLOCK + parts[1]]
    if len(parts) > 1 and parts[-1] != "scale":
        parts.append("kernel")
    return parts


def params_from_flax(params) -> dict:
    """flax params tree → the port's ``state_dict`` (fp32 CPU tensors)."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
            else:
                out[_torch_name(path + (key,))] = torch.from_numpy(
                    np.array(value, dtype=np.float32))

    walk(params, ())
    return out


def params_to_flax(state_dict) -> dict:
    """The port's ``state_dict`` → flax params tree of fp32 numpy arrays."""
    tree = {}
    for name, tensor in state_dict.items():
        *parents, leaf = flax_path(name)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tensor.detach().float().cpu().numpy()
    return tree


def shard_state_dict(state_dict, specs, axis_sizes, coords) -> dict:
    """This rank's shard of each tensor: along every dim whose spec names
    an axis of ``axis_sizes`` (``{axis: size}``), the ``coords[axis]``-th
    of ``size`` equal blocks. Names missing from ``specs`` stay whole."""
    out = {}
    for name, t in state_dict.items():
        for dim, axis in enumerate(specs.get(name, ())):
            n = axis_sizes.get(axis, 1)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} "
                                 f"does not split into {n} over {axis}")
            t = t.chunk(n, dim=dim)[coords[axis]]
        out[name] = t.detach().clone()
    return out


def gather_state_dict(shards, specs, axis) -> dict:
    """The inverse of :func:`shard_state_dict` along one axis: ``shards``
    are the state_dicts of the axis's ranks, in axis order; each tensor
    whose spec names ``axis`` is concatenated along that dim, the others
    are taken from the first shard."""
    out = {}
    for name, first in shards[0].items():
        spec = specs.get(name, ())
        if axis in spec:
            out[name] = torch.cat([s[name] for s in shards],
                                  dim=spec.index(axis))
        else:
            out[name] = first
    return out


_VISION_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.array(value, dtype=np.float32)


def vision_state_from_flax(params, batch_stats=None) -> dict:
    """A vision model's flax ``params`` and ``batch_stats`` → the port's
    ``state_dict`` (fp32 CPU tensors; a SyncBatchNorm's
    ``num_batches_tracked`` is not among them)."""
    out = {}
    for tree in (params, batch_stats or {}):
        for (*mods, leaf), value in _leaves(tree):
            if leaf == "kernel":
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
                leaf = "weight"
            else:
                leaf = _VISION_LEAF[leaf]
            out[".".join(mods + [leaf])] = torch.from_numpy(
                np.ascontiguousarray(value))
    return out


def vision_state_to_flax(state_dict):
    """The port's vision ``state_dict`` → (flax ``params``, ``batch_stats``)
    trees of fp32 numpy arrays."""
    trees = ({}, {})
    back = {v: k for k, v in _VISION_LEAF.items()}
    for name, tensor in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        value = tensor.detach().float().cpu().numpy()
        if leaf == "weight" and value.ndim > 1:
            value = (value.transpose(2, 3, 1, 0) if value.ndim == 4
                     else value.T)
            leaf = "kernel"
        else:
            leaf = back[leaf]
        node = trees[leaf in ("mean", "var")]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(value)
    return trees
