"""Carry GPT weights between the JAX package's flax params tree and the
port's ``state_dict``.

The flax tree is taken as nested dicts of arrays (anything ``np.asarray``
reads, so no JAX is needed here). Layouts are kept exactly: the port stores
every kernel in its flax layout (``q``/``k``/``v`` ``(d_model, heads,
head_dim)``, ``o`` ``(heads, head_dim, d_model)``, ``up``/``down``
``(in, out)``), so only the names change::

    embedding                    ↔ embedding
    block_{i}/attn/q/kernel      ↔ blocks.{i}.attn.q
    block_{i}/ln1/scale          ↔ blocks.{i}.ln1.scale
    ln_f/scale                   ↔ ln_f.scale
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
