"""Carry the reference's params across: its param tree into the port's modules.

``tree`` is the reference's nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``).  Stacked leaves under ``layers`` have
the layer index as their leading axis: ``layers/ssm/wz[i]`` fills
``layers.{i}.ssm.wz`` and ``layers/attn/wq[i]`` fills ``layers.{i}.attn.wq``.
Every other leaf maps by its path, with ``/`` for ``.`` (``embedding/embed``,
``final_norm/scale``).  With tied embeddings neither side has ``unembed``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def _port_leaves(tree) -> dict[str, np.ndarray]:
    leaves: dict[str, np.ndarray] = {}
    for path, arr in _flatten(tree).items():
        if path.startswith("layers/"):
            rest = path[len("layers/"):].replace("/", ".")
            for i in range(arr.shape[0]):
                leaves[f"layers.{i}.{rest}"] = arr[i]
        else:
            leaves[path.replace("/", ".")] = arr
    return leaves


@torch.no_grad()
def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy every leaf into ``model``; raises on a missing, left-over or misshapen leaf."""
    leaves = _port_leaves(tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"load_jax_params: missing {missing}, left over {extra}")
    for name, arr in leaves.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_params: {name} has shape {arr.shape}, port has {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr)))
    return model
