"""Checkpoint manager: nested dicts of tensors <-> LogStructuredCheckpointer.

The tree is nested dicts whose leaves are tensors or numpy arrays; a trainer
saves ``{"params": dict(model.named_parameters()), "opt": opt_state}``.  Keys
are ``<tensor path>@<slice spec>`` (:func:`_idx` — per-dim ``start-stop``
joined by ``_``, or ``scalar``/``full``), as in the reference: a tensor is
one whole shard, keyed as the reference keys a single-device ``jax.Array``
(``0-end`` per dim, ``scalar`` when 0-d), and a numpy leaf ``full``.  So the
same tree saved by either package leaves byte-identical directories, and
each restores the other's.  Each process saves under ``host-<rank>``, the
``torch.distributed`` rank (0 without a process group).  A leaf numpy cannot
hold (bfloat16) is refused, never cast.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.layers import _device

from .store import LogStructuredCheckpointer


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in the reference's pytree order: dict keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _host_id() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise TypeError("CheckpointManager: numpy cannot hold a bfloat16 leaf; cast it before saving")
    return t.detach().cpu().numpy()


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            raise TypeError("CheckpointManager: numpy cannot hold a bfloat16 leaf")
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, mode: str = "hybrid", consolidate_every: int = 8):
        self.host_id = _host_id()
        self.store = LogStructuredCheckpointer(
            os.path.join(directory, f"host-{self.host_id}"),
            mode=mode,
            consolidate_every=consolidate_every,
        )

    def save(self, step: int, tree: Any, *, changed: set[str] | None = None) -> dict:
        flat: dict[str, np.ndarray] = {}
        for path, leaf in _flatten(tree):
            key = _path_str(path)
            if isinstance(leaf, torch.Tensor):
                flat[f"{key}@{_idx(leaf)}"] = _numpy(leaf)
            else:
                flat[f"{key}@full"] = np.asarray(leaf)
        return self.store.save(step, flat, changed=changed)

    def restore(self, like: Any, *, device=None) -> tuple[Any, int]:
        """Rebuild a tree shaped like ``like`` from disk.

        ``like``'s leaves may be tensors, meta tensors or anything with
        ``.shape`` and ``.dtype``.  Each restored leaf is a tensor on its
        ``like`` leaf's device where that is a real tensor, else on ``device``
        (None: the card).
        """
        flat, step = self.store.restore()
        grouped: dict[str, dict[str, np.ndarray]] = {}
        for k, v in flat.items():
            base, _, shard = k.rpartition("@")
            grouped.setdefault(base, {})[shard] = v

        def rebuild(tree, path):
            if isinstance(tree, dict):
                return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
            key = _path_str(path)
            parts = grouped.get(key)
            if parts is None:
                raise KeyError(f"checkpoint missing {key}")
            arr = _assemble(parts, tuple(tree.shape), _numpy_dtype(tree.dtype))
            real = isinstance(tree, torch.Tensor) and not tree.is_meta
            return torch.from_numpy(arr).to(tree.device if real else _device(device))

        return rebuild(like, ()), step

    def stats(self) -> dict:
        return {
            "write_amplification": self.store.write_amplification(),
            "space_bytes": self.store.space_bytes(),
            "device": self.store.device.stats.__dict__,
        }


def _idx(t: torch.Tensor) -> str:
    """The slice spec of a whole, unsharded tensor: ``0-end`` per dim, ``scalar`` when 0-d."""
    return "_".join("0-end" for _ in t.shape) or "scalar"


def _assemble(parts: dict[str, np.ndarray], shape, dtype) -> np.ndarray:
    """Reassemble one tensor from its shard parts, verifying full coverage.

    Part keys are the canonical slice specs from :func:`_idx` (the whole
    post-``@`` token — per-dim ``start-stop`` specs joined by ``_``, or
    ``scalar`` for 0-d).  Every element must be covered by some part:
    zero-filling a gap would silently restore a missing shard as zeros, so
    incomplete coverage raises instead.
    """
    if "full" in parts:
        return parts["full"].astype(dtype).reshape(shape)
    out = np.zeros(shape, dtype)
    covered = np.zeros(shape, dtype=bool)
    for key, chunk in parts.items():
        slices = []
        for dim, spec in zip(range(len(shape)), key.split("_")):
            start_s, _, stop_s = spec.partition("-")
            start = int(start_s)
            stop = shape[dim] if stop_s == "end" else int(stop_s)
            slices.append(slice(start, stop))
        out[tuple(slices)] = chunk.reshape(out[tuple(slices)].shape)
        covered[tuple(slices)] = True
    if not covered.all():
        missing = int(covered.size - covered.sum())
        raise RuntimeError(
            f"checkpoint incomplete: shard parts {sorted(parts)} leave "
            f"{missing} of {covered.size} elements uncovered for shape {tuple(shape)}"
        )
    return out
