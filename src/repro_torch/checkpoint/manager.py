"""Sharded checkpoint manager: nested dicts of tensors <-> LogStructuredCheckpointer.

The tree is nested dicts whose leaves are tensors, DTensors or numpy arrays;
a trainer saves ``{"params": dict(model.named_parameters()), "opt":
opt_state}``.  Keys are ``<tensor path>@<slice spec>`` (:func:`_idx` —
per-dim ``start-stop`` joined by ``_``, or ``scalar``/``full``), as in the
reference:

- a DTensor leaf is saved as its local shard, keyed by the shard's region of
  the global tensor (``0-end`` on a dim it is not split on), as the
  reference keys each of a ``jax.Array``'s ``addressable_shards``; replicas
  of one region share one key;
- a plain tensor is one whole shard, keyed as the reference keys a
  single-device ``jax.Array`` (``0-end`` per dim, ``scalar`` when 0-d);
- a numpy leaf is keyed ``full``.

So the same tree saved by either package leaves byte-identical directories,
and each restores the other's.  A bfloat16 leaf is written as its raw 16-bit
words under the header dtype ``bfloat16`` (``store.BF16_WORDS``), the bytes
the reference writes for an ml_dtypes array.  Each process saves under
``host-<rank>``, its ``torch.distributed`` rank (0 without a process group).
Where a rank's own directory does not cover a leaf (a restore onto another
mesh), ``restore`` also reads the other ``host-*`` directories under the
same root; the reference reads its own host's only, since one host there
holds the shards of all its devices.
"""
from __future__ import annotations

import glob
import os
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.models.layers import _device

from .store import BF16_WORDS, LogStructuredCheckpointer


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
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return BF16_WORDS if dtype == torch.bfloat16 else torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _tensor(arr: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.int16).view(torch.bfloat16) if dtype == torch.bfloat16 else t


class CheckpointManager:
    def __init__(self, directory: str, *, mode: str = "hybrid", consolidate_every: int = 8):
        self.host_id = _host_id()
        self.root, self.mode = directory, mode
        self.store = LogStructuredCheckpointer(
            os.path.join(directory, f"host-{self.host_id}"),
            mode=mode,
            consolidate_every=consolidate_every,
        )

    def save(self, step: int, tree: Any, *, changed: set[str] | None = None) -> dict:
        flat: dict[str, np.ndarray] = {}
        for path, leaf in _flatten(tree):
            key = _path_str(path)
            if isinstance(leaf, DTensor):
                flat[f"{key}@{_idx(_region(leaf))}"] = _numpy(leaf.to_local())
            elif isinstance(leaf, torch.Tensor):
                flat[f"{key}@{_idx([None] * leaf.dim())}"] = _numpy(leaf)
            else:
                flat[f"{key}@full"] = np.asarray(leaf)
        return self.store.save(step, flat, changed=changed)

    def restore(self, like: Any, shardings: Any | None = None, *, device=None) -> tuple[Any, int]:
        """Rebuild a tree shaped like ``like`` from disk.

        ``like``'s leaves may be tensors, meta tensors, DTensors or anything
        with ``.shape`` and ``.dtype``.  ``shardings``, where given, is a tree
        of the same dicts whose leaves are ``rules.NamedSharding``s: each leaf
        comes back as a DTensor in its placements.  Otherwise each leaf is a
        tensor on its ``like`` leaf's device where that is a real tensor, else
        on ``device`` (None: the card).
        """
        flat, step = self.store.restore()
        grouped = _group(flat)
        every_host: dict[str, dict[str, np.ndarray]] | None = None

        def rebuild(tree, path, sharding):
            nonlocal every_host, step
            if isinstance(tree, dict):
                return {k: rebuild(v, path + (k,), sharding[k] if sharding is not None else None)
                        for k, v in tree.items()}
            key = _path_str(path)
            shape, dtype = tuple(tree.shape), _numpy_dtype(tree.dtype)
            try:
                arr = _assemble(_parts(grouped, key, dtype), shape, dtype)
            except (KeyError, RuntimeError):  # this host's shards do not cover the leaf
                if every_host is None:
                    every_host, step = self._every_host(grouped, step)
                arr = _assemble(_parts(every_host, key, dtype), shape, dtype)
            t = _tensor(arr, tree.dtype)
            if sharding is not None:
                return distribute_tensor(t.to(sharding.mesh.device_type), sharding.mesh, sharding.placements,
                                         src_data_rank=None)
            if isinstance(tree, DTensor):
                return distribute_tensor(t.to(tree.device), tree.device_mesh, tree.placements, src_data_rank=None)
            real = isinstance(tree, torch.Tensor) and not tree.is_meta
            return t.to(tree.device if real else _device(device))

        return rebuild(like, (), shardings), step

    def _every_host(self, own: dict[str, dict[str, np.ndarray]], step: int) -> tuple[dict, int]:
        """The parts of every ``host-*`` directory under the root (this host's ``own``
        among them), and their step: every directory that holds a checkpoint must
        hold the same step."""
        merged: dict[str, dict[str, np.ndarray]] = {}
        steps = {self.store.dir: step} if own else {}
        for d in sorted(glob.glob(os.path.join(self.root, "host-*"))):
            if os.path.samefile(d, self.store.dir):
                continue
            flat, host_step = LogStructuredCheckpointer(d, mode=self.mode).restore()
            if flat:
                steps[d] = host_step
            for base, parts in _group(flat).items():
                merged.setdefault(base, {}).update(parts)
        if len(set(steps.values())) > 1:
            raise RuntimeError(f"checkpoint hosts disagree on the step: {steps}")
        for base, parts in own.items():
            merged.setdefault(base, {}).update(parts)
        return merged, next(iter(steps.values()), step)

    def stats(self) -> dict:
        return {
            "write_amplification": self.store.write_amplification(),
            "space_bytes": self.store.space_bytes(),
            "device": self.store.device.stats.__dict__,
        }


def _group(flat: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    grouped: dict[str, dict[str, np.ndarray]] = {}
    for k, v in flat.items():
        base, _, shard = k.rpartition("@")
        grouped.setdefault(base, {})[shard] = v
    return grouped


def _parts(grouped: dict, key: str, dtype: np.dtype) -> dict[str, np.ndarray]:
    """``key``'s saved parts; a leaf saved as bfloat16 words restores only as bfloat16, and the reverse."""
    parts = grouped.get(key)
    if not parts:
        raise KeyError(f"checkpoint missing {key}")
    if any((p.dtype.metadata or {}) != (dtype.metadata or {}) for p in parts.values()):
        raise TypeError(f"checkpoint {key}: saved as {[str(p.dtype) for p in parts.values()]}, restoring as {dtype}")
    return parts


def _region(t: DTensor) -> list[tuple[int, int] | None]:
    """This rank's region of ``t`` per dim: (start, stop), or None where no mesh dim splits it.

    Mesh dims split a tensor dim in mesh order (``torch.chunk``'s split), the
    order a tuple of axes means in a ``PartitionSpec``.
    """
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    region: list[tuple[int, int] | None] = [None] * t.dim()
    for mdim, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and mesh.size(mdim) > 1:  # one part is the whole dim, as in JAX
            lo, hi = region[pl.dim] or (0, t.shape[pl.dim])
            size = -(-(hi - lo) // mesh.size(mdim))
            start = min(lo + coord[mdim] * size, hi)
            region[pl.dim] = (start, min(start + size, hi))
    want = tuple(r[1] - r[0] if r else n for r, n in zip(region, t.shape))
    if tuple(t.to_local().shape) != want:
        raise RuntimeError(f"DTensor shard {tuple(t.to_local().shape)} is not the region {region} of {tuple(t.shape)}")
    return region


def _idx(region: list[tuple[int, int] | None]) -> str:
    """The slice spec of a region: ``start-stop`` per dim, ``0-end`` where it is whole, ``scalar`` when 0-d."""
    return "_".join(f"{r[0]}-{r[1]}" if r else "0-end" for r in region) or "scalar"


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
