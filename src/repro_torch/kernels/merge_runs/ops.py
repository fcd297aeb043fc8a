"""Dispatchers for the compaction merge.

``merge_tiles`` merges row-paired sorted tiles.  A CPU tensor runs the plain
PyTorch reference; a CUDA tensor runs the CUDA kernel or raises: there is no
fallback.  ``LAUNCHES`` counts kernel launches made here, so a run can show
that its path went through the kernel.

``merge_sorted_runs`` merges two whole sorted runs in plain PyTorch, as the
reference's does in plain jnp: despite the reference's docstring, it ranks
and scatters and never runs the kernel.  The store's own compaction merges in
Python (``core/lsm.py::merge_runs``) and calls neither, as in the reference.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import merge_runs_ref, sort_key, words

LAUNCHES = 0


def merge_tiles(a_keys, b_keys, a_vals, b_vals, *, impl: str = "auto", block_rows: int = 8):
    """Merge row-paired sorted tiles: (G,T)+(G,T) -> (G,2T).

    ``impl="auto"`` runs the kernel on CUDA tensors and the plain version on
    CPU tensors; ``impl="cuda"`` (the reference's ``"pallas"``) runs the
    kernel and raises on CPU tensors.  ``block_rows`` is the TPU kernel's row
    group; it must be >= 1 and changes no result.
    """
    global LAUNCHES
    if impl not in ("auto", "cuda"):
        raise ValueError(f"merge_tiles: impl must be 'auto' or 'cuda', got {impl!r}")
    if block_rows < 1:
        raise ValueError(f"merge_tiles: block_rows must be >= 1, got {block_rows}")
    if impl == "auto" and a_keys.device.type == "cpu":
        return merge_runs_ref(a_keys, b_keys, a_vals, b_vals)
    out = kernel.merge_runs_cuda(a_keys.contiguous(), b_keys.contiguous(), a_vals.contiguous(), b_vals.contiguous())
    LAUNCHES += 1
    return out


def merge_sorted_runs(a_keys, b_keys, *, impl: str = "auto"):
    """Merge two sorted 1-D uint32/int32 runs; returns (keys, source_flags).

    source_flags[i] = 0 if the element came from run A else 1 (the payload the
    LSM compaction needs to dereference the winning entry); A comes first on
    equal keys.  Every element is ranked in the other run (A with
    ``side="left"``, B with ``side="right"``) and scattered to its output
    position.  ``impl`` is accepted for the reference's signature and unused,
    as there.
    """
    na, nb = a_keys.shape[0], b_keys.shape[0]
    dev = a_keys.device
    ka, kb = sort_key(a_keys), sort_key(b_keys)
    pos_a = torch.arange(na, device=dev) + torch.searchsorted(kb, ka, side="left")
    pos_b = torch.arange(nb, device=dev) + torch.searchsorted(ka, kb, side="right")
    out_k = torch.zeros(na + nb, dtype=torch.int32, device=dev)
    out_v = torch.zeros(na + nb, dtype=torch.int32, device=dev)
    out_k[pos_a] = words(a_keys)
    out_k[pos_b] = words(b_keys)
    out_v[pos_b] = 1
    return out_k.view(a_keys.dtype), out_v
