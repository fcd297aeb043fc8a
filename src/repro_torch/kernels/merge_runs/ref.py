"""Plain PyTorch oracle for the compaction merge kernel: a stable sort of the
concatenation.

The reference's bar leaves the order among equal keys open (Parallax merges
runs of unique keys per level and resolves collisions by LSN before the
byte-level merge): given two ascending (G, T) key tiles with payloads,
produce the ascending (G, 2T) merged keys with the payloads moved along.
The port's kernel is a stable merge (equal keys keep A's entries before B's),
so it equals this oracle in place, payloads included.

PyTorch has few kernels for ``torch.uint32`` (no comparison, gather, scatter
or flip), so uint32 keys are ordered through an int64 copy, and keys and
payloads are concatenated and moved as raw 32-bit words (int32 views): no
uint32 kernel runs.  The CPU path of
``ops.merge_tiles`` runs this; on the card it is the CUDA kernel's yardstick.
"""
from __future__ import annotations

import torch


def sort_key(keys: torch.Tensor) -> torch.Tensor:
    """Keys in a dtype that PyTorch can compare: uint32 widened to int64
    (from its int32 view, sign bits masked off)."""
    if keys.dtype == torch.uint32:
        return words(keys).to(torch.int64) & 0xFFFFFFFF
    return keys


def words(t: torch.Tensor) -> torch.Tensor:
    """A 32-bit tensor's raw words, as an int32 view."""
    return t.view(torch.int32)


def merge_runs_ref(
    a_keys: torch.Tensor,  # (G, T) ascending per row
    b_keys: torch.Tensor,  # (G, T) ascending per row
    a_vals: torch.Tensor,  # (G, T) 32-bit payload (e.g. pointer/index)
    b_vals: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    keys = torch.cat([words(a_keys), words(b_keys)], dim=1)
    vals = torch.cat([words(a_vals), words(b_vals)], dim=1)
    order = torch.argsort(sort_key(keys.view(a_keys.dtype)), dim=1, stable=True)
    return (
        torch.take_along_dim(keys, order, dim=1).view(a_keys.dtype),
        torch.take_along_dim(vals, order, dim=1).view(a_vals.dtype),
    )
