"""Launch the merge-path CUDA kernel (``csrc/merge_runs.cu``).

``build()`` compiles the source with ``nvcc`` for ``sm_90a`` at the first
launch, through ``kernels/_nvcc.py``.  Importing this module needs no
compiler and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._nvcc import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "merge_runs.cu"
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_T = 8192  # the largest T the kernel takes; T = 16384 is refused
KEY_TYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}


def build() -> ctypes._CFuncPtr:
    """Compile (if not yet built) and load the kernel's entry point; raises on failure."""
    return load(SOURCE, "merge_runs_launch", ARGTYPES)


def _refuse(a_keys, b_keys, a_vals, b_vals) -> None:
    """Raise the error that the first failed check of ``merge_runs_cuda`` names."""
    tensors = {"a_keys": a_keys, "b_keys": b_keys, "a_vals": a_vals, "b_vals": b_vals}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != a_keys.device:
            raise ValueError(f"merge_runs_cuda: {name} must be on {a_keys.device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"merge_runs_cuda: {name} must be contiguous")
        if t.dim() != 2 or t.shape != a_keys.shape:
            raise ValueError(f"merge_runs_cuda: {name} has shape {tuple(t.shape)}, expected a_keys' (G, T)")
    if a_keys.dtype not in KEY_TYPES or b_keys.dtype != a_keys.dtype:
        raise ValueError(
            f"merge_runs_cuda: keys must be int32, uint32 or float32 and alike, got {a_keys.dtype}, {b_keys.dtype}"
        )
    if a_vals.element_size() != 4 or b_vals.dtype != a_vals.dtype:
        raise ValueError(f"merge_runs_cuda: payloads must share one 32-bit dtype, got {a_vals.dtype}, {b_vals.dtype}")
    g, t = a_keys.shape
    raise ValueError(f"merge_runs_cuda: needs G >= 1 and T a power of two up to {MAX_T}; got G={g} T={t}")


def merge_runs_cuda(
    a_keys: torch.Tensor, b_keys: torch.Tensor, a_vals: torch.Tensor, b_vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: (G,T) x 4 -> (G,2T) keys, payloads.

    Keys are int32, uint32 or float32, ascending per row; payloads any 32-bit
    dtype; all four contiguous on one CUDA device.  Any G >= 1; T a power of
    two up to ``MAX_T``.  The merge is stable: equal keys keep A's entries
    before B's, each run in its own order, so the result equals
    ``ref.merge_runs_ref`` in place, payloads included.  The checks are folded
    into one test; ``_refuse`` names the one that failed.
    """
    shape, dev, key_dtype, val_dtype = a_keys.shape, a_keys.device, a_keys.dtype, a_vals.dtype
    key_type = KEY_TYPES.get(key_dtype)
    g, t = shape if len(shape) == 2 else (0, 0)
    if (
        key_type is None or b_keys.dtype != key_dtype or b_vals.dtype != val_dtype or a_vals.element_size() != 4
        or not a_keys.is_cuda or not b_keys.device == a_vals.device == b_vals.device == dev
        or not b_keys.shape == a_vals.shape == b_vals.shape == shape
        or not (a_keys.is_contiguous() and b_keys.is_contiguous() and a_vals.is_contiguous() and b_vals.is_contiguous())
        or not 1 <= g < 2**31 or t < 1 or t & (t - 1) or t > MAX_T
    ):
        _refuse(a_keys, b_keys, a_vals, b_vals)
    # keys, then payloads: one allocation of 32-bit words, typed as the keys
    # (``new_empty`` takes a_keys' dtype and device, a little faster than
    # ``torch.empty``); the payloads' half is viewed as their type where it differs
    out = a_keys.new_empty((2, g, 2 * t))
    base = out.data_ptr()
    rc = build()(
        a_keys.data_ptr(), b_keys.data_ptr(), a_vals.data_ptr(), b_vals.data_ptr(), base, base + 8 * g * t,
        g, t, key_type, torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if rc != 0:
        raise RuntimeError(f"merge_runs_cuda: launch failed with cudaError {rc}")
    out_k, out_v = out.unbind(0)
    return out_k, out_v if val_dtype == key_dtype else out_v.view(val_dtype)
