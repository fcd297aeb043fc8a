"""Launch the bitonic merge CUDA kernel (``csrc/merge_runs.cu``).

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
MAX_T = 8192  # a merged row lives in shared memory: 2T keys + 2T payloads of 4 bytes
KEY_TYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}


def build() -> ctypes._CFuncPtr:
    """Compile (if not yet built) and load the kernel's entry point; raises on failure."""
    return load(SOURCE, "merge_runs_launch", ARGTYPES)


def merge_runs_cuda(
    a_keys: torch.Tensor, b_keys: torch.Tensor, a_vals: torch.Tensor, b_vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: (G,T) x 4 -> (G,2T) keys, payloads.

    Keys are int32, uint32 or float32, ascending per row; payloads any 32-bit
    dtype; all four contiguous on one CUDA device.  Any G >= 1; T a power of
    two up to ``MAX_T``.  The order of payloads among equal keys is left open.
    """
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
    if not 1 <= g < 2**31 or t < 1 or t & (t - 1) or t > MAX_T:
        raise ValueError(
            f"merge_runs_cuda: needs G >= 1 and T a power of two up to {MAX_T} (a merged row lives in "
            f"shared memory); got G={g} T={t}"
        )
    out_k = torch.empty((g, 2 * t), dtype=a_keys.dtype, device=a_keys.device)
    out_v = torch.empty((g, 2 * t), dtype=a_vals.dtype, device=a_keys.device)
    launch = build()
    stream = torch.cuda.current_stream(a_keys.device).cuda_stream
    rc = launch(
        a_keys.data_ptr(), b_keys.data_ptr(), a_vals.data_ptr(), b_vals.data_ptr(),
        out_k.data_ptr(), out_v.data_ptr(), g, t, KEY_TYPES[a_keys.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"merge_runs_cuda: launch failed with cudaError {rc}")
    return out_k, out_v
