"""Launch the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

One entry point takes both dtypes: bfloat16 runs the tensor-core kernel
(``wgmma``, K/V tiles by TMA, P carried as two bfloat16 terms), float32 the
CUDA-core kernel.  ``build()`` compiles the source with ``nvcc`` for
``sm_90a`` at the first launch, through ``kernels/_nvcc.py``.  Importing this
module needs no compiler and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._nvcc import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MAX_HEAD_DIM = 128


def build() -> ctypes._CFuncPtr:
    """Compile (if not yet built) and load the kernel's entry point; raises on failure."""
    return load(SOURCE, "flash_attention_launch", ARGTYPES)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream.  Any S; D % 8 == 0 and D <= 128.

    q: (B,S,H,D), k/v: (B,S,K,D) with H % K == 0, all float32 or all bfloat16,
    contiguous and 16-byte aligned.  Returns (B,S,H,D) in q's dtype.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    for name, t in {"q": q, "k": k, "v": v}.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be on {q.device} (CUDA), got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be contiguous and 16-byte aligned")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_cuda: q must be float32 or bfloat16, got dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda: k and v must have q's dtype")
    if k.shape != (b, s, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(
            f"flash_attention_cuda: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} do not agree"
        )
    if d % 8 or d > MAX_HEAD_DIM or window < 0:
        raise ValueError(
            f"flash_attention_cuda: needs head dim D % 8 == 0 and D <= {MAX_HEAD_DIM}, window >= 0; "
            f"got D={d} window={window}"
        )
    out = torch.empty_like(q)
    launch = build()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kh, d, window,
        d**-0.5, int(q.dtype == torch.bfloat16), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with cudaError {rc}")
    return out
