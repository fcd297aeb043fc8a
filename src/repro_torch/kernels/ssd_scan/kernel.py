"""Launch the SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``).

``build()`` compiles the source with ``nvcc`` for ``sm_90a`` at the first
launch, through ``kernels/_nvcc.py``.  Importing this module needs no
compiler and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._nvcc import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
TILE = 16  # the kernel needs the chunk length to be a multiple of this


def build() -> ctypes._CFuncPtr:
    """Compile (if not yet built) and load the kernel's entry point; raises on failure."""
    return load(SOURCE, "ssd_scan_launch", ARGTYPES)


def ssd_scan_cuda(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
    *, chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream.  S % chunk == 0 and chunk % 16 == 0.

    Returns (y in x's dtype: (B,S,H,P), final_state float32: (B,H,P,N)).  In
    bfloat16 the kernel's four stages meet in a float32 workspace allocated
    here: C B^T per (batch, chunk, group), the state of each (batch, chunk,
    head) and cum = cumsum(dt a).
    """
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    tensors = {"x": x, "dt": dt, "a": a, "bmat": bmat, "cmat": cmat}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan_cuda: {name} must be on {x.device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_cuda: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan_cuda: x must be float32 or bfloat16, got {x.dtype}")
    if bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise ValueError("ssd_scan_cuda: bmat and cmat must have x's dtype")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("ssd_scan_cuda: dt and a must be float32")
    if (
        dt.shape != (b, s, h) or a.shape != (h,) or bmat.shape != (b, s, g, n)
        or cmat.shape != bmat.shape or h % g
    ):
        raise ValueError(
            f"ssd_scan_cuda: shapes x{tuple(x.shape)} dt{tuple(dt.shape)} a{tuple(a.shape)} "
            f"B{tuple(bmat.shape)} C{tuple(cmat.shape)} do not agree"
        )
    if chunk % TILE or s % chunk or p % 4 or n % 4:
        raise ValueError(
            f"ssd_scan_cuda: needs chunk % {TILE} == 0, S % chunk == 0, P % 4 == 0, N % 4 == 0; "
            f"got chunk={chunk} S={s} P={p} N={n}"
        )
    launch = build()
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    workspace = []  # held until the launch is enqueued; the float32 kernel takes none
    if x.dtype == torch.bfloat16:
        nc = s // chunk
        shapes = ((b, nc, g, chunk, chunk), (b, nc, h, p, n), (b, h, s))
        workspace = [torch.empty(sh, dtype=torch.float32, device=x.device) for sh in shapes]
    ptrs = [w.data_ptr() for w in workspace] or [None] * 3
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        y.data_ptr(), state.data_ptr(), *ptrs,
        b, s, h, p, g, n, chunk, int(x.dtype == torch.bfloat16), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd_scan_cuda: launch failed with cudaError {rc}")
    return y, state
