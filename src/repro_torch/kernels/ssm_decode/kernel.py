"""Launch the Mamba2 decode-state CUDA kernel (``csrc/ssm_decode.cu``).

One pass over a layer's float32 state on the current stream: one block per
(tile of P rows, head, batch row) reads each state element once, writes the
new one into ``out`` (which may be the state itself) and sums y over N.  The
launch reads nothing back to the host, so a CUDA graph can hold it.
``build()`` compiles the source with ``nvcc`` for ``sm_90a`` at the first
launch, through ``kernels/_nvcc.py``.  Importing this module needs no
compiler and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._nvcc import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_decode.cu"
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
STATE_SIZES = (4, 8, 16, 32, 64, 128, 256)  # N: a row is N / 4 lanes' float4 (two each at 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # of x, B and C
MAX_GRID = 65535  # heads and batch rows: the grid's second and third dimensions


def build() -> ctypes._CFuncPtr:
    """Compile (if not yet built) and load the kernel's entry point; raises on failure."""
    return load(SOURCE, "ssm_decode_launch", ARGTYPES)


def ssm_decode_cuda(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bvec: torch.Tensor, cvec: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``out = state * exp(a * dt) + (dt * x) (x) B`` (head h reading group
    h // (H / G)) and return y (B, H, P) float32, the new state contracted with C over N.

    On one CUDA device: state and out (B, H, P, N) float32, contiguous, 16-byte aligned (``out``
    may be ``state``); x (B, H, P) with P contiguous, B and C (B, G, N) with N contiguous, all
    three float32 or bfloat16; dt (B, H) and a (H,) float32 contiguous.  N in ``STATE_SIZES``,
    H % G == 0, B and H up to ``MAX_GRID``.
    """
    for name, t in {"state": state, "x": x, "dt": dt, "a": a, "B": bvec, "C": cvec, "out": out}.items():
        if not t.is_cuda or t.device != state.device:
            raise ValueError(f"ssm_decode_cuda: {name} must be on {state.device} (CUDA), got {t.device}")
    b, h, p, n = state.shape if state.dim() == 4 else (0, 0, 0, 0)
    g = bvec.shape[1] if bvec.dim() == 3 else 0
    if (state.dim() != 4 or out.shape != state.shape or x.shape != (b, h, p) or dt.shape != (b, h)
            or a.shape != (h,) or bvec.shape != (b, g, n) or cvec.shape != bvec.shape):
        raise ValueError(f"ssm_decode_cuda: shapes state{tuple(state.shape)} out{tuple(out.shape)} x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} a{tuple(a.shape)} B{tuple(bvec.shape)} C{tuple(cvec.shape)} "
                         f"do not agree")
    if state.dtype != torch.float32 or out.dtype != torch.float32 or dt.dtype != torch.float32 \
            or a.dtype != torch.float32:
        raise ValueError(f"ssm_decode_cuda: state, out, dt and a must be float32, got {state.dtype}, "
                         f"{out.dtype}, {dt.dtype}, {a.dtype}")
    if x.dtype not in DTYPES or bvec.dtype != x.dtype or cvec.dtype != x.dtype:
        raise ValueError(f"ssm_decode_cuda: x, B and C must share float32 or bfloat16, got {x.dtype}, "
                         f"{bvec.dtype}, {cvec.dtype}")
    if not (state.is_contiguous() and out.is_contiguous() and dt.is_contiguous() and a.is_contiguous()) \
            or state.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("ssm_decode_cuda: state and out must be contiguous and 16-byte aligned, dt and a "
                         "contiguous")
    if x.stride(2) != 1 or bvec.stride(2) != 1 or cvec.stride(2) != 1:
        raise ValueError(f"ssm_decode_cuda: x, B and C need their last axis contiguous, got strides "
                         f"{x.stride()}, {bvec.stride()}, {cvec.stride()}")
    if n not in STATE_SIZES or p < 1 or g < 1 or h % g or not 0 < b <= MAX_GRID or not 0 < h <= MAX_GRID:
        raise ValueError(f"ssm_decode_cuda: needs N in {STATE_SIZES}, P > 0, H % G == 0, 0 < B, H <= {MAX_GRID}; "
                         f"got B={b} H={h} G={g} P={p} N={n}")
    y = torch.empty((b, h, p), dtype=torch.float32, device=state.device)
    rc = build()(
        state.data_ptr(), out.data_ptr(), x.data_ptr(), bvec.data_ptr(), cvec.data_ptr(), dt.data_ptr(),
        a.data_ptr(), y.data_ptr(), b, h, g, p, n, *x.stride()[:2], *bvec.stride()[:2], *cvec.stride()[:2],
        DTYPES[x.dtype], torch._C._cuda_getCurrentRawStream(state.device.index),
    )
    if rc != 0:
        raise RuntimeError(f"ssm_decode_cuda: launch failed with cudaError {rc}")
    return y
