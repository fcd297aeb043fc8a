"""Launch the decode-attention CUDA kernels (``csrc/decode_attention.cu``).

Two passes on the current stream: one block per (chunk of ``CHUNK`` cache
rows, kv head, batch row) writes a partial softmax of its rows into an f32
workspace, then one block per (q head, batch row) joins the partials in chunk
order.  ``pos`` is read on the card, so the launch reads nothing back to the
host and a CUDA graph can hold it.  ``build()`` compiles the source with
``nvcc`` for ``sm_90a`` at the first launch, through ``kernels/_nvcc.py``.
Importing this module needs no compiler and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._nvcc import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
CHUNK = 64          # cache rows a block of the first pass reads
MAX_HEAD_DIM = 256  # a row is one 16-byte load a lane
MAX_GRID = 65535    # batch rows and kv heads: the grid's second and third dimensions


def build() -> ctypes._CFuncPtr:
    """Compile (if not yet built) and load the kernel's entry point; raises on failure."""
    return load(SOURCE, "decode_attention_launch", ARGTYPES)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvm: torch.Tensor,
                          pos: torch.Tensor, *, scale: float, window: int = 0) -> torch.Tensor:
    """Launch the kernels: q (B, 1, H, D) over the rows ``max(0, pos - window + 1) .. pos`` of
    k and v (B, Smax, K, D) -> (B, 1, H, D) bfloat16.

    All bfloat16 on one CUDA device.  q contiguous; k and v by their strides, D contiguous,
    each row 16-byte aligned (strides multiples of 8); ``kvm`` (H,) int64 with values in
    [0, K) (a q head mapped outside reads nothing and gets zeros); ``pos`` the cache's 0-d
    int32 tensor, inside [0, Smax).  D % 8 == 0 and D <= ``MAX_HEAD_DIM``; window >= 0.
    """
    b, one, h, d = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    if k.dim() != 4 or one != 1 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"decode_attention_cuda: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} do not agree"
        )
    smax, kh = k.shape[1], k.shape[2]
    for name, t in {"q": q, "k": k, "v": v, "kvm": kvm, "pos": pos}.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention_cuda: {name} must be on {q.device} (CUDA), got {t.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention_cuda: q, k and v must be bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.is_contiguous() or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention_cuda: q must be contiguous, and q, k and v 16-byte aligned")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM or window < 0 or not 0 < b <= MAX_GRID or not 0 < kh <= MAX_GRID \
            or smax < 1:
        raise ValueError(f"decode_attention_cuda: needs D % 8 == 0, 0 < D <= {MAX_HEAD_DIM}, window >= 0, "
                         f"0 < B, K <= {MAX_GRID}; got D={d} window={window} B={b} K={kh} Smax={smax}")
    if any(t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) for t in (k, v)):
        raise ValueError(f"decode_attention_cuda: k and v need D contiguous and rows 16-byte aligned, "
                         f"got strides {k.stride()}, {v.stride()}")
    if kvm.dtype != torch.int64 or kvm.shape != (h,) or not kvm.is_contiguous():
        raise ValueError(f"decode_attention_cuda: kvm must be a contiguous ({h},) int64 map, got "
                         f"{kvm.dtype}{tuple(kvm.shape)}")
    if pos.dtype != torch.int32 or pos.numel() != 1:
        raise ValueError(f"decode_attention_cuda: pos must be one int32 on the card, got {pos.dtype}{tuple(pos.shape)}")
    nchunks = -(-smax // CHUNK)
    work = torch.empty(b * h * nchunks * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = build()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(), pos.data_ptr(), out.data_ptr(), work.data_ptr(),
        b, h, kh, d, smax, *k.stride()[:3], *v.stride()[:3], CHUNK, window, scale, -(-h // kh),
        torch._C._cuda_getCurrentRawStream(q.device.index),
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention_cuda: launch failed with cudaError {rc}")
    return out
