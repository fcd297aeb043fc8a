"""Dispatcher for the SSD chunked scan; the models always call this entry point.

A CPU tensor runs the plain PyTorch reference.  A CUDA tensor runs the CUDA
kernel or raises: there is no fallback.  ``LAUNCHES`` counts kernel launches
made here, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel
from .ref import ssd_scan_ref

LAUNCHES = 0


def pad_to_chunks(x, dt, bmat, cmat, *, chunk: int):
    """Zero-pad the sequence axis for the kernel; returns (x, dt, bmat, cmat, L).

    L is min(chunk, S) rounded up to the kernel's tile and S is padded to a
    multiple of L.  Padding is exact: a zero ``dt`` leaves the state and every
    earlier y unchanged, and the padded rows are sliced off.  A different L
    changes only the rounding, not the result.
    """
    s = x.shape[1]
    L = -(-min(chunk, s) // kernel.TILE) * kernel.TILE
    pad = -s % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    return x, dt, bmat, cmat, L


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 256):
    """Returns (y: (B,S,H,P), final_state: (B,H,P,N) float32).

    y is float32 on the CPU (as the reference returns it) and x's dtype on
    the card (as the kernel writes it); callers cast it.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    s = x.shape[1]
    xp, dtp, bp, cp, L = pad_to_chunks(
        x.contiguous(), dt.to(torch.float32).contiguous(), bmat.contiguous(), cmat.contiguous(),
        chunk=chunk,
    )
    y, state = kernel.ssd_scan_cuda(xp, dtp, a.to(torch.float32).contiguous(), bp, cp, chunk=L)
    LAUNCHES += 1
    return y[:, :s], state
