"""Dispatcher for the SSD chunked scan; the models always call this entry point.

A CPU tensor runs the plain PyTorch reference, which autograd differentiates
directly.  A CUDA tensor runs the CUDA kernel or raises: there is no
fallback.  On the card the call is a ``torch.autograd.Function``: its
forward is the kernel, its backward the gradient of the plain version,
recomputed from the saved inputs (the reference has no backward kernel
either: ``jax.value_and_grad`` differentiates its plain scan).
``LAUNCHES`` counts kernel launches made here and ``BACKWARDS`` the plain
recomputes, so a run can show that its path went through the kernel and
that each launch had its backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from . import kernel
from .ref import ssd_scan_ref

LAUNCHES = 0
BACKWARDS = 0


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


def _refuse_dtensors(*ts) -> None:
    """The kernel reads raw device pointers: a DTensor there is a fault, not a fallback."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("ssd_scan's kernel takes plain local tensors, not DTensors: gather them first")


class SSDScan(torch.autograd.Function):
    """Forward: pad, launch the kernel, slice.  Backward: autograd of ``ssd_scan_ref``
    on the saved inputs; nothing of the plain version is kept from the forward."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk: int):
        global LAUNCHES
        _refuse_dtensors(x, dt, a, bmat, cmat)
        s = x.shape[1]
        xp, dtp, bp, cp, L = pad_to_chunks(x, dt, bmat, cmat, chunk=chunk)
        y, state = kernel.ssd_scan_cuda(xp, dtp, a, bp, cp, chunk=L)
        LAUNCHES += 1
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # the final state's gradient is None where it is unused
        return y[:, :s], state

    @staticmethod
    def backward(ctx, gy, gstate):
        global BACKWARDS
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
            y, state = ssd_scan_ref(*ins, chunk=ctx.chunk)
            outs, grads_out = [], []
            for out, g in ((y, gy), (state, gstate)):
                if g is not None:
                    outs.append(out)
                    grads_out.append(g.to(out.dtype))  # y: x's dtype on the card, float32 here
            leaves = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, leaves, grads_out, allow_unused=True))
        BACKWARDS += 1
        return (*(next(grads) if w else None for w in wanted), None)


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 256):
    """Returns (y: (B,S,H,P), final_state: (B,H,P,N) float32).

    y is float32 on the CPU (as the reference returns it) and x's dtype on
    the card (as the kernel writes it); callers cast it.
    """
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    return SSDScan.apply(
        x.contiguous(), dt.to(torch.float32).contiguous(), a.to(torch.float32).contiguous(),
        bmat.contiguous(), cmat.contiguous(), chunk,
    )
