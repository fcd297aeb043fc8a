"""Dispatcher for one Mamba2 layer's single-token state update, which ``Mamba2Mixer.decode`` calls
for every step, sharded or not.

A CPU tensor runs the plain PyTorch reference and copies its new state into ``out``.  A CUDA
tensor runs the CUDA kernel or raises (``kernel.ssm_decode_cuda`` names what it cannot take):
there is no fallback.  Decode only: the kernel has no gradient and writes ``out`` in place, so
a call that would record a gradient is refused.  ``LAUNCHES`` counts the kernel's calls made
here, so a run can show that its path went through the kernel; under a replayed CUDA graph they
are counted when the graph is captured, not when it is replayed.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import ssm_decode_ref

LAUNCHES = 0


def ssm_decode(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bvec: torch.Tensor,
               cvec: torch.Tensor, *, out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """state (B, H, P, N) float32, x (B, H, P), dt (B, H) float32, a (H,) float32, B and C (B, G, N)
    -> (``out``, into which the new state is written: another tensor of the state's shape, or
    ``state`` itself; y (B, H, P) float32), ``ref.ssm_decode_ref``'s values."""
    global LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (state, x, dt, a, bvec, cvec)):
        raise RuntimeError("ssm_decode: the kernel has no gradient; call it under torch.inference_mode()")
    if state.device.type == "cpu":
        new, y = ssm_decode_ref(state, x, dt, a, bvec, cvec)
        return out.copy_(new), y
    y = kernel.ssm_decode_cuda(state, x, dt, a, bvec, cvec, out)
    LAUNCHES += 1
    return out, y
