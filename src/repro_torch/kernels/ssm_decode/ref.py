"""Plain PyTorch oracle for one Mamba2 layer's single-token state update.

``models/ssm.py`` ``Mamba2Mixer.decode``'s recurrence, expression for expression:
``decay = exp(a * dt)``, head h reads B and C of group h // (H / G), the new
state is ``state * decay + (dt * x) (x) B`` in float32, and ``y`` its contraction
with C, in float32.  The CPU path of ``ops.ssm_decode`` runs this; on the card
it is the CUDA kernel's yardstick: the kernel's new state equals it bit for bit.
"""
from __future__ import annotations

import torch


def ssm_decode_ref(
    state: torch.Tensor,  # (B, H, P, N) float32
    x: torch.Tensor,      # (B, H, P) after the conv, compute dtype
    dt: torch.Tensor,     # (B, H) float32, after softplus and the floor
    a: torch.Tensor,      # (H,) float32, negative
    bvec: torch.Tensor,   # (B, G, N) compute dtype
    cvec: torch.Tensor,   # (B, G, N) compute dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """(new state (B, H, P, N) float32, y (B, H, P) float32)."""
    rep = state.shape[1] // bvec.shape[1]
    decay = torch.exp(a[None] * dt)  # (B,H)
    bvec_h = bvec.repeat_interleave(rep, dim=1).to(torch.float32)  # (B,H,N)
    cvec_h = cvec.repeat_interleave(rep, dim=1).to(torch.float32)
    dx = dt[..., None] * x.to(torch.float32)  # (B,H,P)
    new = state * decay[..., None, None] + dx[..., None] * bvec_h[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new, cvec_h)
    return new, y
