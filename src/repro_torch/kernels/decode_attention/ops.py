"""Dispatcher for one query row's attention over a K/V cache; ``layers.attention_decode``
calls this where the kernel takes the call (``layers._decode_kernel_fits``).

A CPU tensor runs the plain PyTorch reference.  A CUDA tensor runs the CUDA
kernel or raises: there is no fallback.  Decode only: the kernel has no
gradient, so a call that would record one is refused.  ``LAUNCHES`` counts the
kernel's calls made here (each is the kernel's two passes), so a run can show
that its path went through the kernel; under a replayed CUDA graph they are
counted when the graph is captured, not when it is replayed.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import decode_attention_ref

LAUNCHES = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvm: torch.Tensor,
                     pos: int | torch.Tensor, *, scale: float, window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D) over the rows ``max(0, pos - window + 1) .. pos`` of k, v (B, Smax, K, D),
    q head h reading kv head ``kvm[h]``, scores scaled by ``scale`` -> (B, 1, H, D) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kvm, pos, scale=scale, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention: the kernel has no gradient; call it under torch.inference_mode()")
    out = kernel.decode_attention_cuda(q.contiguous(), k, v, kvm, pos, scale=scale, window=window)
    LAUNCHES += 1
    return out
