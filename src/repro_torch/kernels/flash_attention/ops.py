"""Dispatcher for causal GQA flash attention; ``layers.attention`` calls this.

A CPU tensor runs the plain PyTorch reference.  A CUDA tensor runs the CUDA
kernel or raises: there is no fallback.  ``LAUNCHES`` counts kernel launches
made here, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_ref

LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,S,K,D) -> (B,S,H,D) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    out = kernel.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), window=window)
    LAUNCHES += 1
    return out
