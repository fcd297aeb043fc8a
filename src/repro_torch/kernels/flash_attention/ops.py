"""Dispatcher for causal GQA flash attention; ``layers.attention`` calls this.

A CPU tensor runs the plain PyTorch reference, which autograd differentiates
directly.  A CUDA tensor runs the CUDA kernel or raises: there is no
fallback.  On the card the call is a ``torch.autograd.Function``: its
forward is the kernel, its backward the gradient of the plain version,
recomputed from the saved q, k and v (the reference's kernel has no
gradient at all).  ``LAUNCHES`` counts kernel launches made here and
``BACKWARDS`` the plain recomputes, so a run can show that its path went
through the kernel and that each launch had its backward.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import kernel
from .ref import flash_attention_ref

LAUNCHES = 0
BACKWARDS = 0


def _refuse_dtensors(*ts) -> None:
    """The kernel reads raw device pointers: a DTensor there is a fault, not a fallback."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("flash_attention's kernel takes plain local tensors, not DTensors: gather them first")


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of ``flash_attention_ref`` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        global LAUNCHES
        _refuse_dtensors(q, k, v)
        out = kernel.flash_attention_cuda(q, k, v, window=window)
        LAUNCHES += 1
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, gout):
        global BACKWARDS
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted)]
            out = flash_attention_ref(*ins, window=ctx.window)
            grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], gout))
        BACKWARDS += 1
        return (*(next(grads) if w else None for w in wanted), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,S,K,D) -> (B,S,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), window)
