"""Plain PyTorch oracle for causal GQA flash attention.

Query head h reads kv head h // (H/K).  Logits are taken in the inputs'
dtype and cast to float32, scaled by D**-0.5 and masked to -1e30 where the key
lies after the query (or ``window`` or more positions before it); the softmax
is float32 and its probabilities are cast back before the product with v.
The CPU path of ``ops.flash_attention`` runs this; on the card it is the CUDA
kernel's yardstick.
"""
from __future__ import annotations

import torch


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    *,
    window: int = 0,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    group = h // kh
    qg = q.reshape(b, sq, kh, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) * d**-0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)
