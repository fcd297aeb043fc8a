"""Plain PyTorch oracle for one query row's attention over a K/V cache.

``layers._attend_cache``'s arithmetic without ``wo``: q head h reads kv head
``kvm[h]`` (the cache gathered by the map), logits are taken in the inputs'
dtype and cast to float32, scaled by ``scale``, and masked to -1e30 outside
the rows ``max(0, pos - window + 1) .. pos`` (``window`` 0: from row 0); the
softmax is float32 and its probabilities are cast back before the product
with v.  ``pos`` is an int or a 0-d tensor, compared on the device.  The CPU
path of ``ops.decode_attention`` runs this; on the card it is the CUDA
kernel's yardstick.
"""
from __future__ import annotations

import torch


def decode_attention_ref(
    q: torch.Tensor,    # (B, 1, H, D)
    k: torch.Tensor,    # (B, Smax, K, D)
    v: torch.Tensor,    # (B, Smax, K, D)
    kvm: torch.Tensor,  # (H,) int64: q head -> kv head
    pos: int | torch.Tensor,
    *,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = kpos <= pos
    if window:
        valid &= kpos > pos - window
    logits = torch.einsum("bqhd,bshd->bhqs", q, k[:, :, kvm, :]).to(torch.float32)
    logits = logits * scale
    logits = torch.where(valid[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v[:, :, kvm, :])
