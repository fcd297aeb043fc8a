"""Fine-grained Mixture-of-Experts layer (DeepSeekMoE / Qwen3-MoE style).

Routing is top-k with per-sequence capacity dropping (GShard-style), and the
dispatch is scatter/gather based, as in the reference: each (token, k) pair
takes the next slot of its expert's queue in the order of the flattened
(S*K) axis, pairs past the capacity are dropped, the kept tokens are
scattered into (B, E, C, D) expert buffers, the experts run batched, and
each token gathers its k outputs back, weighted.  The slot order and the
drop are order-dependent; they follow the reference exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from .layers import _dtype, _normal, mlp, mlp_init


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
        s_in, s_out = d**-0.5, f**-0.5
        self.router = _normal((d, e), s_in, dt, generator, device)
        self.gate = _normal((e, d, f), s_in, dt, generator, device)
        self.up = _normal((e, d, f), s_in, dt, generator, device)
        self.down = _normal((e, f, d), s_out, dt, generator, device)
        self.shared = mlp_init(d, f * cfg.num_shared_experts, dt, generator, device) if cfg.num_shared_experts else None


def moe_init(cfg: ArchConfig, generator: torch.Generator, device) -> MoE:
    return MoE(cfg, generator, device)


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def moe_apply(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Dispatch groups = batch rows."""
    cd = _dtype(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(cfg, s)
    xt = x.to(cd)

    logits = torch.einsum("bsd,de->bse", xt, p.router.to(cd)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                                   # (B,S,E)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)                  # (B,S,K)
    topw = (topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)).to(cd)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                             # (E,)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device)
    counts.index_put_((topi.reshape(-1),), torch.ones((), dtype=torch.float32, device=x.device), accumulate=True)
    aux = e * torch.sum(me * (counts / (b * s * k)))

    # slot assignment: position of each (token, k) within its expert's queue
    flat_e = topi.reshape(b, s * k)                                         # (B, S*K)
    onehot = F.one_hot(flat_e, e)                                           # (B, S*K, E)
    pos = torch.cumsum(onehot, dim=1) - onehot                              # exclusive, in (token, k) order
    slot = torch.gather(pos, -1, flat_e[..., None])[..., 0]                 # (B, S*K)
    keep = slot < c
    slot_c = torch.where(keep, slot, 0)

    # scatter tokens into per-expert buffers (B, E, C, D); dropped pairs add zeros at slot 0
    tok = xt[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    w_keep = keep.to(cd)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, c, d), dtype=cd, device=x.device)
    buf.index_put_((bidx, flat_e, slot_c), tok * w_keep[..., None], accumulate=True)

    # expert FFN, batched over experts
    g = torch.einsum("becd,edf->becf", buf, p.gate.to(cd))
    u = torch.einsum("becd,edf->becf", buf, p.up.to(cd))
    eo = torch.einsum("becf,efd->becd", F.silu(g) * u, p.down.to(cd))      # (B,E,C,D)

    # combine: gather each token's k expert outputs and weight them
    gathered = eo[bidx, flat_e, slot_c]                                     # (B,S*K,D)
    gathered = gathered * (topw.reshape(b, s * k)[..., None] * w_keep[..., None])
    out = gathered.reshape(b, s, k, d).sum(dim=2)

    if p.shared is not None:
        out = out + mlp(p.shared, xt, cfg.compute_dtype)
    return out.to(x.dtype), aux
