"""Fine-grained Mixture-of-Experts layer (DeepSeekMoE / Qwen3-MoE style).

Routing is top-k with per-sequence capacity dropping (GShard-style), and the
dispatch is scatter/gather based, as in the reference: each (token, k) pair
takes the next slot of its expert's queue in the order of the flattened
(S*K) axis, pairs past the capacity are dropped, the kept tokens are
scattered into (B, E, C, D) expert buffers, the experts run batched, and
each token gathers its k outputs back, weighted.  The slot order and the
drop are order-dependent; they follow the reference exactly.

Under tensor parallelism (``tp_group``, set by ``train/step.py``) each rank
holds F/tp of the expert hidden columns (``gate``/``up`` (E, D, F/tp),
``down`` (E, F/tp, D)) and of the shared expert's, as the reference's specs
place them.  Routing, the aux loss, the slots and the dispatch stay
replicated, so every rank drops what the reference drops; the experts run on
the rank's columns, and the combine, being linear, carries the partial sums
to one all-reduce of (B, S, D) a layer, the collective the reference's
docstring names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from ..sharding import tp
from .layers import _dtype, _normal, mlp_init, mlp_partial


class MoE(nn.Module):
    tp_group: tp.Group | None = None

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


def route(cfg: ArchConfig, p: MoE, xt: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The router on ``xt`` (B, S, D) in the compute dtype: the expert
    probabilities (B, S, E) in float32, the top-k weights (renormalised, in the
    compute dtype) and experts (B, S, K), each (token, k) pair's slot in its
    expert's queue (B, S*K), in the order of the flattened (S*K) axis, and the
    load-balancing aux loss.  Under TP every rank computes it whole, alike."""
    cd = _dtype(cfg.compute_dtype)
    b, s, _ = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", xt, p.router.to(cd)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                                   # (B,S,E)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)                  # (B,S,K)
    topw = (topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)).to(cd)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                             # (E,)
    counts = torch.zeros(e, dtype=torch.float32, device=xt.device)
    counts.index_put_((topi.reshape(-1),), torch.ones((), dtype=torch.float32, device=xt.device), accumulate=True)
    aux = e * torch.sum(me * (counts / (b * s * k)))

    # slot assignment: position of each (token, k) within its expert's queue
    flat_e = topi.reshape(b, s * k)                                         # (B, S*K)
    onehot = F.one_hot(flat_e, e)                                           # (B, S*K, E)
    pos = torch.cumsum(onehot, dim=1) - onehot                              # exclusive, in (token, k) order
    slot = torch.gather(pos, -1, flat_e[..., None])[..., 0]                 # (B, S*K)
    return probs, topw, topi, slot, aux


def moe_apply(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Dispatch groups = batch rows.

    Under TP the router reads ``x`` outside the region, the experts inside it
    (``tp.copy``), and ``topw`` enters it through ``tp.copy`` too: each rank's
    gradient of either is partial only through its own columns, and the copy's
    all-reduce sums those parts once.  The aux loss is whole on every rank."""
    cd = _dtype(cfg.compute_dtype)
    group = p.tp_group
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(cfg, s)
    xt = x.to(cd)
    _, topw, topi, slot, aux = route(cfg, p, xt)
    flat_e = topi.reshape(b, s * k)
    keep = slot < c
    slot_c = torch.where(keep, slot, 0)

    # scatter tokens into per-expert buffers (B, E, C, D); dropped pairs add zeros at slot 0
    xe = tp.copy(xt, group)
    tok = xe[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
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
    gathered = gathered * (tp.copy(topw, group).reshape(b, s * k)[..., None] * w_keep[..., None])
    out = gathered.reshape(b, s, k, d).sum(dim=2)

    if p.shared is not None:
        out = out + mlp_partial(p.shared, xe, cd)
    return tp.reduce(out, group).to(x.dtype), aux
