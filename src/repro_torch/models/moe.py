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

``moe_dropless`` is the granitemoehybrid family's layer (IBM Granite 4.0-H), which
the port alone holds: no (token, k) pair is dropped, and the layer holds one
chip's share of an expert-parallel deployment, the ``cfg.experts_held`` experts
from ``cfg.expert_first`` of the router's ``num_experts``.  It routes over all
of them and adds only its own experts' part; the pairs routed elsewhere add
nothing here (their chips add them), and the shared expert runs on every token.
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
        d, f, e, held = cfg.d_model, cfg.expert_d_ff, cfg.num_experts, cfg.num_experts_held
        s_in, s_out = d**-0.5, f**-0.5
        self.router = _normal((d, e), s_in, dt, generator, device)
        self.gate = _normal((held, d, f), s_in, dt, generator, device)
        self.up = _normal((held, d, f), s_in, dt, generator, device)
        self.down = _normal((held, f, d), s_out, dt, generator, device)
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


# ------------------------------------------------------------ dropless, held
ROWS_BUCKET = 256  # a held expert's rows in prefill are computed in multiples of this


def held_routing(cfg: ArchConfig, p: MoE, xt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on ``xt`` (N, D), over all ``cfg.num_experts``, in float32: each row's ``top_k``
    experts by logit and a softmax over those k logits, the gates (N, K); each pair's expert as an
    index into the held ones (N, K); and which pairs are held here (N, K).  The gates are not
    renormalised over the held experts: an expert-parallel combine sums every chip's part as is."""
    logits = xt.to(torch.float32) @ p.router.to(torch.float32)
    top, expert = torch.topk(logits, cfg.top_k, dim=-1)
    local = expert - cfg.expert_first
    return torch.softmax(top, dim=-1), local, (local >= 0) & (local < p.gate.shape[0])


def _experts(p: MoE, e, xe: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Held expert ``e``'s SwiGLU on ``xe`` (a slice ``e`` runs every held expert, batched)."""
    return (F.silu(xe @ p.gate[e].to(cd)) * (xe @ p.up[e].to(cd))) @ p.down[e].to(cd)


def moe_dropless(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> the held experts' part of the MoE plus the shared expert, (B, S, D).

    Each (token, k) pair routed to a held expert adds gate x expert(token); no pair is dropped.
    With one position a row (a decode step, which a replayed graph holds to static shapes) every
    held expert runs over every row, weighted by its gate (zero where it was not chosen): the same
    weights are read as by the routed rows alone.  Otherwise the pairs held here are sorted by
    expert and each expert multiplies its own rows (one read-back a layer, of the counts), padded
    to a multiple of ``ROWS_BUCKET`` with the pairs that follow (computed, never added): the
    products and their buffers then come in a few sizes, which the card's libraries and the
    allocator meet again from batch to batch, where exact counts would give each batch new ones.
    The combine adds each expert's rows in turn, in float32, so its sums keep one order.

    One grouped product over device offsets (``torch._grouped_mm``) cannot replace both paths: with
    the static shapes a replayed graph needs it gathers every token's pairs, and on an H100 at
    granite's widths it took 0.93 ms a decode layer against 0.63 (and copied from the host under
    capture) and 7.2-27.4 ms a prefill layer against 3.2-8.9; sized by a read-back of the held total
    instead it was within 2-20% of the loop here, but its one combine adds a token's pairs by
    atomics, in no fixed order."""
    if p.tp_group is not None:
        raise NotImplementedError("moe_dropless: a tensor-parallel expert layer is not built")
    cd = _dtype(cfg.compute_dtype)
    b, s, d = x.shape
    n, held = b * s, p.gate.shape[0]
    xt = x.to(cd).reshape(n, d)
    gates, local, mine = held_routing(cfg, p, xt)
    if s == 1:
        w = torch.zeros((n, held), dtype=torch.float32, device=x.device)
        w.scatter_add_(1, local.clamp(0, held - 1), gates * mine)
        out = (_experts(p, slice(None), xt, cd).to(torch.float32) * w.T[..., None]).sum(0)
    else:
        key = torch.where(mine, local, held).reshape(-1)      # pairs routed elsewhere sort last
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=held + 1).tolist()
        rows, weight = order // cfg.top_k, gates.reshape(-1)[order]
        out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        lo = 0
        for e in range(held):
            hi = lo + counts[e]
            if hi > lo:
                top = min(lo + -(-(hi - lo) // ROWS_BUCKET) * ROWS_BUCKET, key.numel())
                eo = _experts(p, e, xt[rows[lo:top]], cd).to(torch.float32) * weight[lo:top, None]
                out.index_add_(0, rows[lo:hi], eo[:hi - lo])
            lo = hi
    if p.shared is not None:
        out = out + mlp_partial(p.shared, xt, cd).to(torch.float32)
    return out.to(cd).reshape(b, s, d)
