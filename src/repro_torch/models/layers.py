"""Shared neural layers: RMSNorm and LayerNorm, RoPE, GQA attention (with KV
cache) and cross attention, SwiGLU and GELU MLPs, sinusoid positions, and the
embedding.

Parameters are ``nn.Module``s whose leaves carry the reference's names and
layouts (``embed`` as (V, D), ``unembed`` as (D, V), ``scale``, ``wq`` as
(D, H, hd), ``wo`` as (H, hd, D)), so that ``convert.load_jax_params`` maps
the reference's param tree 1:1.  The functions take the config and the
module, as the reference's take the config and the param tree.

Tensor parallelism (``sharding/tp.py``): a sharded step sets ``tp_group`` on
the ``Attention``, ``MLP``, ``GeluMLP`` and ``Embedding`` modules it runs
(``train/step.py``) and hands each its model-axis shards: q heads (and kv
heads where they divide the axis), FFN hidden columns and vocabulary rows.
The layer then computes only those and joins the partial results over the
group.  A sharded decode also sets ``seq_split`` on each ``Attention`` where
the K/V it reads (its own cache, or a cross-attention's encoder K/V) is split
over the sequence (``_attend_cache``).  With ``tp_group`` and ``seq_split``
None (every module ``init_params`` builds) each function runs the ops it ran
before.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.decode_attention import kernel as da_kernel
from ..kernels.decode_attention import ops as da_ops
from ..sharding import tp
from .config import ArchConfig


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _device(device=None) -> torch.device:
    """Resolve an entry point's device: None means the card, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _normal(shape, scale: float, dtype, generator, device) -> nn.Parameter:
    return _param(torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale)


# --------------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.ones(dim, dtype=dtype, device=device))


def rmsnorm_init(dim: int, dtype, device) -> RMSNorm:
    return RMSNorm(dim, dtype, device)


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    return _rms(x, params.scale, eps)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


def rmsnorm_grouped(params: RMSNorm, x: torch.Tensor, eps: float, groups: int) -> torch.Tensor:
    """``rmsnorm`` over each of ``groups`` equal parts of the last dim (Mamba2's gated norm
    with B/C groups); one group is ``rmsnorm`` itself."""
    if groups == 1:
        return rmsnorm(params, x, eps)
    shape = x.shape
    scale = params.scale.reshape(groups, -1)
    return _rms(x.reshape(*shape[:-1], groups, -1), scale, eps).reshape(shape)


def rmsnorm_split(params: RMSNorm, x: torch.Tensor, eps: float, g: tp.Group) -> torch.Tensor:
    """``rmsnorm`` over a dim that the model axis splits: ``x`` is this rank's part
    of it and ``params.scale`` the whole (replicated) leaf.  The sum of squares is
    reduced over the group before it scales."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = tp.all_reduce(xf.square().sum(dim=-1, keepdim=True), g) / (xf.shape[-1] * g.size)
    y = xf * torch.rsqrt(var + eps)
    return (y * tp.part(params.scale, 0, g).to(torch.float32)).to(dt)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = _param(torch.ones(dim, dtype=dtype, device=device))
        self.bias = _param(torch.zeros(dim, dtype=dtype, device=device))


def layernorm_init(dim: int, dtype, device) -> LayerNorm:
    return LayerNorm(dim, dtype, device)


def layernorm(params: LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params.scale.to(torch.float32) + params.bias.to(torch.float32)).to(dt)


def sinusoid_positions(length: int, dim: int, device) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (length, dim), float32."""
    half = dim // 2
    step = torch.log(torch.tensor(10000.0, device=device)) / (half - 1)  # in float32, as the reference
    scale = torch.exp(-torch.arange(half, dtype=torch.float32, device=device) * step)
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * scale[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------- rope
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2), float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=positions.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention
class Attention(nn.Module):
    """q, k, v and o.  Its input is ``d_in`` wide (the model's width unless given: a zamba2
    shared block attends over the stream and the embedding side by side, 2 x d_model)."""

    tp_group: tp.Group | None = None
    seq_split: tp.SeqSplit | None = None  # a sharded decode's cache shard (``attention_decode``)

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device, d_in: int | None = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        d_in = d_in or d
        h, k = cfg.num_heads, cfg.num_kv_heads
        dt = _dtype(cfg.param_dtype)
        scale = d**-0.5
        self.wq = _normal((d_in, h, hd), d_in**-0.5, dt, generator, device)
        self.wk = _normal((d_in, k, hd), d_in**-0.5, dt, generator, device)
        self.wv = _normal((d_in, k, hd), d_in**-0.5, dt, generator, device)
        self.wo = _normal((h, hd, d), scale, dt, generator, device)
        if cfg.orig_num_heads and cfg.orig_num_heads < h:
            # TP head padding: padded q heads are exact zeros (contribute nothing)
            mask = (torch.arange(h, device=device) < cfg.orig_num_heads).to(dt)
            with torch.no_grad():
                self.wq.mul_(mask[None, :, None])
                self.wo.mul_(mask[:, None, None])
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros((h, hd), dtype=dt, device=device))
            self.bk = _param(torch.zeros((k, hd), dtype=dt, device=device))
            self.bv = _param(torch.zeros((k, hd), dtype=dt, device=device))
        if cfg.qk_norm:
            self.q_norm = rmsnorm_init(hd, dt, device)
            self.k_norm = rmsnorm_init(hd, dt, device)
        # the q-head -> kv-head map, built once; not a leaf of the reference's tree
        self.register_buffer("kvm", kv_head_map(h, k, cfg.orig_num_heads).to(device), persistent=False)


def attention_init(cfg: ArchConfig, generator: torch.Generator, device) -> Attention:
    return Attention(cfg, generator, device)


def _kv_weights(cfg: ArchConfig, p: Attention, whole_kv: bool):
    """``wk``, ``wv`` and their biases (None without ``qkv_bias``) as this rank reads
    them: under TP its own kv heads where they divide the group, else (replicated
    leaves, through ``tp.copy``) the span of kv heads its q heads read
    (``kv_heads_read``), or all of them with ``whole_kv``."""
    g = p.tp_group
    wk, wv = p.wk, p.wv
    bk, bv = (p.bk, p.bv) if cfg.qkv_bias else (None, None)
    if g is not None and cfg.num_kv_heads % g.size:
        wk, wv = tp.copy(wk, g), tp.copy(wv, g)
        bk, bv = (None, None) if bk is None else (tp.copy(bk, g), tp.copy(bv, g))
        if not whole_kv:
            _, lo, kl = kv_heads_read(cfg, g)
            wk, wv = wk[:, lo:lo + kl], wv[:, lo:lo + kl]
            bk, bv = (None, None) if bk is None else (bk[lo:lo + kl], bv[lo:lo + kl])
    return wk, wv, bk, bv


def _project_qkv(cfg: ArchConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor | None, *,
                 whole_kv: bool = False):
    """q, k and v of ``x``, rotated where ``positions`` are given.  Under TP: this
    rank's q heads, and the kv heads of ``_kv_weights``."""
    cd = _dtype(cfg.compute_dtype)
    g = p.tp_group
    wk, wv, bk, bv = _kv_weights(cfg, p, whole_kv)
    qs, ks = (p.q_norm.scale, p.k_norm.scale) if cfg.qk_norm else (None, None)
    if g is not None:
        x = tp.copy(x, g)
        qs, ks = (None, None) if qs is None else (tp.copy(qs, g), tp.copy(ks, g))
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(cd))
    if cfg.qkv_bias:
        q = q + p.bq.to(cd)
        k = k + bk.to(cd)
        v = v + bv.to(cd)
    if cfg.qk_norm:
        q = _rms(q, qs, cfg.norm_eps)
        k = _rms(k, ks, cfg.norm_eps)
    if positions is not None:
        cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def kv_head_map(num_q_heads: int, num_kv_heads: int, orig_q_heads: int = 0) -> torch.Tensor:
    """Constant q-head -> kv-head index map (int64, on the CPU).

    Divisibility-free GQA: instead of the (H -> K, group) reshape (which
    requires H % K == 0 and breaks under TP head padding), each q head gathers
    its kv head through this map.  Padded q heads (>= orig_q_heads, added for
    16-way TP divisibility with zeroed wq/wo) are clamped to the last kv head.
    ``Attention`` keeps it as its ``kvm`` buffer, so no call rebuilds it.
    """
    oq = orig_q_heads or num_q_heads
    group = max(1, oq // num_kv_heads)
    return torch.clamp(torch.arange(num_q_heads) // group, max=num_kv_heads - 1)


def kv_heads_read(cfg: ArchConfig, g: tp.Group) -> tuple[torch.Tensor, int, int]:
    """Under TP, (this rank's q heads' map into the kv heads it reads, the first of
    those kv heads, their count).  Where the kv heads divide the group those are the
    rank's own K/tp; else the span of the replicated K that its q heads read
    (qwen2.5-3b's 2 kv heads at tp = 4: one each)."""
    hl, kh = cfg.num_heads // g.size, cfg.num_kv_heads
    if kh % g.size == 0:
        kl = kh // g.size
        lo = g.rank * kl
    else:  # kv_head_map's arithmetic on ints (it rises with the q head), so that no tensor is read back
        group = max(1, (cfg.orig_num_heads or cfg.num_heads) // kh)
        lo, hi = (min(h // group, kh - 1) for h in (g.rank * hl, (g.rank + 1) * hl - 1))
        kl = hi - lo + 1
    return kv_head_map(cfg.num_heads, kh, cfg.orig_num_heads)[g.rank * hl:(g.rank + 1) * hl] - lo, lo, kl


def kv_map(cfg: ArchConfig, g: tp.Group | None) -> torch.Tensor:
    """An attention layer's q-head -> kv-head map on the CPU, over the heads this rank
    computes: ``kv_head_map``, or under TP ``kv_heads_read``'s."""
    if g is None:
        return kv_head_map(cfg.num_heads, cfg.num_kv_heads, cfg.orig_num_heads)
    return kv_heads_read(cfg, g)[0]


def softmax_scale(cfg: ArchConfig, head_dim: int) -> float:
    """The scores' scale: ``cfg.attention_multiplier`` where it is set (granitemoehybrid's 1 / head_dim);
    else head_dim^-0.5, and (head_dim / 2)^-0.5 in zamba2's shared blocks, as the published attention
    sets it (its heads are twice as wide as the stream's share)."""
    if cfg.attention_multiplier:
        return cfg.attention_multiplier
    return (head_dim / 2) ** -0.5 if cfg.family == "zamba2" else head_dim**-0.5


def _sdpa(cfg: ArchConfig, q, k, v, kvm: torch.Tensor, *, causal: bool, q_offset: int = 0, window: int = 0):
    """Grouped-query scaled dot-product attention (the plain path).

    q: (B,Sq,H,D), k/v: (B,Skv,K,D), ``kvm`` the layer's ``kv_head_map`` on
    q's device.  ``q_offset`` is the absolute position of q[:, 0] for causal
    masking against a longer k/v (decode).
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kr = k[:, :, kvm, :]  # (B,Skv,H,D)
    vr = v[:, :, kvm, :]
    logits = torch.einsum("bqhd,bshd->bhqs", q, kr).to(torch.float32)
    logits = logits * softmax_scale(cfg, d)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, vr)


def _check_flash_heads(cfg: ArchConfig, kvm: torch.Tensor, kh: int) -> None:
    """The kernel reads kv head h // (H/K) of the H q heads and K kv heads it is
    given; refuse a layer whose q-head -> kv-head map ``kvm`` differs."""
    h = kvm.numel()
    if h % kh or not torch.equal(kvm, torch.arange(h) // (h // kh)):
        raise ValueError(
            f"attention_impl='flash' with {h} q heads ({cfg.orig_num_heads or h} unpadded) over {kh} kv "
            "heads: the kernel's map h // (H/K) differs from kv_head_map (ROADMAP.md §3, fault (c)); "
            "use attention_impl='xla'"
        )


def attention(cfg: ArchConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / scoring)."""
    cd = _dtype(cfg.compute_dtype)
    q, k, v = _project_qkv(cfg, p, x.to(cd), positions)
    if cfg.attention_impl == "flash" and causal:
        from ..kernels.flash_attention import ops as fa_ops

        if cfg.family == "zamba2":
            raise ValueError("attention_impl='flash' scales scores by head_dim^-0.5; zamba2's shared blocks "
                             "take (head_dim / 2)^-0.5: use attention_impl='xla'")
        if cfg.attention_multiplier:
            raise ValueError(f"attention_impl='flash' scales scores by head_dim^-0.5, not the attention_multiplier "
                             f"{cfg.attention_multiplier}: use attention_impl='xla'")
        _check_flash_heads(cfg, kv_map(cfg, p.tp_group), k.shape[2])
        out = fa_ops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        out = _sdpa(cfg, q, k, v, p.kvm, causal=causal, window=cfg.sliding_window)
    return tp.reduce(torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd)), p.tp_group)


def attention_prefill(cfg: ArchConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor | None, *,
                      whole_kv: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention on the plain path, as prefill runs it (and whisper's
    decoder always, with no ``positions``): (output, k, v) with k and v over every
    kv head, for the cache.  Under TP the rank attends with its own heads, and k
    and v are gathered over the group (or computed whole where they are
    replicated); without ``whole_kv`` they are the kv heads the rank attended
    with."""
    cd = _dtype(cfg.compute_dtype)
    g = p.tp_group
    q, k, v = _project_qkv(cfg, p, x.to(cd), positions, whole_kv=whole_kv)
    ka, va = k, v
    if whole_kv and g is not None and cfg.num_kv_heads % g.size:
        _, lo, kl = kv_heads_read(cfg, g)
        ka, va = k[:, :, lo:lo + kl], v[:, :, lo:lo + kl]
    out = _sdpa(cfg, q, ka, va, p.kvm, causal=True, window=cfg.sliding_window)
    y = tp.reduce(torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd)), g)
    if whole_kv and g is not None and cfg.num_kv_heads % g.size == 0:
        k, v = tp.gather(k, 2, g), tp.gather(v, 2, g)
    return y, k, v


def _attend_cache(cfg: ArchConfig, p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """One query row's attention over K/V that a decode holds (its cache, or a
    cross-attention's encoder K/V), through ``wo``: q (B, 1, H, D) over this
    rank's q heads, k and v (B, Smax, K, D) over every kv head and the positions
    ``valid`` (1, Smax) marks.

    Sharded (``train/step.py::make_decode_step``), k and v hold either the whole
    sequence or, with ``p.seq_split``, the rank's shard of it, as the
    reference's ``cache_specs`` place it:

    - (a) the sequence whole under ``p.tp_group`` alone: head-parallel, as
      ``attention``: the rank's q heads over the kv heads they read, its ``wo``
      rows, then ``tp.reduce``;
    - (b) the sequence split: every q head (gathered over the group under TP)
      over the rank's positions; the partial softmaxes are joined over the axes
      that split the sequence (``tp.softmax_combine``), then the rank's own heads
      go through its ``wo`` rows (the whole ``wo`` without a group).
    """
    cd = _dtype(cfg.compute_dtype)
    g, split = p.tp_group, p.seq_split
    d = k.shape[3]
    kvm = p.kvm
    if split is not None:
        q, kvm = tp.gather(q, 2, g), split.kvm
    elif g is not None:
        _, lo, kl = kv_heads_read(cfg, g)
        k, v = k[:, :, lo:lo + kl], v[:, :, lo:lo + kl]
    logits = torch.einsum("bqhd,bshd->bhqs", q, k.to(cd)[:, :, kvm, :]).to(torch.float32)
    logits = logits * softmax_scale(cfg, d)
    logits = torch.where(valid[None, None], logits, -1e30)
    if split is None:
        probs = torch.softmax(logits, dim=-1).to(cd)
        out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(cd)[:, :, kvm, :])
    else:
        top = logits.amax(dim=-1)  # (B, H, 1)
        e = torch.exp(logits - top[..., None])
        o = torch.einsum("bhqs,bshd->bqhd", e.to(cd), v.to(cd)[:, :, kvm, :]).to(torch.float32)
        out = tp.softmax_combine(top, e.sum(dim=-1), o, split.groups).to(cd)
        if g is not None:
            out = tp.part(out, 2, g)
    return tp.reduce(torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd)), g)


def attention_decode(cfg: ArchConfig, p: Attention, x: torch.Tensor, cache: dict[str, torch.Tensor],
                     pos: int | torch.Tensor, *, rope: bool = True) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode against a KV cache (``_attend_cache``), rotated at ``pos``
    unless ``rope`` is off (whisper's decoder has none).

    cache = {"k": (B, Smax, K, D), "v": same}; pos: the current length.  The
    new K/V row is written into ``cache`` in place (the reference returns
    updated copies); ``decode_step`` hands each layer a fresh copy.  With
    ``p.seq_split`` the cache holds global positions ``offset`` to
    ``offset + Smax``, masked by those, and only the rank whose shard holds
    ``pos`` writes the new row.

    ``pos`` is an int or the cache's 0-d int32 tensor on ``x``'s device.  A tensor is
    never read back to the host: the row goes in by ``index_copy_`` and the masks
    compare on the device, the same values as from an int, so that the step can be
    captured as a CUDA graph.  It must lie inside the cache, and a sequence-split
    cache refuses it (its rank's shard decides on the host who writes the row).
    Where the call fits ``kernels/decode_attention`` (``_decode_kernel_fits``: on the
    card, bfloat16, a device ``pos``, unsharded) it attends there, reading the cache's
    rows up to ``pos`` in place; elsewhere through ``_attend_cache``.
    """
    cd = _dtype(cfg.compute_dtype)
    g, split = p.tp_group, p.seq_split
    on_device = isinstance(pos, torch.Tensor)
    if on_device and split is not None:
        raise ValueError("attention_decode: a sequence-split cache takes pos as an int, not a tensor")
    if not rope:
        positions = None
    elif on_device:
        positions = pos.view(1, 1).expand(x.shape[0], 1)
    else:
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x.to(cd), positions, whole_kv=True)
    if g is not None and cfg.num_kv_heads % g.size == 0:
        k_new, v_new = tp.gather(k_new, 2, g), tp.gather(v_new, 2, g)
    k_cache, v_cache = cache["k"], cache["v"]
    smax = k_cache.shape[1]
    offset = 0 if split is None else split.offset
    if on_device:
        row = pos.view(1).long()
        k_cache.index_copy_(1, row, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, row, v_new.to(v_cache.dtype))
    elif offset <= pos < offset + smax:
        k_cache[:, pos - offset] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, pos - offset] = v_new[:, 0].to(v_cache.dtype)
    if _decode_kernel_fits(cfg, p, q, k_cache, v_cache, pos):
        out = da_ops.decode_attention(q, k_cache, v_cache, p.kvm, pos, scale=softmax_scale(cfg, q.shape[3]),
                                      window=cfg.sliding_window)
        return tp.reduce(torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd)), g), {"k": k_cache, "v": v_cache}
    kpos = torch.arange(smax, device=x.device)[None, :] + offset
    valid = kpos <= pos
    if cfg.sliding_window:
        valid &= kpos > pos - cfg.sliding_window
    return _attend_cache(cfg, p, q, k_cache, v_cache, valid), {"k": k_cache, "v": v_cache}


def _decode_kernel_fits(cfg: ArchConfig, p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: int | torch.Tensor) -> bool:
    """Whether ``attention_decode`` attends through ``kernels/decode_attention``, which reads the
    cache's rows up to ``pos`` in place, in place of ``_attend_cache``: on the card, in bfloat16
    (compute and cache), ``pos`` on the device (the hybrid families' replayed step), neither a
    ``tp_group`` nor a ``seq_split``, and a head size the kernel takes.  Each call that fits has
    ``_attend_cache``'s semantics, with float32 scores and probabilities."""
    d = q.shape[3]
    return (q.is_cuda and isinstance(pos, torch.Tensor) and p.tp_group is None and p.seq_split is None
            and q.dtype == k.dtype == v.dtype == torch.bfloat16 and d % 8 == 0 and d <= da_kernel.MAX_HEAD_DIM)


def cross_kv(cfg: ArchConfig, p: Attention, enc_out: torch.Tensor, *,
             whole_kv: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder's K/V for a decoder layer's cross-attention (whisper), (B, F, K, D)
    without biases, as the reference computes them.  Under TP: the kv heads the
    rank reads, or with ``whole_kv`` every kv head (for the cache), as
    ``attention_prefill`` gives them."""
    cd = _dtype(cfg.compute_dtype)
    g = p.tp_group
    wk, wv, _, _ = _kv_weights(cfg, p, whole_kv)
    x = tp.copy(enc_out, g)
    k = torch.einsum("bfd,dhk->bfhk", x, wk.to(cd))
    v = torch.einsum("bfd,dhk->bfhk", x, wv.to(cd))
    if whole_kv and g is not None and cfg.num_kv_heads % g.size == 0:
        k, v = tp.gather(k, 2, g), tp.gather(v, 2, g)
    return k, v


def cross_attention(cfg: ArchConfig, p: Attention, x: torch.Tensor, kv: tuple[torch.Tensor, torch.Tensor], *,
                    whole_kv: bool = False) -> torch.Tensor:
    """Decoder cross-attention over the encoder's K/V (whisper), as ``cross_kv``
    gives them (every kv head with ``whole_kv``): under TP the rank's q heads
    over the kv heads they read, its ``wo`` rows, then ``tp.reduce``."""
    cd = _dtype(cfg.compute_dtype)
    g = p.tp_group
    q = torch.einsum("bsd,dhk->bshk", tp.copy(x.to(cd), g), p.wq.to(cd))
    k, v = kv
    if whole_kv and g is not None:
        _, lo, kl = kv_heads_read(cfg, g)
        k, v = k[:, :, lo:lo + kl], v[:, :, lo:lo + kl]
    out = _sdpa(cfg, q, k.to(cd), v.to(cd), p.kvm, causal=False)
    return tp.reduce(torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd)), g)


def cross_attention_decode(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                           kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One token's cross-attention over the encoder's K/V in a decode's cache,
    every kv head and every frame valid (``_attend_cache``: whole, or with
    ``p.seq_split`` the rank's shard of the frames)."""
    cd = _dtype(cfg.compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", tp.copy(x.to(cd), p.tp_group), p.wq.to(cd))
    k, v = kv
    valid = torch.ones((1, k.shape[1]), dtype=torch.bool, device=k.device)
    return _attend_cache(cfg, p, q, k, v, valid)


# ----------------------------------------------------------------------- mlp
class MLP(nn.Module):
    """SwiGLU: ``down(silu(x @ gate) * (x @ up))``."""

    tp_group: tp.Group | None = None

    def __init__(self, d_model: int, d_ff: int, dtype, generator: torch.Generator, device):
        super().__init__()
        s_in, s_out = d_model**-0.5, d_ff**-0.5
        self.gate = _normal((d_model, d_ff), s_in, dtype, generator, device)
        self.up = _normal((d_model, d_ff), s_in, dtype, generator, device)
        self.down = _normal((d_ff, d_model), s_out, dtype, generator, device)


def mlp_init(d_model: int, d_ff: int, dtype, generator: torch.Generator, device) -> MLP:
    return MLP(d_model, d_ff, dtype, generator, device)


def scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    """``x * m``, or ``x`` itself where m is 1: a multiplier of 1 launches nothing."""
    return x if m == 1 else x * m


def mlp(p: MLP, x: torch.Tensor, compute_dtype: str, multipliers: tuple[float, ...] = ()) -> torch.Tensor:
    """``down(silu(g * (x @ gate)) * (x @ up)) * o`` with ``multipliers`` (g, o) (falcon_h1's µP;
    empty: both 1, and nothing is multiplied)."""
    cd = _dtype(compute_dtype)
    return tp.reduce(mlp_partial(p, tp.copy(x.to(cd), p.tp_group), cd, multipliers), p.tp_group)


def mlp_partial(p: MLP, x: torch.Tensor, cd: torch.dtype, multipliers: tuple[float, ...] = ()) -> torch.Tensor:
    """``mlp`` inside a region: ``x`` in ``cd`` has entered it, and under TP the
    result is this rank's part of the sum over the hidden columns."""
    g, o = multipliers or (1.0, 1.0)
    return scaled((F.silu(scaled(x @ p.gate.to(cd), g)) * (x @ p.up.to(cd))) @ p.down.to(cd), o)


class GeluMLP(nn.Module):
    """``gelu(x @ wi + bi) @ wo + bo``, the tanh form of GELU (``jax.nn.gelu``'s default).
    Under TP ``wi``/``bi`` are column-parallel and ``wo`` row-parallel."""

    tp_group: tp.Group | None = None

    def __init__(self, d_model: int, d_ff: int, dtype, generator: torch.Generator, device):
        super().__init__()
        self.wi = _normal((d_model, d_ff), d_model**-0.5, dtype, generator, device)
        self.bi = _param(torch.zeros(d_ff, dtype=dtype, device=device))
        self.wo = _normal((d_ff, d_model), d_ff**-0.5, dtype, generator, device)
        self.bo = _param(torch.zeros(d_model, dtype=dtype, device=device))


def gelu_mlp_init(d_model: int, d_ff: int, dtype, generator: torch.Generator, device) -> GeluMLP:
    return GeluMLP(d_model, d_ff, dtype, generator, device)


def gelu_mlp(p: GeluMLP, x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """Under TP the rank's hidden columns, their ``wo`` rows summed over the group;
    ``bo`` is added once, after the sum."""
    cd = _dtype(compute_dtype)
    x = tp.copy(x.to(cd), p.tp_group)
    h = F.gelu(x @ p.wi.to(cd) + p.bi.to(cd), approximate="tanh")
    return tp.reduce(h @ p.wo.to(cd), p.tp_group) + p.bo.to(cd)


# ----------------------------------------------------------------- embedding
class Embedding(nn.Module):
    tp_group: tp.Group | None = None

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        v = cfg.vocab_padded  # padded rows are inert (never indexed by tokens)
        self.embed = _normal((v, cfg.d_model), 0.02, dt, generator, device)
        if not cfg.tie_embeddings:
            self.unembed = _normal((cfg.d_model, v), cfg.d_model**-0.5, dt, generator, device)
        else:
            self.unembed = None


def embedding_init(cfg: ArchConfig, generator: torch.Generator, device) -> Embedding:
    return Embedding(cfg, generator, device)


def embed(cfg: ArchConfig, p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype, times ``cfg.embedding_multiplier`` where it is not 1."""
    if p.tp_group is not None:
        x = tp.embed_lookup(p.embed, tokens, _dtype(cfg.compute_dtype), p.tp_group)
    else:
        x = p.embed[tokens].to(_dtype(cfg.compute_dtype))
    return x * cfg.embedding_multiplier if cfg.embedding_multiplier != 1 else x


def unembed(cfg: ArchConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary, divided by ``cfg.logits_scaling`` where it is not 1; under TP over
    this rank's V/tp columns (``vocab_logits`` gathers them)."""
    cd = _dtype(cfg.compute_dtype)
    w = p.unembed if p.unembed is not None else p.embed.T
    logits = tp.copy(x.to(cd), p.tp_group) @ w.to(cd)
    return logits / cfg.logits_scaling if cfg.logits_scaling != 1 else logits


def vocab_logits(cfg: ArchConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """``unembed`` over the whole vocabulary, gathered over the group under TP."""
    return tp.gather(unembed(cfg, p, x), -1, p.tp_group)
