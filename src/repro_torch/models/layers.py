"""Shared neural layers: RMSNorm, RoPE, GQA attention (with KV cache), SwiGLU,
and the embedding.

Parameters are ``nn.Module``s whose leaves carry the reference's names and
layouts (``embed`` as (V, D), ``unembed`` as (D, V), ``scale``, ``wq`` as
(D, H, hd), ``wo`` as (H, hd, D)), so that ``convert.load_jax_params`` maps
the reference's param tree 1:1.  The functions take the config and the
module, as the reference's take the config and the param tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    return nn.Parameter(t, requires_grad=False)  # inference only


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
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params.scale.to(torch.float32)).to(dt)


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
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, k = cfg.num_heads, cfg.num_kv_heads
        dt = _dtype(cfg.param_dtype)
        scale = d**-0.5
        self.wq = _normal((d, h, hd), scale, dt, generator, device)
        self.wk = _normal((d, k, hd), scale, dt, generator, device)
        self.wv = _normal((d, k, hd), scale, dt, generator, device)
        self.wo = _normal((h, hd, d), scale, dt, generator, device)
        if cfg.orig_num_heads and cfg.orig_num_heads < h:
            # TP head padding: padded q heads are exact zeros (contribute nothing)
            mask = (torch.arange(h, device=device) < cfg.orig_num_heads).to(dt)
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


def _project_qkv(cfg: ArchConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor | None):
    cd = _dtype(cfg.compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(cd))
    if cfg.qkv_bias:
        q = q + p.bq.to(cd)
        k = k + p.bk.to(cd)
        v = v + p.bv.to(cd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
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
    logits = logits * d**-0.5
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


def _check_flash_heads(cfg: ArchConfig, h: int, kh: int) -> None:
    """The kernel reads kv head h // (H/K); refuse a config whose kv_head_map differs."""
    if h % kh or not torch.equal(kv_head_map(h, kh, cfg.orig_num_heads), torch.arange(h) // (h // kh)):
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

        _check_flash_heads(cfg, q.shape[2], k.shape[2])
        out = fa_ops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        out = _sdpa(cfg, q, k, v, p.kvm, causal=causal, window=cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd))


def attention_decode(cfg: ArchConfig, p: Attention, x: torch.Tensor, cache: dict[str, torch.Tensor],
                     pos: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode against a KV cache.

    cache = {"k": (B, Smax, K, D), "v": same}; pos: the current length.  The
    new K/V row is written into ``cache`` in place (the reference returns
    updated copies); ``decode_step`` hands each layer a fresh copy.
    """
    cd = _dtype(cfg.compute_dtype)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x.to(cd), positions)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    smax, d = k_cache.shape[1], k_cache.shape[3]
    logits = torch.einsum("bqhd,bshd->bhqs", q, k_cache.to(cd)[:, :, p.kvm, :]).to(torch.float32)
    logits = logits * d**-0.5
    kpos = torch.arange(smax, device=x.device)[None, :]
    valid = kpos <= pos
    if cfg.sliding_window:
        valid &= kpos > pos - cfg.sliding_window
    logits = torch.where(valid[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(cd)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v_cache.to(cd)[:, :, p.kvm, :])
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(cd))
    return y, {"k": k_cache, "v": v_cache}


# ----------------------------------------------------------------------- mlp
class MLP(nn.Module):
    """SwiGLU: ``down(silu(x @ gate) * (x @ up))``."""

    def __init__(self, d_model: int, d_ff: int, dtype, generator: torch.Generator, device):
        super().__init__()
        s_in, s_out = d_model**-0.5, d_ff**-0.5
        self.gate = _normal((d_model, d_ff), s_in, dtype, generator, device)
        self.up = _normal((d_model, d_ff), s_in, dtype, generator, device)
        self.down = _normal((d_ff, d_model), s_out, dtype, generator, device)


def mlp_init(d_model: int, d_ff: int, dtype, generator: torch.Generator, device) -> MLP:
    return MLP(d_model, d_ff, dtype, generator, device)


def mlp(p: MLP, x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    cd = _dtype(compute_dtype)
    x = x.to(cd)
    g = x @ p.gate.to(cd)
    u = x @ p.up.to(cd)
    return (F.silu(g) * u) @ p.down.to(cd)


# ----------------------------------------------------------------- embedding
class Embedding(nn.Module):
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
    return p.embed[tokens].to(_dtype(cfg.compute_dtype))


def unembed(cfg: ArchConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    cd = _dtype(cfg.compute_dtype)
    w = p.unembed if p.unembed is not None else p.embed.T
    return x.to(cd) @ w.to(cd)
