"""Decoder-only LM composition for the dense / MoE / SSM / hybrid / VLM families.

``init_params`` returns an ``nn.Module`` (``LM``) whose layers sit in an
``nn.ModuleList``; the functions take it where the reference takes its param
tree, and the reference's ``lax.scan`` over stacked layers becomes a loop
(its ``lax.cond`` an ``if``).  ``forward`` and ``loss_fn`` follow the
caller's grad mode, as the reference's functions may be differentiated;
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.
With ``cfg.remat`` set and grad enabled, each layer body runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward keeps each layer's input and recomputes the rest.  The
hybrid (zamba2-style) family runs Mamba2 layers and applies ONE
weight-shared attention block (``shared_block``) after every
``attn_every``-th layer; each application site has its own K/V cache (weights
shared, caches not).  The cache keeps the reference's stacked layouts:

- ssm: ``ssm.state`` (layers, B, H, P, N) float32, ``ssm.conv``
  (layers, B, conv_width-1, conv_dim) in the cache dtype, ``pos``;
- hybrid: the ssm leaves, and ``k`` and ``v`` (sites, B, max_len, K, hd);
- dense, moe and vlm: ``k`` and ``v`` (layers, B, max_len, K, hd), ``pos``.

With ``attention_impl="flash"`` the full-sequence attention of ``forward``
(and so of ``loss_fn``) runs the flash-attention kernel; ``prefill`` and
``decode_step`` use the plain attention whatever it says, as the reference does.

Under tensor parallelism (the modules' ``tp_group``, set by ``train/step.py``;
a MoE layer splits its experts' hidden columns, ``models/moe.py``)
``forward`` returns this rank's vocabulary columns of the logits, which
``loss_fn`` and ``nll_sum`` take as they are; ``prefill`` and
``decode_step`` gather them over the group.  A vlm's patch prefix joins the
residual stream after the vocab-parallel embedding, which is whole on every
rank, and leaves it before the unembedding.  In a sharded decode the K/V
leaves may hold the rank's shard of the sequence (``Attention.seq_split``),
while ``pos`` stays global.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ArchConfig
from ..sharding import tp
from .layers import (
    _device,
    _dtype,
    attention,
    attention_decode,
    attention_init,
    attention_prefill,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
    vocab_logits,
)
from .moe import moe_apply, moe_init
from .ssm import Mamba2Mixer, ssm_init_cache


def _check(cfg: ArchConfig, params: nn.Module) -> None:
    """The modules (an ``LM`` or an ``EncDec``) compute with the config they were built with; refuse another.

    ``attention_impl`` is read per call and built into no module, so it may differ.
    """
    built = dataclasses.replace(params.cfg, attention_impl=cfg.attention_impl)
    if built != cfg:
        diff = {k: (v, getattr(cfg, k)) for k, v in vars(built).items() if getattr(cfg, k) != v}
        raise ValueError(f"params were built for another config: (built, passed) {diff}")


# ------------------------------------------------------------------- params
class Mamba2Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        self.ssm = Mamba2Mixer(cfg, generator, device)


class DenseLayer(nn.Module):
    """Attention then an MLP, or with ``moe`` the MoE layer; also the hybrid's shared block."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device, *, moe: bool = False):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = rmsnorm_init(cfg.d_model, dt, device)
        self.ln2 = rmsnorm_init(cfg.d_model, dt, device)
        self.attn = attention_init(cfg, generator, device)
        if moe:
            self.moe = moe_init(cfg, generator, device)
        else:
            self.mlp = mlp_init(cfg.d_model, cfg.d_ff, dt, generator, device)


_LAYER = {
    "ssm": Mamba2Layer,
    "hybrid": Mamba2Layer,
    "dense": DenseLayer,
    "vlm": DenseLayer,
    "moe": functools.partial(DenseLayer, moe=True),
}


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        if cfg.family not in _LAYER:
            raise ValueError(f"family {cfg.family!r} is not a decoder-only LM (encdec: models/encdec.py)")
        self.cfg = cfg
        self.embedding = embedding_init(cfg, generator, device)
        self.final_norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        layer = _LAYER[cfg.family]
        self.layers = nn.ModuleList(layer(cfg, generator, device) for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_block = DenseLayer(cfg, generator, device)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None) -> LM:
    """Random params with the reference's scales (not its random bits).

    ``device`` None means the card.  Without a ``generator`` one on that
    device is seeded with 0.
    """
    dev = _device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LM(cfg, generator, dev)


# ------------------------------------------------------------------ forward
def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _ffn(cfg: ArchConfig, lp: DenseLayer, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's second half, x + ffn(ln2(x)), and the MoE aux loss (zero without MoE)."""
    xn = rmsnorm(lp.ln2, x, cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = moe_apply(cfg, lp.moe, xn)
        return x + out, aux
    return x + mlp(lp.mlp, xn, cfg.compute_dtype), torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_body(cfg: ArchConfig, lp: DenseLayer, x: torch.Tensor, positions: torch.Tensor):
    x = x + attention(cfg, lp.attn, rmsnorm(lp.ln1, x, cfg.norm_eps), positions)
    return _ffn(cfg, lp, x)


def _shared_site(cfg: ArchConfig, i: int) -> bool:
    """Whether the hybrid's shared block follows Mamba2 layer ``i``; its site is (i+1)//attn_every - 1."""
    return cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0


def remat(cfg: ArchConfig, body, *args):
    """``body(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat`` is set and
    grad is enabled, as the reference wraps its scan body in ``jax.checkpoint``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _mamba2_body(cfg: ArchConfig, params: LM, i: int, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The reference's scan body for the ssm and hybrid families: Mamba2 layer ``i``
    and, at a shared site, the shared block."""
    lp = params.layers[i]
    x = x + lp.ssm(rmsnorm(lp.norm, x, cfg.norm_eps))
    if _shared_site(cfg, i):
        x, _ = _dense_body(cfg, params.shared_block, x, positions)
    return x


def _embed_inputs(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> torch.Tensor:
    """Token embeddings; for the vlm family the patch embeddings come first."""
    x = embed(cfg, params.embedding, batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def forward(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits over token positions, aux_loss).

    The aux loss is the MoE layers' load-balancing loss summed over layers
    (zero for the other families).
    """
    _check(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    if cfg.family in ("ssm", "hybrid"):
        for i in range(len(params.layers)):
            x = remat(cfg, _mamba2_body, cfg, params, i, x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        auxs = []
        for lp in params.layers:
            x, a = remat(cfg, _dense_body, cfg, lp, x, positions)
            auxs.append(a)
        aux = torch.stack(auxs).sum()
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:]
    return unembed(cfg, params.embedding, x), aux


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            g: tp.Group | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The next-token negative log likelihood summed over labels >= 0, and their count, in float32.
    With a model-axis group ``g`` the logits are this rank's vocabulary columns (``tp.nll_sum``)."""
    if g is not None:
        return tp.nll_sum(logits, labels, g)
    lg = logits.to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, g: tp.Group | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over labels >= 0."""
    total, count = nll_sum(logits, labels, g)
    return total / count.clamp(min=1.0)


def loss_fn(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux), in float32.  Labels < 0 are ignored."""
    logits, aux = forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"], params.embedding.tp_group) + 0.01 * aux


# -------------------------------------------------------------------- cache
def _kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict[str, torch.Tensor]:
    """Zero K/V, one row per attention layer (the hybrid: per shared-block site); none for ssm."""
    if cfg.family == "ssm":
        return {}
    rows = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers
    shape = (rows, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zero cache; ``max_len`` is unused by the ssm family; ``device`` None means the card."""
    dev = _device(device)
    cache: dict[str, Any] = _kv_cache(cfg, batch, max_len, dtype, dev)
    if cfg.family in ("ssm", "hybrid"):
        caches = ssm_init_cache(cfg, batch, dtype, dev)
        cache["ssm"] = {k: v.expand(cfg.num_layers, *v.shape).clone() for k, v in caches.items()}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


# ------------------------------------------------------------------- decode
def _attn_block_decode(cfg: ArchConfig, lp: DenseLayer, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: int) -> torch.Tensor:
    """One token through an attention block; writes its K/V row into ``k``/``v`` in place."""
    h, _ = attention_decode(cfg, lp.attn, rmsnorm(lp.ln1, x, cfg.norm_eps), {"k": k, "v": v}, pos)
    return _ffn(cfg, lp, x + h)[0]


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: LM, cache, tokens: torch.Tensor):
    """One-token decode.  tokens: (B, 1) -> (logits (B,1,V), new cache).

    The input cache is left as it was: the new K/V are one copy per step,
    into which each attention block writes its row in place.  ``pos`` is the
    global position; in a sharded decode each K/V leaf (the hybrid: each
    site's) may be the rank's sequence shard, which ``attention_decode`` reads
    through its attention's ``seq_split``.
    """
    _check(cfg, params)
    x = embed(cfg, params.embedding, tokens)
    new_cache: dict[str, Any] = {"pos": cache["pos"] + 1}
    if cfg.family != "ssm":
        pos = int(cache["pos"])
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
        new_cache["k"], new_cache["v"] = new_k, new_v
    if cfg.family in ("ssm", "hybrid"):
        states, convs = [], []
        for i, lp in enumerate(params.layers):
            sc = {"state": cache["ssm"]["state"][i], "conv": cache["ssm"]["conv"][i]}
            h, new_sc = lp.ssm.decode(rmsnorm(lp.norm, x, cfg.norm_eps), sc)
            x = x + h
            states.append(new_sc["state"])
            convs.append(new_sc["conv"])
            if _shared_site(cfg, i):
                site = (i + 1) // cfg.attn_every - 1
                x = _attn_block_decode(cfg, params.shared_block, x, new_k[site], new_v[site], pos)
        new_cache["ssm"] = {"state": torch.stack(states), "conv": torch.stack(convs)}
    else:
        for i, lp in enumerate(params.layers):
            x = _attn_block_decode(cfg, lp, x, new_k[i], new_v[i], pos)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return vocab_logits(cfg, params.embedding, x), new_cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: LM, batch: dict[str, Any], max_len: int):
    """Process a full prompt, returning (last-position logits, primed cache).

    For the ssm and hybrid families the cache holds each Mamba2 layer's final
    recurrent state and the pre-conv tail that decode's conv continues from;
    for every family with attention it holds each layer's (the hybrid: each
    site's) K/V, zero past the prompt.  Attention here is the plain path
    whatever ``attention_impl`` says, as in the reference.  A vlm patch prefix
    extends the cached sequence, so ``max_len`` grows by its length.
    """
    _check(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    cd = _dtype(cfg.compute_dtype)
    max_len = max(max_len + (s - batch["tokens"].shape[1]), s)
    positions = _positions(b, s, x.device)
    cache: dict[str, Any] = _kv_cache(cfg, b, max_len, cd, x.device)

    def attn_block(lp: DenseLayer, x: torch.Tensor, row: int) -> torch.Tensor:
        h, k, v = attention_prefill(cfg, lp.attn, rmsnorm(lp.ln1, x, cfg.norm_eps), positions)
        x, _ = _ffn(cfg, lp, x + h)
        cache["k"][row, :, :s] = k.to(cache["k"].dtype)
        cache["v"][row, :, :s] = v.to(cache["v"].dtype)
        return x

    if cfg.family in ("ssm", "hybrid"):
        states, convs = [], []
        for i, lp in enumerate(params.layers):
            h, state, conv_tail = lp.ssm(rmsnorm(lp.norm, x, cfg.norm_eps), return_state=True)
            x = x + h
            states.append(state.to(torch.float32))
            convs.append(conv_tail.to(cd))
            if _shared_site(cfg, i):
                x = attn_block(params.shared_block, x, (i + 1) // cfg.attn_every - 1)
        cache["ssm"] = {"state": torch.stack(states), "conv": torch.stack(convs)}
    else:
        for i, lp in enumerate(params.layers):
            x = attn_block(lp, x, i)
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = vocab_logits(cfg, params.embedding, x[:, -1:])
    return logits, cache
