"""Whisper-style encoder-decoder backbone (audio family).

As in the reference, the conv/mel frontend is a stub: the batch carries
precomputed frame embeddings ``frame_embeds`` (B, frames, d_model).  The rest
is the real architecture: sinusoidal encoder positions, learned decoder
positions, pre-LayerNorm blocks with GELU MLPs, decoder causal
self-attention and cross-attention over the encoder output, no RoPE
(whisper uses absolute positions).

``init_params`` returns an ``EncDec`` module whose leaves carry the
reference's names (``embedding.embed``, ``dec_pos``, ``enc_layers.{i}...``,
``dec_layers.{i}...``, ``enc_norm``, ``dec_norm``), so that
``convert.load_jax_params`` maps the reference's tree 1:1.  The cache adds
``cross_k`` and ``cross_v`` (layers, B, frames, K, hd), the encoder's K/V per
decoder layer, computed once by ``prefill``.

Under tensor parallelism (``tp_group`` on the modules, set by
``train/step.py``) each attention runs on the rank's heads, each GELU MLP on
its hidden columns, and the tied token table and ``dec_pos`` are split by
rows: the embedding sums both lookups' partial rows in one reduction, and
``forward`` returns the rank's vocabulary columns of the logits (``prefill``
and ``decode_step`` gather them).  A sharded decode's self- and
cross-attention read K/V that may be the rank's sequence shard
(``Attention.seq_split``, ``layers._attend_cache``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn

from ..obs import span
from .config import ArchConfig
from ..sharding import tp
from .layers import (
    _device,
    _dtype,
    _normal,
    _project_qkv,
    _sdpa,
    attention_decode,
    attention_init,
    attention_prefill,
    cross_attention,
    cross_attention_decode,
    cross_kv,
    gelu_mlp,
    gelu_mlp_init,
    layernorm,
    layernorm_init,
    sinusoid_positions,
)
from .transformer import _check, cross_entropy, remat

MAX_DECODER_POS = 65536  # learned decoder positions (covers the 32k shapes)


class EncLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = layernorm_init(cfg.d_model, dt, device)
        self.ln2 = layernorm_init(cfg.d_model, dt, device)
        self.attn = attention_init(cfg, generator, device)
        self.mlp = gelu_mlp_init(cfg.d_model, cfg.d_ff, dt, generator, device)


class DecLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = layernorm_init(cfg.d_model, dt, device)
        self.lnx = layernorm_init(cfg.d_model, dt, device)
        self.ln2 = layernorm_init(cfg.d_model, dt, device)
        self.self_attn = attention_init(cfg, generator, device)
        self.cross_attn = attention_init(cfg, generator, device)
        self.mlp = gelu_mlp_init(cfg.d_model, cfg.d_ff, dt, generator, device)


class TokenEmbedding(nn.Module):
    """The decoder's token table, (V, D); the logits reuse it (tied).  Its
    ``tp_group`` is the model's: the table and ``dec_pos`` split by rows."""

    tp_group: tp.Group | None = None

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.embed = _normal((cfg.vocab_padded, cfg.d_model), 0.02, _dtype(cfg.param_dtype), generator, device)


class EncDec(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embedding = TokenEmbedding(cfg, generator, device)
        self.dec_pos = _normal((MAX_DECODER_POS, cfg.d_model), 0.01, dt, generator, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator, device) for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator, device) for _ in range(cfg.num_layers))
        self.enc_norm = layernorm_init(cfg.d_model, dt, device)
        self.dec_norm = layernorm_init(cfg.d_model, dt, device)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None) -> EncDec:
    """Random params with the reference's scales (not its random bits).

    ``device`` None means the card.  Without a ``generator`` one on that
    device is seeded with 0.
    """
    if cfg.family != "encdec":
        raise ValueError(f"family {cfg.family!r} is not encdec (decoder-only LMs: models/transformer.py)")
    dev = _device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return EncDec(cfg, generator, dev)


# ------------------------------------------------------------------ encoder
def encode(cfg: ArchConfig, params: EncDec, frame_embeds: torch.Tensor) -> torch.Tensor:
    cd = _dtype(cfg.compute_dtype)
    f = frame_embeds.shape[1]
    x = frame_embeds.to(cd) + sinusoid_positions(f, cfg.d_model, frame_embeds.device).to(cd)[None]
    for lp in params.enc_layers:
        x = remat(cfg, _enc_body, cfg, lp, x)
    return layernorm(params.enc_norm, x, cfg.norm_eps)


def _enc_body(cfg: ArchConfig, lp: EncLayer, x: torch.Tensor) -> torch.Tensor:
    cd = _dtype(cfg.compute_dtype)
    q, k, v = _project_qkv(cfg, lp.attn, layernorm(lp.ln1, x, cfg.norm_eps), None)
    h = _sdpa(cfg, q, k, v, lp.attn.kvm, causal=False)
    x = x + tp.reduce(torch.einsum("bshk,hkd->bsd", h, lp.attn.wo.to(cd)), lp.attn.tp_group)
    return x + gelu_mlp(lp.mlp, layernorm(lp.ln2, x, cfg.norm_eps), cfg.compute_dtype)


# ------------------------------------------------------------------ decoder
def _dec_tail(cfg: ArchConfig, lp: DecLayer, x: torch.Tensor, kv: tuple[torch.Tensor, torch.Tensor],
              cross=cross_attention) -> torch.Tensor:
    """Cross-attention (``cross``) over the encoder's K/V, then the GELU MLP."""
    x = x + cross(cfg, lp.cross_attn, layernorm(lp.lnx, x, cfg.norm_eps), kv)
    return x + gelu_mlp(lp.mlp, layernorm(lp.ln2, x, cfg.norm_eps), cfg.compute_dtype)


def _embed_tokens(cfg: ArchConfig, params: EncDec, tokens: torch.Tensor, start: int) -> torch.Tensor:
    """Token embeddings plus the learned positions from ``start``.  Under TP each
    rank looks up the rows of both tables it holds, and one reduction sums them."""
    cd = _dtype(cfg.compute_dtype)
    g = params.embedding.tp_group
    if g is not None:
        index = torch.arange(start, start + tokens.shape[1], device=tokens.device)
        rows = tp.embed_rows(params.embedding.embed, tokens, cd, g)
        return tp.reduce(rows + tp.embed_rows(params.dec_pos, index, cd, g)[None], g)
    pos = params.dec_pos[start:start + tokens.shape[1]].to(cd)
    return params.embedding.embed[tokens].to(cd) + pos[None]


def _logits(cfg: ArchConfig, params: EncDec, x: torch.Tensor) -> torch.Tensor:
    """Logits over the tied table's rows: under TP this rank's vocabulary columns."""
    cd = _dtype(cfg.compute_dtype)
    x = tp.copy(layernorm(params.dec_norm, x, cfg.norm_eps), params.embedding.tp_group)
    return torch.einsum("bsd,vd->bsv", x, params.embedding.embed.to(cd))


def _dec_body(cfg: ArchConfig, lp: DecLayer, x: torch.Tensor, enc_out: torch.Tensor, whole_kv: bool = False):
    """The reference's decoder scan body: the layer's cross K/V, self-attention, then
    ``_dec_tail``.  Returns the new x, the self-attention K/V and the cross K/V,
    under TP over every kv head with ``whole_kv`` (prefill's cache), else over the
    kv heads the rank read."""
    kv = cross_kv(cfg, lp.cross_attn, enc_out, whole_kv=whole_kv)
    h, k, v = attention_prefill(cfg, lp.self_attn, layernorm(lp.ln1, x, cfg.norm_eps), None, whole_kv=whole_kv)
    cross = functools.partial(cross_attention, whole_kv=whole_kv)
    return _dec_tail(cfg, lp, x + h, kv, cross), k, v, kv


def _prefix(cfg: ArchConfig, params: EncDec, batch: dict[str, Any], cache: dict[str, Any] | None = None):
    """The decoder over the whole prompt; fills ``cache``'s K/V and cross K/V when given."""
    enc_out = encode(cfg, params, batch["frame_embeds"])
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed_tokens(cfg, params, tokens, 0)
    for i, lp in enumerate(params.dec_layers):
        x, k, v, kv = remat(cfg, _dec_body, cfg, lp, x, enc_out, cache is not None)
        if cache is not None:
            cache["k"][i, :, :s] = k.to(cache["k"].dtype)
            cache["v"][i, :, :s] = v.to(cache["v"].dtype)
            cache["cross_k"][i], cache["cross_v"][i] = kv
    return x


def forward(cfg: ArchConfig, params: EncDec, batch: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: ``tokens`` (B, S) and ``frame_embeds`` (B, F, D) -> (logits (B, S, V), zero aux)."""
    _check(cfg, params)
    x = _prefix(cfg, params, batch)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: EncDec, batch: dict[str, Any]) -> torch.Tensor:
    """Next-token cross entropy in float32.  Labels < 0 are ignored."""
    logits, _ = forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"], params.embedding.tp_group)


# -------------------------------------------------------------------- cache
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zero cache; ``device`` None means the card."""
    dev = _device(device)
    hd, L = cfg.resolved_head_dim, cfg.num_layers
    self_shape = (L, batch, max_len, cfg.num_kv_heads, hd)
    cross_shape = (L, batch, cfg.encoder_frames, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dtype, device=dev),
        "v": torch.zeros(self_shape, dtype=dtype, device=dev),
        "cross_k": torch.zeros(cross_shape, dtype=dtype, device=dev),
        "cross_v": torch.zeros(cross_shape, dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: EncDec, batch: dict[str, Any], max_len: int):
    """Encode the frames and run the prompt, returning (last-position logits, primed cache)."""
    with span("model.prefill"):
        _check(cfg, params)
        b, s = batch["tokens"].shape
        f = batch["frame_embeds"].shape[1]
        cache = init_cache(dataclasses.replace(cfg, encoder_frames=f), b, max(max_len, s),
                           _dtype(cfg.compute_dtype), batch["tokens"].device)
        x = _prefix(cfg, params, batch, cache)
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
        with span("model.head"):
            return tp.gather(_logits(cfg, params, x[:, -1:]), -1, params.embedding.tp_group), cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: EncDec, cache, tokens: torch.Tensor):
    """One-token decode; cross K/V comes precomputed from prefill.

    The input cache is left as it was: the new self-attention K/V are one
    copy per step, into which each layer writes its row in place
    (``attention_decode``, without RoPE).  In a sharded decode the K/V and the
    cross K/V may each be the rank's shard of its sequence, read through each
    attention's ``seq_split``; ``pos`` stays global.
    """
    with span("model.decode_step"):
        _check(cfg, params)
        pos = int(cache["pos"])
        with span("model.embed"):
            x = _embed_tokens(cfg, params, tokens, pos)
        with span("model.new_cache"):
            new_k, new_v = cache["k"].clone(), cache["v"].clone()
        for i, lp in enumerate(params.dec_layers):
            with span("model.attention", ("row", i)):
                h, _ = attention_decode(cfg, lp.self_attn, layernorm(lp.ln1, x, cfg.norm_eps),
                                        {"k": new_k[i], "v": new_v[i]}, pos, rope=False)
                x = _dec_tail(cfg, lp, x + h, (cache["cross_k"][i], cache["cross_v"][i]), cross_attention_decode)
        new_cache = dict(cache)
        new_cache["k"], new_cache["v"], new_cache["pos"] = new_k, new_v, cache["pos"] + 1
        with span("model.head"):
            return tp.gather(_logits(cfg, params, x), -1, params.embedding.tp_group), new_cache
