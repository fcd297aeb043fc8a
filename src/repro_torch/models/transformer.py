"""Decoder-only LM composition; the port has the ``ssm`` and ``dense`` families so far.

``init_params`` returns an ``nn.Module`` (``LM``) whose layers sit in an
``nn.ModuleList``; the functions take it where the reference takes its param
tree, and the reference's ``lax.scan`` over stacked layers becomes a loop.
``remat`` is ignored: this is inference.  The cache keeps the reference's
stacked layouts:

- ssm: ``ssm.state`` (layers, B, H, P, N) float32, ``ssm.conv``
  (layers, B, conv_width-1, conv_dim) in the cache dtype, ``pos``;
- dense: ``k`` and ``v`` (layers, B, max_len, K, hd) in the cache dtype, ``pos``.

With ``attention_impl="flash"`` the full-sequence attention of ``forward``
(and so of ``loss_fn``) runs the flash-attention kernel; ``prefill`` and
``decode_step`` use the plain attention whatever it says, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from .config import ArchConfig
from .layers import (
    _device,
    _dtype,
    _project_qkv,
    _sdpa,
    attention,
    attention_decode,
    attention_init,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from .ssm import Mamba2Mixer, ssm_init_cache

_PORTED = ("ssm", "dense")
_NOT_PORTED = (
    "family {!r} is not ported yet: ROADMAP.md §1 lists the LM models "
    "(MoE, hybrid, VLM, encdec) as a later slice"
)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(_NOT_PORTED.format(cfg.family))


def _check(cfg: ArchConfig, params: "LM") -> None:
    """The modules compute with the config they were built with; refuse another.

    ``attention_impl`` is read per call and built into no module, so it may differ.
    """
    _check_family(cfg)
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
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = rmsnorm_init(cfg.d_model, dt, device)
        self.ln2 = rmsnorm_init(cfg.d_model, dt, device)
        self.attn = attention_init(cfg, generator, device)
        self.mlp = mlp_init(cfg.d_model, cfg.d_ff, dt, generator, device)


_LAYER = {"ssm": Mamba2Layer, "dense": DenseLayer}


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = embedding_init(cfg, generator, device)
        self.final_norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        layer = _LAYER[cfg.family]
        self.layers = nn.ModuleList(layer(cfg, generator, device) for _ in range(cfg.num_layers))


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None) -> LM:
    """Random params with the reference's scales (not its random bits).

    ``device`` None means the card.  Without a ``generator`` one on that
    device is seeded with 0.
    """
    _check_family(cfg)
    dev = _device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LM(cfg, generator, dev)


# ------------------------------------------------------------------ forward
def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _dense_body(cfg: ArchConfig, lp: DenseLayer, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = x + attention(cfg, lp.attn, rmsnorm(lp.ln1, x, cfg.norm_eps), positions)
    return x + mlp(lp.mlp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg.compute_dtype)


@torch.inference_mode()
def forward(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits over token positions, aux_loss)."""
    _check(cfg, params)
    x = embed(cfg, params.embedding, batch["tokens"])
    if cfg.family == "ssm":
        for lp in params.layers:
            x = x + lp.ssm(rmsnorm(lp.norm, x, cfg.norm_eps))
    else:
        positions = _positions(x.shape[0], x.shape[1], x.device)
        for lp in params.layers:
            x = _dense_body(cfg, lp, x, positions)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(cfg, params.embedding, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.inference_mode()
def loss_fn(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux), in float32.  Labels < 0 are ignored."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    lg = logits.to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (logz - gold) * mask
    loss = nll.sum() / mask.sum().clamp(min=1.0)
    return loss + 0.01 * aux


# -------------------------------------------------------------------- cache
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zero cache; ``max_len`` is unused by the ssm family; ``device`` None means the card."""
    _check_family(cfg)
    dev = _device(device)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        caches = ssm_init_cache(cfg, batch, dtype, dev)
        return {"ssm": {k: v.expand(cfg.num_layers, *v.shape).clone() for k, v in caches.items()}, "pos": pos}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": pos,
    }


# ------------------------------------------------------------------- decode
@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: LM, cache, tokens: torch.Tensor):
    """One-token decode.  tokens: (B, 1) -> (logits (B,1,V), new cache)."""
    _check(cfg, params)
    x = embed(cfg, params.embedding, tokens)
    if cfg.family == "ssm":
        states, convs = [], []
        for i, lp in enumerate(params.layers):
            sc = {"state": cache["ssm"]["state"][i], "conv": cache["ssm"]["conv"][i]}
            h, new_sc = lp.ssm.decode(rmsnorm(lp.norm, x, cfg.norm_eps), sc)
            x = x + h
            states.append(new_sc["state"])
            convs.append(new_sc["conv"])
        new_cache = {
            "ssm": {"state": torch.stack(states), "conv": torch.stack(convs)},
            "pos": cache["pos"] + 1,
        }
    else:
        pos = int(cache["pos"])
        # one copy per step; attention_decode then writes each layer's row in place
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
        for i, lp in enumerate(params.layers):
            xn = rmsnorm(lp.ln1, x, cfg.norm_eps)
            h, _ = attention_decode(cfg, lp.attn, xn, {"k": new_k[i], "v": new_v[i]}, pos)
            x = x + h
            x = x + mlp(lp.mlp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg.compute_dtype)
        new_cache = {"k": new_k, "v": new_v, "pos": cache["pos"] + 1}
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(cfg, params.embedding, x), new_cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: LM, batch: dict[str, Any], max_len: int):
    """Process a full prompt, returning (last-position logits, primed cache).

    For the ssm family the cache holds each layer's final recurrent state and
    the pre-conv tail that decode's conv continues from.  For the dense family
    it holds each layer's K/V, zero past the prompt; attention here is the
    plain path whatever ``attention_impl`` says, as in the reference.
    """
    _check(cfg, params)
    x = embed(cfg, params.embedding, batch["tokens"])
    b, s = x.shape[:2]
    cd = _dtype(cfg.compute_dtype)
    if cfg.family == "ssm":
        states, convs = [], []
        for lp in params.layers:
            h, state, conv_tail = lp.ssm(rmsnorm(lp.norm, x, cfg.norm_eps), return_state=True)
            x = x + h
            states.append(state.to(torch.float32))
            convs.append(conv_tail.to(cd))
        cache = {"ssm": {"state": torch.stack(states), "conv": torch.stack(convs)}}
    else:
        positions = _positions(b, s, x.device)
        cache = init_cache(cfg, b, max(max_len, s), cd, x.device)
        for i, lp in enumerate(params.layers):
            xn = rmsnorm(lp.ln1, x, cfg.norm_eps)
            q, k, v = _project_qkv(cfg, lp.attn, xn.to(cd), positions)
            out = _sdpa(cfg, q, k, v, lp.attn.kvm, causal=True, window=cfg.sliding_window)
            x = x + torch.einsum("bshk,hkd->bsd", out, lp.attn.wo.to(cd))
            x = x + mlp(lp.mlp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg.compute_dtype)
            cache["k"][i, :, :s] = k.to(cache["k"].dtype)
            cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(cfg, params.embedding, x[:, -1:])
    return logits, cache
