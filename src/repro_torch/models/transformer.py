"""Decoder-only LM composition; the port has the ``ssm`` family so far.

``init_params`` returns an ``nn.Module`` (``LM``) whose layers sit in an
``nn.ModuleList``; the functions take it where the reference takes its param
tree, and the reference's ``lax.scan`` over stacked layers becomes a loop.
``remat`` is ignored: this is inference.  The cache keeps the reference's
stacked layout: ``ssm.state`` (layers, B, H, P, N) float32, ``ssm.conv``
(layers, B, conv_width-1, conv_dim) in the cache dtype, ``pos``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .config import ArchConfig
from .layers import _device, _dtype, embed, embedding_init, rmsnorm, rmsnorm_init, unembed
from .ssm import Mamba2Mixer, ssm_init_cache

_NOT_PORTED = (
    "family {!r} is not ported yet: ROADMAP.md §1 lists the LM configs and models "
    "(attention, MoE, hybrid, encdec) as a later slice"
)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(_NOT_PORTED.format(cfg.family))


def _check(cfg: ArchConfig, params: "LM") -> None:
    """The modules compute with the config they were built with; refuse another."""
    _check_family(cfg)
    if params.cfg != cfg:
        diff = {k: (v, getattr(cfg, k)) for k, v in vars(params.cfg).items() if getattr(cfg, k) != v}
        raise ValueError(f"params were built for another config: (built, passed) {diff}")


# ------------------------------------------------------------------- params
class Mamba2Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        self.ssm = Mamba2Mixer(cfg, generator, device)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = embedding_init(cfg, generator, device)
        self.final_norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        self.layers = nn.ModuleList(Mamba2Layer(cfg, generator, device) for _ in range(cfg.num_layers))


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
@torch.inference_mode()
def forward(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits over token positions, aux_loss)."""
    _check(cfg, params)
    x = embed(cfg, params.embedding, batch["tokens"])
    for lp in params.layers:
        x = x + lp.ssm(rmsnorm(lp.norm, x, cfg.norm_eps))
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(cfg, params.embedding, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -------------------------------------------------------------------- cache
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zero cache; ``max_len`` is unused by the ssm family; ``device`` None means the card."""
    _check_family(cfg)
    dev = _device(device)
    caches = ssm_init_cache(cfg, batch, dtype, dev)
    return {
        "ssm": {k: v.expand(cfg.num_layers, *v.shape).clone() for k, v in caches.items()},
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


# ------------------------------------------------------------------- decode
@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: LM, cache, tokens: torch.Tensor):
    """One-token decode.  tokens: (B, 1) -> (logits (B,1,V), new cache)."""
    _check(cfg, params)
    x = embed(cfg, params.embedding, tokens)
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
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(cfg, params.embedding, x), new_cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: LM, batch: dict[str, Any], max_len: int):
    """Process a full prompt, returning (last-position logits, primed cache).

    For the ssm family the cache holds each layer's final recurrent state and
    the pre-conv tail that decode's conv continues from.
    """
    _check(cfg, params)
    x = embed(cfg, params.embedding, batch["tokens"])
    s = x.shape[1]
    cd = _dtype(cfg.compute_dtype)
    states, convs = [], []
    for lp in params.layers:
        h, state, conv_tail = lp.ssm(rmsnorm(lp.norm, x, cfg.norm_eps), return_state=True)
        x = x + h
        states.append(state.to(torch.float32))
        convs.append(conv_tail.to(cd))
    cache = {
        "ssm": {"state": torch.stack(states), "conv": torch.stack(convs)},
        "pos": torch.tensor(s, dtype=torch.int32, device=x.device),
    }
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(cfg, params.embedding, x[:, -1:])
    return logits, cache
