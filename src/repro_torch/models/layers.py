"""Shared neural layers used by the ssm family: RMSNorm and the embedding.

Parameters are ``nn.Module``s whose leaves carry the reference's names and
layouts (``embed`` as (V, D), ``unembed`` as (D, V), ``scale``), so that
``convert.load_jax_params`` maps the reference's param tree 1:1.  Attention,
the MLPs and RoPE are not ported yet.
"""
from __future__ import annotations

import torch
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
