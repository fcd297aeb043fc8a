"""AdamW with decoupled weight decay, fp32 state, cosine LR schedule.

The reference's optimizer on named tensors: a model's ``named_parameters()``
(or any dict of tensors) take the place of its param tree, and the state is
``{"mu": {name: f32}, "nu": {name: f32}, "step": int32 0-d}``, on the
params' device.  ``update`` keeps the reference's arithmetic, and writes the
new params and state in place (the reference returns new trees and donates
the old ones); it reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


CHUNK = 64  # leaves per group of foreach calls: bounds the update's float32 temporaries


def named(params: nn.Module | dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The tensors a step updates, by name: a module's named parameters, or the dict itself."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def init(params: nn.Module | dict[str, torch.Tensor]) -> dict:
    ps = named(params)
    device = next(iter(ps.values())).device
    return {
        "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in ps.items()},
        "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in ps.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.stack([x.to(torch.float32).square().sum() for x in _leaves(tree)]).sum().sqrt()


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict[str, torch.Tensor], state: dict,
           params: nn.Module | dict[str, torch.Tensor], *, grad_norm: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One step: params and state in place; returns {"grad_norm", "lr"} as 0-d tensors.

    ``grad_norm`` is the global norm of the gradients where ``grads`` holds only
    this rank's shards of them (a sharded step); None computes it from ``grads``.
    """
    ps = named(params)
    state["step"] += 1
    step = state["step"].to(torch.float32)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    lr = lr_at(cfg, state["step"])
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step

    names = list(ps)
    for i in range(0, len(names), CHUNK):
        group = names[i:i + CHUNK]
        p = [ps[n] for n in group]
        mu = [state["mu"][n] for n in group]
        nu = [state["nu"][n] for n in group]
        g = torch._foreach_mul([grads[n].to(torch.float32) for n in group], scale)
        # mu2 = b1 * mu + (1 - b1) * g;  nu2 = b2 * nu + (1 - b2) * g^2
        torch._foreach_mul_(mu, cfg.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(nu, cfg.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
        del g
        # delta = mhat / (sqrt(nhat) + eps) + wd * p;  p2 = p - lr * delta
        den = torch._foreach_sqrt(torch._foreach_div(nu, b2c))
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(torch._foreach_div(mu, b1c), den)
        del den
        pf = [t.to(torch.float32) for t in p]
        torch._foreach_add_(delta, torch._foreach_mul(pf, cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        for t, new in zip(p, torch._foreach_sub(pf, delta)):
            t.copy_(new)
    return {"grad_norm": gnorm, "lr": lr}
