"""Train / prefill / decode step builders.

``make_train_fn`` returns ``train_step(params, opt_state, batch) -> (params,
opt_state, metrics)``, the reference's un-jitted step: ``params`` is the
model (an ``nn.Module`` from ``init_params``) and ``opt_state`` comes from
``repro_torch.optim.adamw.init``.  The step updates both in place and
returns the same objects, as the reference donates its buffers; ``metrics``
holds ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the params'
device, read back by no one inside the step.  Optional hooks: gradient
compression (``repro_torch.train.compress``, without error state, as the
reference, over the reference's tensors: each layer leaf stacked over the
layers) and microbatched gradient accumulation.

On the card the Mamba2 and flash-attention layers run their CUDA kernels
forward; their backward is the gradient of the plain version, recomputed
(``kernels/*/ops.py``).  The sharded ``make_train_step`` and the abstract
shapes of params, optimizer state and cache need the sharding rules, which
the port does not have yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.convert import STACKED
from repro_torch.models import get_model
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw


class _Loss(nn.Module):
    """The model's loss as a module's forward, so ``torch.func.functional_call`` can swap its leaves."""

    def __init__(self, cfg: ArchConfig, model: nn.Module):
        super().__init__()
        self.cfg, self.model = cfg, model

    def forward(self, batch):
        return get_model(self.cfg).loss_fn(self.cfg, self.model, batch)


def _stack_layers(grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference's tree stacks each layer leaf over the layers (``layers/mlp/gate``
    is (L, D, F)); group the port's per-layer grads the same way, so that per-tensor
    compression sees the reference's tensors."""
    parts: dict[str, list[tuple[int, torch.Tensor]]] = {}
    for name, g in grads.items():
        stack, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        if stack in STACKED and i.isdigit():
            parts.setdefault(f"{stack}.{leaf}", []).append((int(i), g))
        else:
            parts[name] = g
    return {k: torch.stack([g for _, g in sorted(v, key=lambda t: t[0])]) if isinstance(v, list) else v
            for k, v in parts.items()}


def _unstack_layers(stacked: dict[str, torch.Tensor], names) -> dict[str, torch.Tensor]:
    """Undo ``_stack_layers``: the port's per-layer names, in ``names``' order."""
    out = {}
    for name in names:
        stack, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        out[name] = stacked[f"{stack}.{leaf}"][int(i)] if stack in STACKED and i.isdigit() else stacked[name]
    return out


def make_train_fn(cfg: ArchConfig, ocfg: adamw.AdamWConfig | None = None, *, compress: str = "none",
                  accum_steps: int = 1, grad_dtype: str = "float32"):
    """The train-step function.

    ``grad_dtype='bfloat16'`` differentiates w.r.t. a bf16 copy of the params
    (mixed precision): gradients — and therefore the data-parallel reduction
    on the wire — are bf16, halving the gradient collective.  The fp32 master
    weights still receive the update (adamw casts grads to fp32 internally).
    """
    ocfg = ocfg or adamw.AdamWConfig()
    m = get_model(cfg)

    def value_and_grad(params: nn.Module, batch):
        named = dict(params.named_parameters())
        loss = m.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), materialize_grads=True)
        return loss.detach(), dict(zip(named, grads))

    def train_step(params: nn.Module, opt_state: dict, batch: dict):
        if grad_dtype != "float32":
            dt = getattr(torch, grad_dtype)
            cast = {
                f"model.{n}": p.detach().to(dt).requires_grad_() if p.dtype == torch.float32 else p
                for n, p in params.named_parameters()
            }
            loss = torch.func.functional_call(_Loss(cfg, params), cast, (batch,))
            leaves = list(cast.values())
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
            grads = dict(zip((n[len("model."):] for n in cast), grads))
            metrics = adamw.update(ocfg, grads, opt_state, params)
            metrics["loss"] = loss.detach()
            return params, opt_state, metrics
        if accum_steps > 1:
            loss = torch.zeros((), dtype=torch.float32, device=opt_state["step"].device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.named_parameters()}
            for i in range(accum_steps):
                mb = {k: x[i * (x.shape[0] // accum_steps):(i + 1) * (x.shape[0] // accum_steps)]
                      for k, x in batch.items()}
                mloss, mgrads = value_and_grad(params, mb)
                loss = loss + mloss
                for n, g in mgrads.items():
                    grads[n] += g
            loss = loss / accum_steps
            grads = {n: g / accum_steps for n, g in grads.items()}
        else:
            loss, grads = value_and_grad(params, batch)
        if compress != "none":
            from repro_torch.train.compress import compress_grads

            grads = _unstack_layers(compress_grads(_stack_layers(grads), method=compress), list(grads))
        metrics = adamw.update(ocfg, grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_fn(cfg: ArchConfig, max_len: int):
    m = get_model(cfg)

    def prefill_step(params, batch):
        return m.prefill(cfg, params, batch, max_len)

    return prefill_step


def make_decode_fn(cfg: ArchConfig):
    m = get_model(cfg)

    def serve_step(params, cache, tokens):
        logits, new_cache = m.decode_step(cfg, params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_tok, new_cache

    return serve_step
