"""The system under test, built around the benchmark's weights.

The program (``repro_torch``) builds its model with every parameter on the
``meta`` device; the benchmark's weights then become its parameters
(``weights.attach``), so that nothing is drawn twice.  Its one buffer, each
attention's q-head -> kv-head map, is the program's own.
"""
from __future__ import annotations

import dataclasses

import torch

from . import weights as wmod


def arch_config(arch: dict):
    from repro_torch.models.config import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    unknown = set(arch) - names
    if unknown:
        raise ValueError(f"configuration keys the program does not know: {sorted(unknown)}")
    return ArchConfig(**arch)


def _fill_buffers(module: torch.nn.Module, cfg, device) -> None:
    from repro_torch.models.layers import kv_head_map

    for name, buf in list(module.named_buffers()):
        if not buf.is_meta:
            continue
        owner, _, leaf = name.rpartition(".")
        if leaf != "kvm":
            raise ValueError(f"buffer {name} has no known value: the benchmark cannot build this model")
        module.get_submodule(owner).kvm = kv_head_map(cfg.num_heads, cfg.num_kv_heads, cfg.orig_num_heads).to(device)


def build(cfg, ref, arch: dict, seed: int, device):
    """The program's model, holding the benchmark's weights."""
    from repro_torch.models import get_model

    specs = ref.param_specs(arch)
    dtype = getattr(torch, arch["param_dtype"])
    w = wmod.make(specs, seed, device, dtype, ref.const_value)
    model = get_model(cfg).init_params(cfg, torch.Generator(), device="meta")
    wmod.attach(model, w)
    _fill_buffers(model, cfg, device)
    return model


def reference_weights(ref, arch: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The same weights again from the seed, in float32, for the reference."""
    w = wmod.make(ref.param_specs(arch), seed, device, getattr(torch, arch["param_dtype"]), ref.const_value)
    return {k: v.float() for k, v in w.items()}


def applied_weights(ref, arch: dict) -> int:
    """Weights that multiply each token in a forward pass (the shared block at each of its sites)."""
    return wmod.count(ref.param_specs(arch), lambda name: ref.weight_uses(arch, name))


def head_weights(arch: dict) -> int:
    return arch["d_model"] * arch["vocab_size"]
