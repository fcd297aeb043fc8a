"""The benchmark's weights, made on the device from the seed, and handed to the program.

Every weight is drawn from one ``torch.Generator`` on the run's device in one
``randn`` call over a flat buffer, laid out so that weights of one scale are
contiguous: a scale is one multiply.  The program and the reference get the
same tensors; the reference makes them again from the seed where the program
may have changed its copy (training).
"""
from __future__ import annotations

import torch


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make(specs, seed: int, device, dtype=torch.float32, const_value=None) -> dict[str, torch.Tensor]:
    """{name: tensor} for ``specs`` [(name, shape, ("normal", std) | ("const", kind))].
    ``const_value(kind, shape, device)`` fills the constants."""
    normal = sorted((s for s in specs if s[2][0] == "normal"), key=lambda s: s[2][1])
    sizes = [torch.Size(shape).numel() for _, shape, _ in normal]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, off, group = {}, 0, None
    for (name, shape, (_, std)), n in zip(normal, sizes):
        if group is None or group[0] != std:
            if group is not None:
                flat[group[1]:off].mul_(group[0])
            group = (std, off)
        out[name] = flat[off:off + n].view(shape)
        off += n
    if group is not None:
        flat[group[1]:off].mul_(group[0])
    for name, shape, (kind, what) in specs:
        if kind == "const":
            out[name] = const_value(what, shape, device).to(dtype)
    return {name: out[name] for name, _, _ in specs}


def attach(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> torch.nn.Module:
    """Make ``weights`` the parameters of ``module`` (built on the ``meta`` device),
    sharing their storage; its names and shapes must be the reference's exactly."""
    named = dict(module.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"the program's parameters differ from the reference's layout: "
                         f"only the program {sorted(set(named) - set(weights))[:5]}, "
                         f"only the reference {sorted(set(weights) - set(named))[:5]}")
    for name, p in named.items():
        if tuple(p.shape) != tuple(weights[name].shape) or p.dtype != weights[name].dtype:
            raise ValueError(f"{name}: the program holds {tuple(p.shape)} {p.dtype}, "
                             f"the reference {tuple(weights[name].shape)} {weights[name].dtype}")
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, torch.nn.Parameter(weights[name], requires_grad=p.requires_grad))
    return module


def count(specs, uses) -> int:
    """Weights applied to each token in a forward pass: each weight's elements times ``uses(name)``."""
    return sum(torch.Size(shape).numel() * uses(name) for name, shape, _ in specs)
