"""Model zoo: uniform function interface over the ported families.

``get_model(cfg)`` returns a namespace with:
    init_params(cfg, generator, device) -> LM / forward(cfg, params, batch) -> (logits, aux)
    loss_fn(cfg, params, batch) -> scalar loss (batch holds "tokens" and "labels")
    init_cache(cfg, batch, max_len, dtype, device)
    prefill(cfg, params, batch, max_len) -> (last_logits, cache)
    decode_step(cfg, params, cache, tokens) -> (logits, cache)
"""
from __future__ import annotations

import types

from . import transformer
from .config import ArchConfig


def get_model(cfg: ArchConfig):
    transformer._check_family(cfg)
    return types.SimpleNamespace(
        init_params=transformer.init_params,
        forward=transformer.forward,
        loss_fn=transformer.loss_fn,
        init_cache=transformer.init_cache,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
    )


__all__ = ["ArchConfig", "get_model", "transformer"]
