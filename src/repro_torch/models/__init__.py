"""Model zoo: uniform function interface over all assigned families.

``get_model(cfg)`` returns a namespace with:
    init_params(cfg, generator, device) -> module / forward(cfg, params, batch) -> (logits, aux)
    loss_fn(cfg, params, batch) -> scalar loss (batch holds "tokens" and "labels")
    init_cache(cfg, batch, max_len, dtype, device)
    prefill(cfg, params, batch, max_len) -> (last_logits, cache)
    decode_step(cfg, params, cache, tokens) -> (logits, cache)

The encdec family (whisper) takes ``frame_embeds`` in its batch, the vlm
family optional ``patch_embeds``.
"""
from __future__ import annotations

import types

from . import encdec, transformer
from .config import ArchConfig


def get_model(cfg: ArchConfig):
    mod = encdec if cfg.family == "encdec" else transformer
    return types.SimpleNamespace(
        init_params=mod.init_params,
        forward=mod.forward,
        loss_fn=mod.loss_fn,
        init_cache=mod.init_cache,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
    )


__all__ = ["ArchConfig", "get_model", "transformer", "encdec"]
