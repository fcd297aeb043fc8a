"""Deterministic synthetic data pipeline.

Produces per-host token batches with a counter-based PRNG (numpy's
``SeedSequence`` over the seed, the global step and the host), so every host
materializes exactly its shard without coordination — the property that
matters at 1000+ nodes: restart-stable, order-independent, no shared
filesystem in the hot path.  Stub modality frontends (VLM patches / audio
frames) synthesize embeddings the same way.

``host_batch`` is the reference's numpy code as it stands, so both packages
give byte-identical batches.  ``batch_struct`` gives meta-device tensors of
the reference's shapes and dtypes: tokens and labels stay int32, which every
model of the port takes (its embedding indexes with them, its loss widens
the labels itself).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0


def host_batch(cfg: ArchConfig, dcfg: DataConfig, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
    """Materialize this host's slice of the global batch for `step` (numpy)."""
    assert dcfg.global_batch % num_hosts == 0
    per_host = dcfg.global_batch // num_hosts
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step, host_id]))
    tokens = rng.integers(0, cfg.vocab_size, (per_host, dcfg.seq_len + 1), dtype=np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((per_host, cfg.num_patches, cfg.d_model), dtype=np.float32) * 0.02
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.standard_normal((per_host, cfg.encoder_frames, cfg.d_model), dtype=np.float32) * 0.02
    return batch


def batch_struct(cfg: ArchConfig, seq_len: int, global_batch: int) -> dict:
    """Abstract global batch: meta-device tensors (for shape checks and dry runs)."""

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    b = {
        "tokens": meta((global_batch, seq_len), torch.int32),
        "labels": meta((global_batch, seq_len), torch.int32),
    }
    if cfg.family == "vlm":
        b["patch_embeds"] = meta((global_batch, cfg.num_patches, cfg.d_model), torch.float32)
    if cfg.family == "encdec":
        b["frame_embeds"] = meta((global_batch, cfg.encoder_frames, cfg.d_model), torch.float32)
    return b
