"""Minimal batched serving engine: admit -> prefill -> decode loop.

Uses the model's prefill/decode steps and the HybridCacheManager for
placement decisions (a token's bytes there are its K and V over the cache's
rows).  The engine runs on the card unless the caller passes
``device="cpu"``; its params must already sit on that device.  Where
``transformer.decode_graphable`` accepts them (an ssm, hybrid, zamba2 or
granitemoehybrid model on the card, not tensor-parallel) each decode step is a replayed CUDA graph
(``transformer.DecodeGraphs``, the engine's own, which refuses other params);
every other decode (dense, moe, vlm, encdec, the CPU) runs ``decode_step``
eagerly.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import get_model, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _device
from repro_torch.obs import span
from .cache_manager import CacheConfig, HybridCacheManager


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: torch.Tensor       # (S,) int
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 512, batch_size: int = 4,
                 device=None):
        self.device = _device(device)
        if any(p.device.type != self.device.type for p in params.parameters()):
            raise ValueError(f"ServeEngine: params must be on {self.device.type}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = params
        self.max_len = max_len
        self.batch_size = batch_size
        # K and V of a token in bf16 over the cache's K/V rows (``transformer.layer_rows``): zamba2's
        # sites, granitemoehybrid's attention layers; the ssm and hybrid families count every layer, as
        # the reference's engine counts them
        rows = cfg.num_layers if cfg.family in ("ssm", "hybrid") else transformer.kv_rows(cfg)
        bytes_per_token = 2 * max(cfg.num_kv_heads, 1) * cfg.resolved_head_dim * 2 * rows
        self.cache_mgr = HybridCacheManager(CacheConfig(
            bytes_per_token=bytes_per_token, slab_tokens=min(max_len // 2, 512),
            arena_tokens=max_len * batch_size,
        ))
        self._graphs = transformer.DecodeGraphs(cfg, params) if transformer.decode_graphable(cfg, params) else None

    def _decode(self, params, cache, tok):
        if self._graphs is not None:
            return self._graphs(params, cache, tok)
        return self.model.decode_step(self.cfg, params, cache, tok)

    @torch.inference_mode()
    def run_batch(self, requests: list[Request]) -> list[Request]:
        """Prefill a uniform batch then greedy-decode to completion.

        Every family but ssm keeps a positional cache of ``max_len`` rows: a
        request that needs more (its prompt, then each generated token but
        the last, which is never fed back) is refused with a ``ValueError``
        before any request of the batch is admitted.  A vlm's patch prefix
        does not count: prefill grows the cache by its length.  The stub
        frontends get zero inputs, as in the reference: ``num_patches``
        patch embeddings (vlm) and ``encoder_frames`` frame embeddings
        (encdec) per request.
        """
        assert len(requests) <= self.batch_size
        with span("serve.run_batch", lambda: f"batch={len(requests)} prompt={len(requests[0].prompt)} "
                  f"first={requests[0].seq_id} last={requests[-1].seq_id}"):
            with span("serve.admit"):
                batch = self._admit(requests)
            logits, cache = self.model.prefill(self.cfg, self.params, batch, self.max_len)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            steps = max(r.max_new_tokens for r in requests)
            for step in range(steps):
                with span("serve.read_tokens"):
                    toks = tok[:, 0].tolist()
                with span("serve.bookkeeping"):
                    for i, r in enumerate(requests):
                        if len(r.output) < r.max_new_tokens:
                            r.output.append(toks[i])
                            self.cache_mgr.extend(r.seq_id, len(r.prompt) + len(r.output))
                if all(len(r.output) >= r.max_new_tokens for r in requests):
                    break
                logits, cache = self._decode(self.params, cache, tok)
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            with span("serve.release"):
                for r in requests:
                    self.cache_mgr.release(r.seq_id)
        return requests

    def _admit(self, requests: list[Request]) -> dict[str, torch.Tensor]:
        """Check each request against ``max_len``, admit it to the cache pool, and put the
        batch's prompts (and a vlm's or encdec's stub frontend inputs) on the device."""
        if self.cfg.family != "ssm":
            for r in requests:
                need = len(r.prompt) + r.max_new_tokens - 1
                if need > self.max_len:
                    raise ValueError(
                        f"ServeEngine: request {r.seq_id} needs {need} cache positions "
                        f"(prompt {len(r.prompt)} + {r.max_new_tokens} new tokens - 1), "
                        f"more than max_len={self.max_len}"
                    )
        for r in requests:
            alloc = self.cache_mgr.admit(r.seq_id, len(r.prompt) + r.max_new_tokens)
            if alloc is None:
                raise RuntimeError("admission control: cache pool exhausted")
        prompts = torch.stack([r.prompt for r in requests]).to(self.device)
        batch = {"tokens": prompts}
        if self.cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (len(requests), self.cfg.num_patches, self.cfg.d_model), dtype=torch.float32, device=self.device
            )
        if self.cfg.family == "encdec":
            batch["frame_embeds"] = torch.zeros(
                (len(requests), self.cfg.encoder_frames, self.cfg.d_model), dtype=torch.float32, device=self.device
            )
        return batch
