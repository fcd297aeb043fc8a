"""The 10 assigned architectures (exact public configs) + input shapes.

Sources per the assignment brief:
  mamba2-780m        [arXiv:2405.21060]        yi-34b        [arXiv:2403.04652]
  internvl2-26b      [arXiv:2404.16821]        qwen2.5-3b    [hf:Qwen/Qwen2.5-*]
  phi3-medium-14b    [arXiv:2404.14219]        qwen3-8b      [hf:Qwen/Qwen3-8B]
  whisper-medium     [arXiv:2212.04356]        deepseek-moe-16b [arXiv:2401.06066]
  qwen3-moe-30b-a3b  [hf:Qwen/Qwen3-30B-A3B]   zamba2-2.7b   [arXiv:2411.15242]

Shapes (all archs):
  train_4k     seq 4096,   global batch 256   -> train_step
  prefill_32k  seq 32768,  global batch 32    -> prefill_step
  decode_32k   seq 32768,  global batch 128   -> serve_step (1 token, KV cache)
  long_500k    seq 524288, global batch 1     -> serve_step; SSM/hybrid only
                                                 (full-attention archs skip —
                                                 DESIGN.md §Arch-applicability)
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

ARCHS: dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


MAMBA2_780M = _register(ArchConfig(
    name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
))

INTERNVL2_26B = _register(ArchConfig(
    name="internvl2-26b", family="vlm", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92553,
    num_patches=256, rope_theta=1_000_000.0,
))

YI_34B = _register(ArchConfig(
    name="yi-34b", family="dense", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    rope_theta=5_000_000.0,
))

QWEN25_3B = _register(ArchConfig(
    name="qwen2.5-3b", family="dense", num_layers=36, d_model=2048,
    num_heads=16, num_kv_heads=2, head_dim=128, d_ff=11008, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
))

PHI3_MEDIUM = _register(ArchConfig(
    name="phi3-medium-14b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=10, head_dim=128, d_ff=17920, vocab_size=100352,
))

QWEN3_8B = _register(ArchConfig(
    name="qwen3-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
))

WHISPER_MEDIUM = _register(ArchConfig(
    name="whisper-medium", family="encdec", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_frames=1500,
))

DEEPSEEK_MOE_16B = _register(ArchConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, vocab_size=102400,
    num_experts=64, num_shared_experts=2, top_k=6, expert_d_ff=1408,
))

QWEN3_MOE_30B = _register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=4, head_dim=128, vocab_size=151936,
    num_experts=128, num_shared_experts=0, top_k=8, expert_d_ff=768,
    qk_norm=True, rope_theta=1_000_000.0,
))

ZAMBA2_27B = _register(ArchConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, head_dim=80, d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(arch: str, shape: str) -> bool:
    """long_500k runs only for sub-quadratic (SSM/hybrid) archs."""
    if shape == "long_500k":
        return ARCHS[arch].subquadratic()
    return True


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if applicable(a, s)]
