"""Architecture configuration shared by every model family.

One dataclass covers the whole assigned pool (dense GQA, MoE, SSM, hybrid,
encoder-decoder, VLM backbone) and the port's three published hybrids: ``zamba2``,
Zamba2 (arXiv:2411.15242), ``granitemoehybrid``, IBM Granite 4.0-H (Mamba2 and
NoPE GQA mixers, each followed by a dropless MoE), and ``falcon_h1``, Falcon-H1
(RoPE GQA attention beside a Mamba2 Mixer in every layer, µP multipliers;
``models/transformer.py``).  Family-specific fields
are ignored by other families; the fields marked port-only have no
counterpart in the reference's config, and their defaults leave every other
family as the reference builds it.  ``reduced()`` derives the small
smoke-test variant of the same family (few layers, narrow width, tiny vocab)
used by per-arch CPU tests; the full configs are only ever lowered via
ShapeDtypeStruct in the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "zamba2", "granitemoehybrid", "falcon_h1", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 = full attention
    # mlp
    d_ff: int = 0
    # moe
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # granitemoehybrid, one chip's share of an expert-parallel layer (port-only)
    experts_held: int = 0             # experts held here, of the router's num_experts (0: all)
    expert_first: int = 0             # the first held expert's index among the router's outputs
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2-style shared attention block)
    attn_every: int = 0               # apply the shared attn block every k ssm layers
    # zamba2, the published form (port-only)
    hybrid_layer_ids: tuple[int, ...] = ()  # Mamba2 layers whose input a shared-block site adds to;
                                      # granitemoehybrid: its attention layers (the rest are Mamba2);
                                      # falcon_h1: every layer (each holds a K/V row beside its SSM row)
    num_mem_blocks: int = 0           # shared blocks, taken in turn by the sites
    adapter_rank: int = 0             # each site's LoRA rank on the block's MLP input projection
    mem_rope: bool = False            # RoPE in the shared blocks' attention
    ssm_ngroups: int = 1              # B/C groups: head h reads group h // (heads / groups)
    ssm_dt_min: float = 0.0           # dt floor after the softplus (0: none)
    # granitemoehybrid's scalar multipliers (port-only; the defaults change nothing)
    embedding_multiplier: float = 1.0  # the token embedding is scaled by it
    residual_multiplier: float = 1.0  # each mixer's and each MoE's output is scaled by it before the residual add
    attention_multiplier: float = 0.0  # the scores' scale (0: the family's rule, ``layers.softmax_scale``)
    logits_scaling: float = 1.0       # the head's logits are divided by it
    # falcon_h1's Mamba2 width and µP multipliers (port-only; the defaults change nothing and launch nothing)
    ssm_inner: int = 0                # the Mamba2 inner width, published mamba_d_ssm (0: d_model x ssm_expand)
    ssm_in_multiplier: float = 1.0    # the Mixer's input is scaled by it before its projections
    ssm_multipliers: tuple[float, ...] = ()  # the [z, x, B, C, dt] projections are scaled by these (empty: 1)
    ssm_out_multiplier: float = 1.0   # the Mixer's output is scaled by it before the residual add
    attention_out_multiplier: float = 1.0  # attention's output is scaled by it before the residual add
    mlp_multipliers: tuple[float, ...] = ()  # the SwiGLU's gate product and output are scaled by these (empty: 1)
    # encoder-decoder (whisper-style)
    encoder_layers: int = 0
    encoder_frames: int = 1500        # precomputed frame embeddings (stub frontend)
    # vlm (prefix patch embeddings, stub frontend)
    num_patches: int = 0
    # numerics / impl
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    attention_impl: str = "xla"       # xla | flash (Pallas kernel on TPU)
    remat: bool = True
    # distribution adjustments (see sharding.rules.pad_config_for_mesh):
    orig_num_heads: int = 0           # >0 when q heads were padded for TP
    vocab_pad_multiple: int = 1       # pad vocab (embedding rows only) for TP

    def __post_init__(self):
        # a configuration file gives the sites as a list; the config is frozen and hashable
        for key in ("hybrid_layer_ids", "ssm_multipliers", "mlp_multipliers"):
            object.__setattr__(self, key, tuple(getattr(self, key)))
        if len(self.ssm_multipliers) not in (0, 5) or len(self.mlp_multipliers) not in (0, 2):
            raise ValueError(f"ssm_multipliers takes [z, x, B, C, dt] and mlp_multipliers [gate, down]; got "
                             f"{self.ssm_multipliers} and {self.mlp_multipliers}")
        if self.family == "falcon_h1" and self.hybrid_layer_ids != tuple(range(self.num_layers)):
            raise ValueError(f"falcon_h1 holds attention beside Mamba2 in every layer: hybrid_layer_ids must list "
                             f"all {self.num_layers} layers, got {self.hybrid_layer_ids}")
        if self.experts_held and self.expert_first + self.experts_held > self.num_experts:
            raise ValueError(f"experts {self.expert_first}..{self.expert_first + self.experts_held - 1} held "
                             f"of a router over {self.num_experts}")

    # ---------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_inner or self.d_model * self.ssm_expand

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return self.ssm_ngroups

    @property
    def num_experts_held(self) -> int:
        return self.experts_held or self.num_experts

    def has_attention(self) -> bool:
        return self.family != "ssm"

    def subquadratic(self) -> bool:
        """True if long_500k is runnable (SSM / hybrid w/ windowed attention)."""
        return self.family in ("ssm", "hybrid")

    # ---------------------------------------------------------------- params
    def param_count(self) -> int:
        """Approximate parameter count N (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        if self.family in ("dense", "vlm", "moe", "encdec"):
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            if self.family == "moe":
                ffn = 3 * d * self.expert_d_ff * (self.num_experts + self.num_shared_experts)
                ffn += d * self.num_experts  # router
            else:
                ffn = 3 * d * self.d_ff
            per_layer = attn + ffn + 2 * d
            n = self.num_layers * per_layer + emb
            if self.family == "encdec":
                # encoder layers + cross-attention in decoder
                enc = self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
                cross = self.num_layers * attn
                n += enc + cross
            return n
        if self.family == "ssm":
            di, ns = self.ssm_d_inner, self.ssm_state
            per_layer = d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_num_heads) + di * d + di
            return self.num_layers * per_layer + emb
        if self.family == "hybrid":
            di, ns = self.ssm_d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_num_heads) + di * d + di
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            shared = attn + 3 * d * self.d_ff + 2 * d  # ONE shared block
            return self.num_layers * (mamba + 2 * d) + shared + emb
        if self.family == "zamba2":  # exact: every leaf of the model
            di, h, gn, w = self.ssm_d_inner, self.ssm_num_heads, self.ssm_groups * self.ssm_state, self.ssm_conv_width
            mamba = d * (2 * di + 2 * gn + h) + di * d + (w + 1) * (di + 2 * gn) + 3 * h + di + d
            attn = 2 * d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            block = attn + 3 * d * self.d_ff + 3 * d  # norms over [x, e] (2d) and before the MLP (d)
            site = self.adapter_rank * (d + 2 * self.d_ff) + d * d  # LoRA and the site's linear
            return (self.num_layers * mamba + self.num_mem_blocks * block + len(self.hybrid_layer_ids) * site
                    + emb + d)
        if self.family == "granitemoehybrid":  # exact: every leaf the program holds, its own experts alone
            di, h, gn, w = self.ssm_d_inner, self.ssm_num_heads, self.ssm_groups * self.ssm_state, self.ssm_conv_width
            mamba = d * (2 * di + 2 * gn + h) + di * d + (w + 1) * (di + 2 * gn) + 3 * h + di
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            moe = d * self.num_experts + 3 * d * self.expert_d_ff * (self.num_experts_held + self.num_shared_experts)
            na = len(self.hybrid_layer_ids)
            return (self.num_layers - na) * mamba + na * attn + self.num_layers * (moe + 2 * d) + emb + d
        if self.family == "falcon_h1":  # exact: every leaf, attention, Mamba2 and the MLP in each layer
            di, h, gn, w = self.ssm_d_inner, self.ssm_num_heads, self.ssm_groups * self.ssm_state, self.ssm_conv_width
            mamba = d * (2 * di + 2 * gn + h) + di * d + (w + 1) * (di + 2 * gn) + 3 * h + di
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            return self.num_layers * (attn + mamba + 3 * d * self.d_ff + 2 * d) + emb + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffn = 3 * d * self.expert_d_ff * (self.top_k + self.num_shared_experts)
        per_layer = attn + ffn + 2 * d + d * self.num_experts
        return self.num_layers * per_layer + self.vocab_size * d * 2

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests.  A zamba2 config keeps its blocks, its
        groups and three sites that use both blocks, over 8 layers; its heads stay MHA, each
        of 2 * d_model / heads, as the published attention derives them.  A granitemoehybrid
        config keeps 4 layers with attention at layer 1, every expert of 8 held, its
        multipliers and a shared expert twice an expert's width.  A falcon_h1 config keeps 2 layers,
        each with attention beside Mamba2, its groups, a Mamba2 inner width of 4 heads of 16 and
        its multipliers."""
        changes = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 if self.family != "hybrid" else 4),
            d_model=64,
            head_dim=16 if self.num_heads else 0,
            num_heads=max(0, min(self.num_heads, 4)),
            num_kv_heads=max(0, min(self.num_kv_heads, 2)),
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 8),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            expert_d_ff=32 if self.expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=32,
            num_patches=min(self.num_patches, 8),
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )
        if self.family == "zamba2":
            heads = changes["num_heads"]
            changes.update(num_layers=min(self.num_layers, 8), hybrid_layer_ids=(1, 4, 6), num_kv_heads=heads,
                           head_dim=2 * changes["d_model"] // heads, adapter_rank=min(self.adapter_rank, 8))
        if self.family == "granitemoehybrid":
            changes.update(num_layers=min(self.num_layers, 4), hybrid_layer_ids=(1,), experts_held=0, expert_first=0,
                           num_shared_experts=self.num_shared_experts)
        if self.family == "falcon_h1":
            changes.update(hybrid_layer_ids=tuple(range(changes["num_layers"])), ssm_inner=64)
        return dataclasses.replace(self, **changes)
