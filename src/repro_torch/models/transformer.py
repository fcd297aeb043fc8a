"""Decoder-only LM composition for the dense / MoE / SSM / hybrid / zamba2 / granitemoehybrid / falcon_h1 / VLM
families.

``init_params`` returns an ``nn.Module`` (``LM``) whose layers sit in an
``nn.ModuleList``; the functions take it where the reference takes its param
tree, and the reference's ``lax.scan`` over stacked layers becomes a loop
(its ``lax.cond`` an ``if``).  ``forward`` and ``loss_fn`` follow the
caller's grad mode, as the reference's functions may be differentiated;
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.
With ``cfg.remat`` set and grad enabled, each layer body runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward keeps each layer's input and recomputes the rest.

One walk, ``_walk``, holds the layer order for ``forward``, ``prefill`` and
``decode_step`` in every family: a dense, moe or vlm layer is attention then
the FFN; the ssm, hybrid and zamba2 families run a loop of Mamba2 layers, into
which the hybrid (zamba2-style) family puts ONE weight-shared attention block
(``shared_block``) after every ``attn_every``-th layer, and zamba2 its sites
before theirs.  Each shared-block site has its own K/V row (weights shared,
caches not).  A granitemoehybrid layer is a mixer, Mamba2 or (at the layers
``hybrid_layer_ids`` names) attention, then the MoE.  A falcon_h1 layer runs
attention and the Mamba2 Mixer side by side on one normed input, then the MLP.  The three steps differ
only in the two hooks they hand the walk: how attention runs at a K/V row, and
how the Mamba2 mixer runs at its row of the SSM cache.

The zamba2 family is the published Zamba2 (arXiv:2411.15242; transformers'
``modeling_zamba2.py``), which the port alone holds.  Its Mamba2 layer i
computes ``x + mamba(rmsnorm(x + t_i))``, where t_i is zero except at the
sites ``cfg.hybrid_layer_ids``: site j runs shared block j mod
``num_mem_blocks`` on ``rmsnorm(concat(x, e))`` (e the token embedding,
carried to every site): attention over the 2 x d_model input (RoPE where
``mem_rope``, scores scaled by (head_dim / 2)^-0.5), ``rmsnorm``, then a
GELU-gated MLP whose input projection adds the site's own LoRA; the site's own
linear then maps the block's output to t_j.  The block has no residual of its
own.

The granitemoehybrid family is IBM Granite 4.0-H (transformers'
``modeling_granitemoehybrid.py``), which the port alone holds.  Layer i computes
``x + m * mixer(rmsnorm(x))``, the mixer NoPE attention (GQA, scores scaled by
``attention_multiplier``) at the layers ``hybrid_layer_ids`` names and Mamba2
elsewhere, then ``x + m * (moe(u) + shared(u))`` with u = rmsnorm(x): the
dropless MoE over the experts held here and the shared expert
(``moe.moe_dropless``); m is ``residual_multiplier``.  The embedding is scaled
by ``embedding_multiplier`` and the logits divided by ``logits_scaling``
(``layers.embed``, ``layers.unembed``).

The falcon_h1 family is Falcon-H1 (transformers' ``modeling_falcon_h1.py``), which the
port alone holds.  Layer i computes ``u = rmsnorm(x)``, then ``x + s * mamba(u) +
o * attention(u)`` (s and o the ``ssm_out`` and ``attention_out`` multipliers; the
published ``attention_in_multiplier`` is 1 and is not held; RoPE GQA attention, scores scaled by
``attention_multiplier``, which holds the published key multiplier times head_dim^-0.5,
so K is cached unscaled), then ``x + mlp(rmsnorm(x))`` with the MLP's two multipliers
(``layers.mlp``).  The Mixer's inner width is its own (``ssm_inner``) and its five
projections carry µP scales (``models/ssm.py``).  Every layer holds K/V row i and SSM row
i.  The head is untied.  The cache keeps the reference's stacked layouts:

- ssm: ``ssm.state`` (layers, B, H, P, N) float32, ``ssm.conv``
  (layers, B, conv_width-1, conv_dim) in the cache dtype, ``pos``;
- hybrid and zamba2: the ssm leaves, and ``k`` and ``v`` (sites, B, max_len, K, hd);
- granitemoehybrid: the ssm leaves over its Mamba2 layers alone, and ``k`` and
  ``v`` over its attention layers alone (``layer_rows`` gives each layer's rows);
- falcon_h1: the ssm leaves and ``k`` and ``v``, each over every layer;
- dense, moe and vlm: ``k`` and ``v`` (layers, B, max_len, K, hd), ``pos``.

With ``attention_impl="flash"`` the full-sequence attention of ``forward``
(and so of ``loss_fn``) runs the flash-attention kernel; ``prefill`` and
``decode_step`` use the plain attention whatever it says, as the reference does.

Under tensor parallelism (the modules' ``tp_group``, set by ``train/step.py``;
a MoE layer splits its experts' hidden columns, ``models/moe.py``)
``forward`` returns this rank's vocabulary columns of the logits, which
``loss_fn`` and ``nll_sum`` take as they are; ``prefill`` and
``decode_step`` gather them over the group.  A vlm's patch prefix joins the
residual stream after the vocab-parallel embedding, which is whole on every
rank, and leaves it before the unembedding.  In a sharded decode the K/V
leaves may hold the rank's shard of the sequence (``Attention.seq_split``),
while ``pos`` stays global.

``DecodeGraphs`` replays the Mamba2-loop families' ``decode_step``
on the card as a captured CUDA graph, where ``decode_graphable`` allows it;
``ServeEngine`` owns one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..obs import span
from .config import ArchConfig
from ..sharding import tp
from .layers import (
    Attention,
    _device,
    _dtype,
    _normal,
    attention,
    attention_decode,
    attention_init,
    attention_prefill,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    scaled,
    unembed,
    vocab_logits,
)
from .moe import moe_apply, moe_dropless, moe_init
from .ssm import Mamba2Mixer, ssm_init_cache


def _check(cfg: ArchConfig, params: nn.Module) -> None:
    """The modules (an ``LM`` or an ``EncDec``) compute with the config they were built with; refuse another.

    ``attention_impl`` is read per call and built into no module, so it may differ.
    """
    built = dataclasses.replace(params.cfg, attention_impl=cfg.attention_impl)
    if built != cfg:
        diff = {k: (v, getattr(cfg, k)) for k, v in vars(built).items() if getattr(cfg, k) != v}
        raise ValueError(f"params were built for another config: (built, passed) {diff}")


# ------------------------------------------------------------------- params
class Mamba2Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        self.norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        self.ssm = Mamba2Mixer(cfg, generator, device)


class DenseLayer(nn.Module):
    """Attention then an MLP, or with ``moe`` the MoE layer; also the hybrid's shared block."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device, *, moe: bool = False):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = rmsnorm_init(cfg.d_model, dt, device)
        self.ln2 = rmsnorm_init(cfg.d_model, dt, device)
        self.attn = attention_init(cfg, generator, device)
        if moe:
            self.moe = moe_init(cfg, generator, device)
        else:
            self.mlp = mlp_init(cfg.d_model, cfg.d_ff, dt, generator, device)


class SharedBlock(nn.Module):
    """One of zamba2's shared blocks: the norm over [x, e] (2 x d_model), attention from it,
    the norm before the MLP, and the GELU-gated MLP's input (gate and up side by side) and
    output projections."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt, d, ff = _dtype(cfg.param_dtype), cfg.d_model, cfg.d_ff
        self.ln1 = rmsnorm_init(2 * d, dt, device)
        self.attn = Attention(cfg, generator, device, d_in=2 * d)
        self.ln2 = rmsnorm_init(d, dt, device)
        self.gate_up = _normal((d, 2 * ff), d**-0.5, dt, generator, device)
        self.down = _normal((ff, d), ff**-0.5, dt, generator, device)


class Site(nn.Module):
    """A zamba2 site's own weights: the LoRA on its block's MLP input projection, and the linear
    that maps the block's output into the stream."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt, d, r = _dtype(cfg.param_dtype), cfg.d_model, cfg.adapter_rank
        self.lora_a = _normal((d, r), d**-0.5, dt, generator, device)
        self.lora_b = _normal((r, 2 * cfg.d_ff), r**-0.5, dt, generator, device)
        self.linear = _normal((d, d), d**-0.5, dt, generator, device)


class GraniteLayer(nn.Module):
    """A granitemoehybrid layer: the norm before its mixer, the mixer (``attn`` at the layers
    ``hybrid_layer_ids`` names, else ``ssm``), the norm before the MoE, and the MoE, which holds
    its share of the experts and the shared expert."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device, *, attention: bool):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.norm = rmsnorm_init(cfg.d_model, dt, device)
        if attention:
            self.attn = attention_init(cfg, generator, device)
        else:
            self.ssm = Mamba2Mixer(cfg, generator, device)
        self.ln2 = rmsnorm_init(cfg.d_model, dt, device)
        self.moe = moe_init(cfg, generator, device)


class FalconH1Layer(nn.Module):
    """A falcon_h1 layer: the norm that both mixers read, attention and the Mamba2 Mixer side by
    side, the norm before the MLP, and the SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.norm = rmsnorm_init(cfg.d_model, dt, device)
        self.attn = attention_init(cfg, generator, device)
        self.ssm = Mamba2Mixer(cfg, generator, device)
        self.ln2 = rmsnorm_init(cfg.d_model, dt, device)
        self.mlp = mlp_init(cfg.d_model, cfg.d_ff, dt, generator, device)


# the families that walk a loop of Mamba2 layers, with state in their cache and `pos` on the device
_MAMBA2_LOOP = ("ssm", "hybrid", "zamba2", "granitemoehybrid", "falcon_h1")

_LAYER = {
    "ssm": Mamba2Layer,
    "hybrid": Mamba2Layer,
    "zamba2": Mamba2Layer,
    "dense": DenseLayer,
    "vlm": DenseLayer,
    "moe": functools.partial(DenseLayer, moe=True),
    "granitemoehybrid": GraniteLayer,
    "falcon_h1": FalconH1Layer,
}


def _make_layer(cfg: ArchConfig, generator: torch.Generator, device, i: int) -> nn.Module:
    if cfg.family == "granitemoehybrid":
        return GraniteLayer(cfg, generator, device, attention=layer_rows(cfg)[i][1] is None)
    return _LAYER[cfg.family](cfg, generator, device)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        if cfg.family not in _LAYER:
            raise ValueError(f"family {cfg.family!r} is not a decoder-only LM (encdec: models/encdec.py)")
        self.cfg = cfg
        self.embedding = embedding_init(cfg, generator, device)
        self.final_norm = rmsnorm_init(cfg.d_model, _dtype(cfg.param_dtype), device)
        self.layers = nn.ModuleList(_make_layer(cfg, generator, device, i) for i in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_block = DenseLayer(cfg, generator, device)
        if cfg.family == "zamba2":
            self.blocks = nn.ModuleList(SharedBlock(cfg, generator, device) for _ in range(cfg.num_mem_blocks))
            self.sites = nn.ModuleList(Site(cfg, generator, device) for _ in cfg.hybrid_layer_ids)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, device=None) -> LM:
    """Random params with the reference's scales (not its random bits).

    ``device`` None means the card.  Without a ``generator`` one on that
    device is seeded with 0.
    """
    dev = _device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LM(cfg, generator, dev)


# ------------------------------------------------------------- the layer walk
def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


@functools.lru_cache(maxsize=None)
def layer_rows(cfg: ArchConfig) -> tuple[tuple[int | None, int | None], ...]:
    """Each layer's (K/V row, SSM row) in the cache, None where it holds no such row: the one
    place that decides which layer keeps which state.  A dense, moe or vlm layer i holds K/V
    row i.  A Mamba2 layer i of the ssm, hybrid and zamba2 families holds SSM row i, and the
    hybrids' shared-block sites number the K/V rows: the hybrid's follow each layer i with
    (i + 1) % attn_every == 0, zamba2's add to the input of each layer in ``hybrid_layer_ids``.
    granitemoehybrid's layers in ``hybrid_layer_ids`` are its attention layers, each with a K/V
    row and no SSM row; its Mamba2 layers number the SSM rows in turn.  falcon_h1's layer i,
    which ``hybrid_layer_ids`` lists with every other, holds K/V row i and SSM row i."""
    n = cfg.num_layers
    if cfg.family not in _MAMBA2_LOOP:
        return tuple((i, None) for i in range(n))
    sites = range(cfg.attn_every - 1, n, cfg.attn_every) if cfg.family == "hybrid" else cfg.hybrid_layer_ids
    kv = {layer: j for j, layer in enumerate(sites)}
    if cfg.family != "granitemoehybrid":
        return tuple((kv.get(i), i) for i in range(n))
    mamba = iter(range(n))
    return tuple((kv[i], None) if i in kv else (None, next(mamba)) for i in range(n))


def kv_rows(cfg: ArchConfig) -> int:
    """Rows of the K/V cache: one per attention layer, per site in the hybrid families, none for ssm."""
    return sum(kv is not None for kv, _ in layer_rows(cfg))


def ssm_rows(cfg: ArchConfig) -> int:
    """Rows of the stacked SSM cache: one per Mamba2 layer."""
    return sum(r is not None for _, r in layer_rows(cfg))


def _block(cfg: ArchConfig, lp: DenseLayer, x: torch.Tensor, row: int, attend) -> tuple[torch.Tensor, torch.Tensor]:
    """An attention block: x + attention(ln1(x)) at K/V row ``row``, then x + ffn(ln2(x));
    returns it and the MoE aux loss (zero without MoE)."""
    with span("model.attention", ("row", row)):
        x = x + attend(lp.attn, rmsnorm(lp.ln1, x, cfg.norm_eps), row, True)
        xn = rmsnorm(lp.ln2, x, cfg.norm_eps)
        if cfg.family == "moe":
            out, aux = moe_apply(cfg, lp.moe, xn)
            return x + out, aux
        return x + mlp(lp.mlp, xn, cfg.compute_dtype), torch.zeros((), dtype=torch.float32, device=x.device)


def _shared_block(cfg: ArchConfig, params: LM, j: int, x: torch.Tensor, e: torch.Tensor, attend) -> torch.Tensor:
    """What zamba2's site ``j`` adds to its layer's input: block j mod ``num_mem_blocks`` on
    [x, e], its MLP's input projection with the site's LoRA, then the site's linear.  The
    block attends at K/V row j, rotated where ``mem_rope``."""
    k = j % cfg.num_mem_blocks
    blk, site = params.blocks[k], params.sites[j]
    cd = _dtype(cfg.compute_dtype)
    with span("model.shared_block", ("site", j, "block", k, "layer", cfg.hybrid_layer_ids[j])):
        u = rmsnorm(blk.ln1, torch.cat([x, e], dim=-1), cfg.norm_eps)
        with span("model.attention", ("row", j)):
            h = attend(blk.attn, u, j, cfg.mem_rope)
        h = rmsnorm(blk.ln2, h, cfg.norm_eps).to(cd)
        gu = h @ blk.gate_up.to(cd) + (h @ site.lora_a.to(cd)) @ site.lora_b.to(cd)
        gate, up = gu.chunk(2, dim=-1)
        return ((F.gelu(gate) * up) @ blk.down.to(cd)) @ site.linear.to(cd)


def remat(cfg: ArchConfig, body, *args):
    """``body(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat`` is set and
    grad is enabled, as the reference wraps its scan body in ``jax.checkpoint``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _granite_layer(cfg: ArchConfig, lp: GraniteLayer, i: int, x: torch.Tensor, attend, mix):
    """granitemoehybrid's layer ``i``: its mixer, attention without RoPE at K/V row j where the layer
    has one, else Mamba2 at its SSM row; then the MoE with the shared expert, each output scaled by
    ``residual_multiplier`` before its residual add.  Returns (x out, the Mamba2 layer's new state,
    or None)."""
    (j, r), m, new = layer_rows(cfg)[i], cfg.residual_multiplier, None
    if r is not None:
        with span("model.mamba2", ("layer", i)):
            h, new = mix(r, lp.ssm, rmsnorm(lp.norm, x, cfg.norm_eps))
            x = x + h * m
    else:
        with span("model.attention", ("row", j)):
            x = x + attend(lp.attn, rmsnorm(lp.norm, x, cfg.norm_eps), j, False) * m
    with span("model.moe", ("layer", i)):
        return x + moe_dropless(cfg, lp.moe, rmsnorm(lp.ln2, x, cfg.norm_eps)) * m, new


def _falcon_layer(cfg: ArchConfig, lp: FalconH1Layer, i: int, x: torch.Tensor, attend, mix):
    """falcon_h1's layer ``i``: the Mamba2 Mixer at SSM row i and RoPE attention at K/V row i, side
    by side on one normed input, each with its multipliers, summed into one residual add; then the
    MLP with its multipliers.  Returns (x out, the Mixer's new state)."""
    j, r = layer_rows(cfg)[i]
    with span("model.parallel_mixer", ("layer", i)):
        u = rmsnorm(lp.norm, x, cfg.norm_eps)
        with span("model.mamba2", ("layer", i)):
            h, new = mix(r, lp.ssm, u)
            h = scaled(h, cfg.ssm_out_multiplier)
        with span("model.attention", ("row", j)):
            a = scaled(attend(lp.attn, u, j, True), cfg.attention_out_multiplier)
        x = x + (h + a)
    return x + mlp(lp.mlp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg.compute_dtype, cfg.mlp_multipliers), new


def _layer(cfg: ArchConfig, params: LM, i: int, x: torch.Tensor, e: torch.Tensor, attend, mix):
    """The reference's scan body: layer ``i`` and what sits at it, in the module docstring's
    order (``e``: the token embeddings, for zamba2's sites).  Returns (x out, what the layer
    leaves: an attention layer's MoE aux loss, a Mamba2 layer's new state as ``mix`` gives it)."""
    lp = params.layers[i]
    if cfg.family == "granitemoehybrid":
        return _granite_layer(cfg, lp, i, x, attend, mix)
    if cfg.family == "falcon_h1":
        return _falcon_layer(cfg, lp, i, x, attend, mix)
    if cfg.family not in _MAMBA2_LOOP:
        return _block(cfg, lp, x, i, attend)
    j, r = layer_rows(cfg)[i]
    xin = x
    if cfg.family == "zamba2" and j is not None:
        xin = x + _shared_block(cfg, params, j, x, e, attend)
    with span("model.mamba2", ("layer", i)):
        h, new = mix(r, lp.ssm, rmsnorm(lp.norm, xin, cfg.norm_eps))
        x = x + h
    if cfg.family == "hybrid" and j is not None:
        x, _ = _block(cfg, params.shared_block, x, j, attend)
    return x, new


def _walk(cfg: ArchConfig, params: LM, x: torch.Tensor, attend, mix) -> tuple[torch.Tensor, list]:
    """The decoder-only layer order, the one walk of ``forward``, ``prefill`` and
    ``decode_step``: ``_layer`` for each layer, one ``remat`` body a layer (inert in the two
    inference steps).  The steps differ only in the two hooks they pass:
    ``attend(attn, u, row, rope)``, attention of ``u`` at K/V row ``row`` (RoPE unless
    ``rope`` is off), and ``mix(r, mixer, u)``, the mixer of the Mamba2 layer at SSM cache row r
    (``layer_rows``): (its output, its new state or None).  Returns
    the stream and what each layer left (``_layer``)."""
    e, left = x, []
    for i in range(len(params.layers)):
        x, out = remat(cfg, _layer, cfg, params, i, x, e, attend, mix)
        left.append(out)
    return x, left


# ------------------------------------------------------------------ forward
def _embed_inputs(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> torch.Tensor:
    """Token embeddings; for the vlm family the patch embeddings come first."""
    x = embed(cfg, params.embedding, batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def forward(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits over token positions, aux_loss).

    The aux loss is the MoE layers' load-balancing loss summed over layers
    (zero for the other families).
    """
    _check(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    x, left = _walk(cfg, params, x, lambda p, u, row, rope: attention(cfg, p, u, positions if rope else None),
                    lambda i, mixer, u: (mixer(u), None))
    if cfg.family in _MAMBA2_LOOP:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        aux = torch.stack(left).sum()
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:]
    return unembed(cfg, params.embedding, x), aux


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            g: tp.Group | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The next-token negative log likelihood summed over labels >= 0, and their count, in float32.
    With a model-axis group ``g`` the logits are this rank's vocabulary columns (``tp.nll_sum``)."""
    if g is not None:
        return tp.nll_sum(logits, labels, g)
    lg = logits.to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, g: tp.Group | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over labels >= 0."""
    total, count = nll_sum(logits, labels, g)
    return total / count.clamp(min=1.0)


def loss_fn(cfg: ArchConfig, params: LM, batch: dict[str, Any]) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux), in float32.  Labels < 0 are ignored."""
    logits, aux = forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"], params.embedding.tp_group) + 0.01 * aux


# -------------------------------------------------------------------- cache
def _kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> dict[str, torch.Tensor]:
    """Zero K/V, ``kv_rows`` rows (one per attention layer, per shared-block site in the hybrids); none for ssm."""
    if cfg.family == "ssm":
        return {}
    shape = (kv_rows(cfg), batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zero cache; ``max_len`` is unused by the ssm family; ``device`` None means the card."""
    dev = _device(device)
    cache: dict[str, Any] = _kv_cache(cfg, batch, max_len, dtype, dev)
    if cfg.family in _MAMBA2_LOOP:
        caches = ssm_init_cache(cfg, batch, dtype, dev)
        cache["ssm"] = {k: v.expand(ssm_rows(cfg), *v.shape).clone() for k, v in caches.items()}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


# ------------------------------------------------------------------- decode
def _pos_on_device(cfg: ArchConfig, params: LM) -> bool:
    """Whether ``decode_step`` hands attention ``pos`` as the cache's device tensor: in the
    hybrid families, unless a sharded decode splits the K/V's sequence (``seq_split``, which
    takes an int); dense, moe and vlm read it on the host."""
    if cfg.family == "hybrid":
        return params.shared_block.attn.seq_split is None
    return cfg.family in _MAMBA2_LOOP


def _stack_states(news: list, into: dict, keys=("state", "conv")) -> dict[str, torch.Tensor]:
    """The Mamba2 layers' new ``keys`` (states, conv tails) as the cache's stacks, into ``into``'s tensors if it
    has them; the layers that leave None (granitemoehybrid's attention) hold no row."""
    with span("model.new_cache"):
        return {k: torch.stack([new[k] for new in news if new is not None], out=into.get(k)) for k in keys}


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: LM, cache, tokens: torch.Tensor, out=None):
    """One-token decode.  tokens: (B, 1) -> (logits (B,1,V), new cache).

    The input cache is left as it was: the new K/V are one copy per step,
    into which each attention block writes its row in place.  ``pos`` is the
    global position; in a sharded decode each K/V leaf (the hybrid: each
    site's) may be the rank's sequence shard, which ``attention_decode`` reads
    through its attention's ``seq_split``.  The hybrid families pass ``pos`` to
    attention as the cache's device tensor (``_pos_on_device``), so that their
    step, as the ssm's, reads nothing back to the host; the other families read
    it as an int.

    Each Mamba2 layer writes its new state into its row of the new cache's
    state (``Mamba2Mixer.decode``'s ``out``), which the call allocates whole
    up front; the conv tails are stacked after the walk.

    ``out`` (the Mamba2-loop families) is a cache of the same structure
    and shapes into whose tensors the new cache is written and returned: the
    same work and the same bits as the call that allocates.  The old K/V are
    copied into ``out``'s first.  ``out`` may be the input cache itself, which is
    then updated in place (each layer reads its row of the old state and writes
    the new one over it, the conv stack writes after every layer has read its
    tail, each site writes its K/V row in place, and ``pos`` moves on last), as
    ``DecodeGraphs`` replays it.
    """
    if out is not None and cfg.family not in _MAMBA2_LOOP:
        raise ValueError(f"decode_step: out= takes an ssm, hybrid or zamba2 cache or a granitemoehybrid or "
                         f"falcon_h1 one, not the {cfg.family} family's")
    out = out or {}
    with span("model.decode_step"):
        _check(cfg, params)
        with span("model.embed"):
            x = embed(cfg, params.embedding, tokens)
        new_cache: dict[str, Any] = {}
        if cfg.family != "ssm":
            pos = cache["pos"] if _pos_on_device(cfg, params) else int(cache["pos"])
            with span("model.new_cache"):
                if "k" not in out:
                    new_k, new_v = cache["k"].clone(), cache["v"].clone()
                else:
                    new_k, new_v = out["k"], out["v"]
                    if new_k is not cache["k"]:
                        new_k.copy_(cache["k"])
                        new_v.copy_(cache["v"])
            new_cache["k"], new_cache["v"] = new_k, new_v
        if cfg.family in _MAMBA2_LOOP:  # each Mamba2 layer writes its row (no device work here)
            states = out["ssm"]["state"] if "ssm" in out else torch.empty_like(cache["ssm"]["state"])

        def attend(p, u, row, rope):
            return attention_decode(cfg, p, u, {"k": new_k[row], "v": new_v[row]}, pos, rope=rope)[0]

        def mix(i, mixer, u):
            return mixer.decode(u, {"state": cache["ssm"]["state"][i], "conv": cache["ssm"]["conv"][i]}, out=states[i])

        x, news = _walk(cfg, params, x, attend, mix)
        if cfg.family in _MAMBA2_LOOP:
            new_cache["ssm"] = {"state": states, **_stack_states(news, out.get("ssm", {}), ("conv",))}
        new_cache["pos"] = torch.add(cache["pos"], 1, out=out.get("pos"))
        with span("model.head"):
            x = rmsnorm(params.final_norm, x, cfg.norm_eps)
            return vocab_logits(cfg, params.embedding, x), new_cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: LM, batch: dict[str, Any], max_len: int):
    """Process a full prompt, returning (last-position logits, primed cache).

    For the ssm and both hybrid families the cache holds each Mamba2 layer's final
    recurrent state and the pre-conv tail that decode's conv continues from;
    for every family with attention it holds each layer's (the hybrids: each
    site's) K/V, zero past the prompt.  Attention here is the plain path
    whatever ``attention_impl`` says, as in the reference.  A vlm patch prefix
    extends the cached sequence, so ``max_len`` grows by its length.
    """
    with span("model.prefill"):
        _check(cfg, params)
        with span("model.embed"):
            x = _embed_inputs(cfg, params, batch)
        b, s = x.shape[:2]
        cd = _dtype(cfg.compute_dtype)
        max_len = max(max_len + (s - batch["tokens"].shape[1]), s)
        positions = _positions(b, s, x.device)
        cache: dict[str, Any] = _kv_cache(cfg, b, max_len, cd, x.device)

        def attend(p, u, row, rope):
            h, k, v = attention_prefill(cfg, p, u, positions if rope else None)
            with span("model.new_cache"):
                cache["k"][row, :, :s] = k.to(cache["k"].dtype)
                cache["v"][row, :, :s] = v.to(cache["v"].dtype)
            return h

        def mix(i, mixer, u):
            h, state, conv_tail = mixer(u, return_state=True)
            return h, {"state": state.to(torch.float32), "conv": conv_tail.to(cd)}

        x, news = _walk(cfg, params, x, attend, mix)
        if cfg.family in _MAMBA2_LOOP:
            cache["ssm"] = _stack_states(news, {})
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
        with span("model.head"):
            x = rmsnorm(params.final_norm, x, cfg.norm_eps)
            logits = vocab_logits(cfg, params.embedding, x[:, -1:])
        return logits, cache


# ------------------------------------------------------------- decode graphs
DECODE_GRAPHS = {"captures": 0, "replays": 0}  # graphs captured and replayed by every ``DecodeGraphs``


def decode_graphable(cfg: ArchConfig, params: nn.Module) -> bool:
    """Whether ``DecodeGraphs`` may replay ``decode_step`` for ``params``: they sit on the card, the
    family's step reads nothing back to the host (the Mamba2-loop families', which keep ``pos`` on
    the device; dense, moe and vlm read ``int(cache["pos"])``, which a captured graph cannot), and no
    module has a ``tp_group`` (a sharded decode's collectives stay eager)."""
    return (cfg.family in _MAMBA2_LOOP and params.embedding.embed.device.type == "cuda"
            and all(getattr(m, "tp_group", None) is None for m in params.modules()))


def _leaves(cache: dict) -> list[torch.Tensor]:
    """A cache's tensors, nested dicts flattened, in the order of their sorted keys."""
    return [t for k in sorted(cache) for t in (_leaves(cache[k]) if isinstance(cache[k], dict) else (cache[k],))]


class DecodeGraphs:
    """``decode_step`` captured as a CUDA graph and replayed, for params that ``decode_graphable``
    accepts: one ``cudaGraphLaunch`` a step in place of some 60 launches a layer from Python.  The
    replay runs the same kernels on the same data in the same order as the eager step, so its
    logits and cache are the eager step's, bit for bit.  In the hybrid families the static cache
    holds the K/V too, into which each replay writes the sites' new rows at the ``pos`` it holds.

    The runner holds one graph, for the shape (of the tokens and of each cache tensor) of its
    latest call: a static tokens buffer and a static cache, which the graph updates in place
    (``decode_step(..., out=cache)``), in a memory pool of the graph's own.  A call whose cache
    is the static one replays the graph; any other cache (a prefill's, on a batch's first step)
    is copied into it first; a call of another shape drops the graph and captures one for its
    shape.  What a call returns is the runner's own: the next call writes over it, so read the
    logits before the next call and pass the cache back only into the next one.  The graph and
    its pool go with the runner.
    """

    def __init__(self, cfg: ArchConfig, params: LM):
        self.cfg, self.params = cfg, params
        self._key = self._graph = self._tokens = self._cache = self._logits = None

    @torch.inference_mode()
    def __call__(self, params: LM, cache, tokens: torch.Tensor):
        if params is not self.params:
            raise ValueError("DecodeGraphs: the graph was captured on other params")
        if cache is not self._cache:
            key = tuple((t.shape, t.dtype) for t in (tokens, *_leaves(cache)))
            if key != self._key:
                self._capture(cache, tokens, key)
            for dst, src in zip(_leaves(self._cache), _leaves(cache)):
                dst.copy_(src)
        self._tokens.copy_(tokens)
        with span("model.decode_graph"):
            self._graph.replay()
        DECODE_GRAPHS["replays"] += 1
        return self._logits, self._cache

    def _capture(self, cache, tokens: torch.Tensor, key: tuple) -> None:
        self._key = self._graph = self._tokens = self._cache = self._logits = None  # the old shape's, freed first
        cfg, params = self.cfg, self.params
        toks, static = tokens.clone(), tree_map(torch.zeros_like, cache)
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph)
        # warm up off the default stream, as torch.cuda.graphs asks, on the one the capture uses
        # (torch's shared capture stream), so no engine leaves a cuBLAS workspace of its own behind
        side = capture.capture_stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            decode_step(cfg, params, static, toks, out=static)
        torch.cuda.current_stream().wait_stream(side)
        with capture:
            logits = decode_step(cfg, params, static, toks, out=static)[0]
        DECODE_GRAPHS["captures"] += 1
        self._key, self._graph, self._tokens, self._cache, self._logits = key, graph, toks, static, logits
