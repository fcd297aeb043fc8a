"""Plain PyTorch reference of IBM Granite 4.0-H (family ``granitemoehybrid``).

The benchmark's yardstick for ``granite-4.0-h-small``.  It imports nothing of
the program, of JAX or of transformers: it takes a configuration as a plain
dict (the ``arch`` group of ``bench/configs/<name>.json``), weights as a dict
of tensors that the benchmark made from the seed, and token ids, and computes
in float32 with TF32 off.  The Mamba2 Mixer, the causal conv, the chunked SSD
recurrence, the RMSNorm and the control's rounding are ``mamba2_lm``'s.

The model, as transformers' ``models/granitemoehybrid/modeling_granitemoehybrid.py``
computes it (``GraniteMoeHybridForCausalLM`` with eager attention and the Mixer's
plain path, ``torch_forward``):

- x = the token embedding (V, D) times ``embedding_multiplier``;
- layer i: ``x + m * mixer(rmsnorm(x))``, m the ``residual_multiplier``; the
  mixer is attention at the layers ``hybrid_layer_ids`` names (the published
  ``layer_types``' "attention") and Mamba2 elsewhere;
- attention: q (H heads), k and v (K heads) of hd, no bias, no position
  embedding (``position_embedding_type`` "nope"), q head h reading kv head
  h // (H / K), scores scaled by ``attention_multiplier``, causal softmax, o;
- the Mamba2 Mixer: ``mamba2_lm``'s, one B/C group, dt = softplus(dt + dt_bias)
  with no floor (``time_step_limit`` (0, inf)), the gated RMSNorm
  ``rmsnorm(y * silu(z))`` over all D_inner channels;
- then ``x + m * (moe(u) + shared(u))``, u = rmsnorm(x): the router (D -> E, in
  float32) takes each token's ``top_k`` logits and a softmax over them; an
  expert is ``down(silu(u @ gate) * (u @ up))`` of width ``expert_d_ff``; the
  shared expert the same at ``expert_d_ff x num_shared_experts`` (published
  ``shared_intermediate_size`` 1536 = 2 x 768);
- the final RMSNorm and the head tied to the embedding, its logits divided by
  ``logits_scaling``.

One chip's share of an expert-parallel layer, as the configuration holds it:
the weights of experts ``expert_first`` .. ``expert_first + experts_held - 1``
of the router's ``num_experts``; each (token, k) pair routed to one of them adds
gate x expert(u), each pair routed elsewhere adds nothing, and the gates are the
softmax over all k chosen logits.  With every expert held it is the whole layer.

Departures from ``modeling_granitemoehybrid.py`` (transformers 4.57.6):

- the share above: its ``GraniteMoeHybridMoE`` holds every expert;
- its router's linear runs in the model's dtype before ``.float()``; here every
  product is float32 anyway;
- layouts, as the served model's: ``in_proj`` is the columns of wz | wx | wb |
  wc | wdt, ``conv1d`` (C, 1, W) is conv_x | conv_b | conv_c as (W, C), each
  ``nn.Linear`` weight (out, in) is stored (in, out), q/k/v as (D, heads, hd), o
  as (H, hd, D), an expert's ``input_linear`` (2F, D) as ``gate`` and ``up``
  (D, F) and its ``output_linear`` (D, F) as ``down`` (F, D), held experts
  stacked on a leading axis.

``precision="fp8"`` is the control, as in ``mamba2_lm``: every matrix
product's operands (the attention's scores and mixing too, and the scan's x,
B and C) rounded to float8 e4m3 with one scale a tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import mamba2_lm
from .mamba2_lm import Numerics, const_value, rmsnorm, set_f32_matmul  # noqa: F401  (const_value: the harness's)


# ----------------------------------------------------------------- layout
def dims(arch: dict) -> dict:
    d = arch["d_model"]
    di = d * arch["ssm_expand"]
    return {"d": d, "di": di, "h": di // arch["ssm_head_dim"], "p": arch["ssm_head_dim"], "n": arch["ssm_state"],
            "g": arch["ssm_ngroups"], "w": arch["ssm_conv_width"], "v": arch["vocab_size"],
            "heads": arch["num_heads"], "kv": arch["num_kv_heads"], "hd": arch["head_dim"],
            "e": arch["num_experts"], "held": arch["experts_held"] or arch["num_experts"], "f": arch["expert_d_ff"],
            "fs": arch["expert_d_ff"] * arch["num_shared_experts"]}


def param_specs(arch: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """(name, shape, init) of every weight, named as the served model names its
    parameters.  ``init`` is ("normal", fan-in^-0.5), ("normal", 0.2) for the convs,
    ("const", "zeros" | "ones" | "a_log"), or for the embedding ("normal", 0.02 /
    ``embedding_multiplier``): the stream then starts at the 0.02 scale of the other
    configurations' embeddings.  At 0.02 itself the scaled embedding would outweigh what
    the 40 layers add, and the tied head would score the input token first at every
    position, in any precision."""
    if arch["family"] != "granitemoehybrid":
        raise ValueError(f"this reference holds the granitemoehybrid family alone, not {arch['family']!r}")
    if not arch["tie_embeddings"] or arch["ssm_ngroups"] != 1:
        raise ValueError("Granite 4.0-H ties its head to the embedding and has one B/C group")
    k = dims(arch)
    d, di, h, gn, w, v = k["d"], k["di"], k["h"], k["g"] * k["n"], k["w"], k["v"]
    nh, kv, hd, e, held, f, fs = k["heads"], k["kv"], k["hd"], k["e"], k["held"], k["f"], k["fs"]
    specs = [("embedding.embed", (v, d), ("normal", 0.02 / arch["embedding_multiplier"])),
             ("final_norm.scale", (d,), ("const", "ones"))]
    for i in range(arch["num_layers"]):
        pre = f"layers.{i}."
        specs.append((pre + "norm.scale", (d,), ("const", "ones")))
        if i in arch["hybrid_layer_ids"]:
            specs += [
                (pre + "attn.wq", (d, nh, hd), ("normal", d ** -0.5)),
                (pre + "attn.wk", (d, kv, hd), ("normal", d ** -0.5)),
                (pre + "attn.wv", (d, kv, hd), ("normal", d ** -0.5)),
                (pre + "attn.wo", (nh, hd, d), ("normal", d ** -0.5)),
            ]
        else:
            specs += [
                (pre + "ssm.wz", (d, di), ("normal", d ** -0.5)),
                (pre + "ssm.wx", (d, di), ("normal", d ** -0.5)),
                (pre + "ssm.wb", (d, gn), ("normal", d ** -0.5)),
                (pre + "ssm.wc", (d, gn), ("normal", d ** -0.5)),
                (pre + "ssm.wdt", (d, h), ("normal", d ** -0.5)),
                (pre + "ssm.conv_x", (w, di), ("normal", 0.2)),
                (pre + "ssm.conv_bx", (di,), ("const", "zeros")),
                (pre + "ssm.conv_b", (w, gn), ("normal", 0.2)),
                (pre + "ssm.conv_bb", (gn,), ("const", "zeros")),
                (pre + "ssm.conv_c", (w, gn), ("normal", 0.2)),
                (pre + "ssm.conv_bc", (gn,), ("const", "zeros")),
                (pre + "ssm.a_log", (h,), ("const", "a_log")),
                (pre + "ssm.dt_bias", (h,), ("const", "zeros")),
                (pre + "ssm.d_skip", (h,), ("const", "ones")),
                (pre + "ssm.norm.scale", (di,), ("const", "ones")),
                (pre + "ssm.out_proj", (di, d), ("normal", di ** -0.5)),
            ]
        specs += [
            (pre + "ln2.scale", (d,), ("const", "ones")),
            (pre + "moe.router", (d, e), ("normal", d ** -0.5)),
            (pre + "moe.gate", (held, d, f), ("normal", d ** -0.5)),
            (pre + "moe.up", (held, d, f), ("normal", d ** -0.5)),
            (pre + "moe.down", (held, f, d), ("normal", f ** -0.5)),
            (pre + "moe.shared.gate", (d, fs), ("normal", d ** -0.5)),
            (pre + "moe.shared.up", (d, fs), ("normal", d ** -0.5)),
            (pre + "moe.shared.down", (fs, d), ("normal", fs ** -0.5)),
        ]
    return specs


def weight_uses(arch: dict, name: str) -> float:
    """How many times a weight multiplies each token in a forward pass, on average: a held
    expert's weights ``top_k / num_experts`` (the share of tokens routed to any one expert);
    the input embedding is a lookup and the tied head uses it once; every other weight once."""
    if name.split(".")[-1] in ("gate", "up", "down") and ".moe.shared." not in name:
        return arch["top_k"] / arch["num_experts"]
    return 1


# ----------------------------------------------------------------- layers
def attention(arch: dict, w: dict, pre: str, u: torch.Tensor, nm: Numerics) -> torch.Tensor:
    b, s, d = u.shape
    nh, kv, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    q = nm.mm(u, w[pre + "wq"].reshape(d, nh * hd)).reshape(b, s, nh, hd)
    k, v = (nm.mm(u, w[pre + name].reshape(d, kv * hd)).reshape(b, s, kv, hd) for name in ("wk", "wv"))
    k, v = k.repeat_interleave(nh // kv, dim=2), v.repeat_interleave(nh // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", nm.q(q), nm.q(k)) * arch["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", nm.q(probs), nm.q(v)).reshape(b, s, nh * hd)
    return nm.mm(out, w[pre + "wo"].reshape(nh * hd, d))


def swiglu(u: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, nm: Numerics) -> torch.Tensor:
    return nm.mm(F.silu(nm.mm(u, gate)) * nm.mm(u, up), down)


def moe(arch: dict, w: dict, pre: str, u: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """The held experts' part of the MoE layer and the shared expert, on u (B, S, D)."""
    first = arch["expert_first"]
    top, expert = torch.topk(nm.mm(u, w[pre + "router"]), arch["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = swiglu(u, w[pre + "shared.gate"], w[pre + "shared.up"], w[pre + "shared.down"], nm)
    for e in range(w[pre + "gate"].shape[0]):
        weight = (gates * (expert == first + e)).sum(-1)                     # (B, S): zero where not routed
        routed = weight.nonzero(as_tuple=True)
        if routed[0].numel():
            y = swiglu(u[routed], w[pre + "gate"][e], w[pre + "up"][e], w[pre + "down"][e], nm)
            out = out.index_put(routed, y * weight[routed][:, None], accumulate=True)
    return out


def hidden(arch: dict, w: dict, tokens: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S)."""
    eps, m = arch["norm_eps"], arch["residual_multiplier"]
    x = w["embedding.embed"][tokens.long()] * arch["embedding_multiplier"]
    for i in range(arch["num_layers"]):
        pre = f"layers.{i}."
        u = rmsnorm(x, w[pre + "norm.scale"], eps)
        if i in arch["hybrid_layer_ids"]:
            h = attention(arch, w, pre + "attn.", u, nm)
        else:
            h = mamba2_lm.mixer(arch, w, pre + "ssm.", u, nm)
        x = x + h * m
        x = x + moe(arch, w, pre + "moe.", rmsnorm(x, w[pre + "ln2.scale"], eps), nm) * m
    return rmsnorm(x, w["final_norm.scale"], eps)


# ------------------------------------------------------------------ uses
@torch.no_grad()
def next_token_logits(arch: dict, w: dict, tokens: torch.Tensor, start: int, precision: str = "f32") -> torch.Tensor:
    """float32 logits (B, S - start, V) at positions start..S-1 of ``tokens`` (B, S):
    position t scores the token that follows it."""
    set_f32_matmul()
    nm = Numerics(precision)
    x = hidden(arch, w, tokens, nm)
    return nm.mm(x[:, start:], w["embedding.embed"].T) / arch["logits_scaling"]
