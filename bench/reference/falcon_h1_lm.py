"""Plain PyTorch reference of Falcon-H1 (family ``falcon_h1``).

The benchmark's yardstick for ``falcon-h1-34b-instruct``.  It imports nothing of
the program, of JAX or of transformers: it takes a configuration as a plain
dict (the ``arch`` group of ``bench/configs/<name>.json``), weights as a dict
of tensors that the benchmark made from the seed, and token ids, and computes
in float32 with TF32 off.  The causal conv, the chunked SSD recurrence, the
RMSNorm and the control's rounding are ``mamba2_lm``'s; RoPE is ``zamba2_lm``'s.

The model, as transformers' ``models/falcon_h1/modeling_falcon_h1.py`` computes it
(``FalconH1ForCausalLM`` with eager attention and the Mixer's plain path,
``torch_forward``):

- x = the token embedding (V, D) times ``embedding_multiplier``;
- layer i: ``u = rmsnorm(x)``, then ``x + ssm_out_multiplier * mamba(u) +
  attention_out_multiplier * attention(u)``: both mixers read the same normed
  input and their sum takes one residual add; then ``x + mlp(rmsnorm(x))``;
- the Mixer: its input times ``ssm_in_multiplier``, the projections to z, x, B,
  C and dt each times its entry of ``ssm_multipliers``; a causal depthwise conv
  of width W with bias on x, B and C, then SiLU; dt = softplus(dt + dt_bias)
  with no floor (``time_step_limit`` (0, inf)); the SSD recurrence with B and C
  in ``ssm_ngroups`` groups (head h reads group h // (H / G)); ``y + D x``; the
  gated RMSNorm ``rmsnorm(y * silu(z))`` over each group's D_inner / G channels
  (``mamba_norm_before_gate`` false); the output projection.  D_inner is
  ``ssm_inner`` (the published ``mamba_d_ssm``), not ``ssm_expand x d_model``;
- attention: q (H heads), k and v (K heads) of hd, no bias; k times the
  published ``key_multiplier``; RoPE over all hd dims at ``rope_theta``; q head h
  reading kv head h // (H / K); scores scaled by hd^-0.5; causal softmax; o;
- the MLP: ``down(up(u) * silu(gate(u) * g)) * o``, (g, o) the
  ``mlp_multipliers``;
- the final RMSNorm and the untied head, its logits times ``lm_head_multiplier``.

Departures from ``modeling_falcon_h1.py`` (transformers 4.57.6):

- the configuration holds ``key_multiplier x hd^-0.5`` as one scale,
  ``attention_multiplier`` (1/1024 at hd 128), as the program applies it to the
  scores with K cached unscaled; this reference recovers ``key_multiplier =
  attention_multiplier x hd^0.5`` and scales K by it and the scores by hd^-0.5, as
  transformers does.  The product is the same number: reassociation;
- ``attention_in_multiplier`` is left out: it is 1 in the published configuration,
  so attention reads ``u`` itself;
- ``lm_head_multiplier`` is read as ``1 / logits_scaling`` (1/128, a power of two:
  the same bits);
- layouts, as the served model's: ``in_proj`` is the columns of wz | wx | wb |
  wc | wdt, ``conv1d`` (C, 1, W) is conv_x | conv_b | conv_c as (W, C), each
  ``nn.Linear`` weight (out, in) is stored (in, out), q/k/v as (D, heads, hd), o
  as (H, hd, D), the head ``lm_head`` (V, D) as ``unembed`` (D, V).

``precision="fp8"`` is the control, as in ``mamba2_lm``: every matrix
product's operands (the attention's scores and mixing too, and the scan's x,
B and C) rounded to float8 e4m3 with one scale a tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .mamba2_lm import Numerics, causal_conv, const_value, rmsnorm, set_f32_matmul, ssd_chunked  # noqa: F401
from .zamba2_lm import rope


# ----------------------------------------------------------------- layout
QK_WIDEN = 8.0  # q and k each 8x fan-in scale: the scores (q.k / 1024 at hd 128) spread over ~0.7


def dims(arch: dict) -> dict:
    d = arch["d_model"]
    di = arch["ssm_inner"] or d * arch["ssm_expand"]
    return {"d": d, "di": di, "h": di // arch["ssm_head_dim"], "p": arch["ssm_head_dim"], "n": arch["ssm_state"],
            "g": arch["ssm_ngroups"], "w": arch["ssm_conv_width"], "v": arch["vocab_size"],
            "heads": arch["num_heads"], "kv": arch["num_kv_heads"], "hd": arch["head_dim"], "ff": arch["d_ff"]}


def param_specs(arch: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """(name, shape, init) of every weight, named as the served model names its
    parameters.  ``init`` is ("normal", fan-in^-0.5), ("normal", 0.2) for the convs,
    ("const", "zeros" | "ones" | "a_log"), or for the embedding ("normal", 0.02 /
    ``embedding_multiplier``): the stream starts at the 0.02 scale of the other
    configurations' embeddings.  ``wq`` and ``wk`` are drawn ``QK_WIDEN`` times wider:
    at fan-in scales the scores (q.k over 1024) would spread over ~0.01 and every
    softmax would be flat, so that the comparison could not tell which rows were read."""
    if arch["family"] != "falcon_h1":
        raise ValueError(f"this reference holds the falcon_h1 family alone, not {arch['family']!r}")
    if arch["tie_embeddings"]:
        raise ValueError("Falcon-H1 unties its head from the embedding")
    k = dims(arch)
    d, di, h, gn, w, v = k["d"], k["di"], k["h"], k["g"] * k["n"], k["w"], k["v"]
    nh, kv, hd, ff = k["heads"], k["kv"], k["hd"], k["ff"]
    specs = [("embedding.embed", (v, d), ("normal", 0.02 / arch["embedding_multiplier"])),
             ("embedding.unembed", (d, v), ("normal", d ** -0.5)),
             ("final_norm.scale", (d,), ("const", "ones"))]
    for i in range(arch["num_layers"]):
        pre = f"layers.{i}."
        specs += [
            (pre + "norm.scale", (d,), ("const", "ones")),
            (pre + "attn.wq", (d, nh, hd), ("normal", QK_WIDEN * d ** -0.5)),
            (pre + "attn.wk", (d, kv, hd), ("normal", QK_WIDEN * d ** -0.5)),
            (pre + "attn.wv", (d, kv, hd), ("normal", d ** -0.5)),
            (pre + "attn.wo", (nh, hd, d), ("normal", (nh * hd) ** -0.5)),
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
            (pre + "ln2.scale", (d,), ("const", "ones")),
            (pre + "mlp.gate", (d, ff), ("normal", d ** -0.5)),
            (pre + "mlp.up", (d, ff), ("normal", d ** -0.5)),
            (pre + "mlp.down", (ff, d), ("normal", ff ** -0.5)),
        ]
    return specs


def weight_uses(arch: dict, name: str) -> int:
    """How many times a weight multiplies each token in a forward pass: the input
    embedding is a lookup, the untied head is used once, and so is every other weight."""
    return 0 if name == "embedding.embed" else 1


# ----------------------------------------------------------------- layers
def mixer(arch: dict, w: dict, pre: str, u: torch.Tensor, nm: Numerics) -> torch.Tensor:
    k = dims(arch)
    b, s, _ = u.shape
    h, p, n, g = k["h"], k["p"], k["n"], k["g"]
    x = u * arch["ssm_in_multiplier"]
    z, xs, bm, cm, dt = (nm.mm(x, w[pre + name]) * m for name, m in zip(("wz", "wx", "wb", "wc", "wdt"),
                                                                         arch["ssm_multipliers"]))
    xs = F.silu(causal_conv(xs, w[pre + "conv_x"], w[pre + "conv_bx"]))
    bm = F.silu(causal_conv(bm, w[pre + "conv_b"], w[pre + "conv_bb"]))
    cm = F.silu(causal_conv(cm, w[pre + "conv_c"], w[pre + "conv_bc"]))
    dt = F.softplus(dt + w[pre + "dt_bias"])
    a = -torch.exp(w[pre + "a_log"])
    xh = xs.reshape(b, s, h, p)
    per = h // g
    y = torch.cat([
        ssd_chunked(nm.q(xh[:, :, q * per:(q + 1) * per]), dt[..., q * per:(q + 1) * per], a[q * per:(q + 1) * per],
                    nm.q(bm[..., q * n:(q + 1) * n]), nm.q(cm[..., q * n:(q + 1) * n]), arch["ssm_chunk"])
        for q in range(g)], dim=2)
    y = y + xh * w[pre + "d_skip"][:, None]
    gated = (y.reshape(b, s, k["di"]) * F.silu(z)).reshape(b, s, g, -1)
    y = rmsnorm(gated, w[pre + "norm.scale"].reshape(g, -1), arch["norm_eps"]).reshape(b, s, k["di"])
    return nm.mm(y, w[pre + "out_proj"])


def attention(arch: dict, w: dict, pre: str, u: torch.Tensor, nm: Numerics) -> torch.Tensor:
    b, s, d = u.shape
    nh, kv, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    key_multiplier = arch["attention_multiplier"] * hd ** 0.5
    q = nm.mm(u, w[pre + "wq"].reshape(d, nh * hd)).reshape(b, s, nh, hd)
    k, v = (nm.mm(u, w[pre + name].reshape(d, kv * hd)).reshape(b, s, kv, hd) for name in ("wk", "wv"))
    q, k = rope(q, arch["rope_theta"]), rope(k * key_multiplier, arch["rope_theta"])
    k, v = k.repeat_interleave(nh // kv, dim=2), v.repeat_interleave(nh // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", nm.q(q), nm.q(k)) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", nm.q(probs), nm.q(v)).reshape(b, s, nh * hd)
    return nm.mm(out, w[pre + "wo"].reshape(nh * hd, d))


def mlp(arch: dict, w: dict, pre: str, u: torch.Tensor, nm: Numerics) -> torch.Tensor:
    gm, dm = arch["mlp_multipliers"]
    return nm.mm(nm.mm(u, w[pre + "up"]) * F.silu(nm.mm(u, w[pre + "gate"]) * gm), w[pre + "down"]) * dm


def hidden(arch: dict, w: dict, tokens: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S)."""
    eps = arch["norm_eps"]
    x = w["embedding.embed"][tokens.long()] * arch["embedding_multiplier"]
    for i in range(arch["num_layers"]):
        pre = f"layers.{i}."
        u = rmsnorm(x, w[pre + "norm.scale"], eps)
        h = mixer(arch, w, pre + "ssm.", u, nm) * arch["ssm_out_multiplier"]
        a = attention(arch, w, pre + "attn.", u, nm) * arch["attention_out_multiplier"]
        x = x + (h + a)
        x = x + mlp(arch, w, pre + "mlp.", rmsnorm(x, w[pre + "ln2.scale"], eps), nm)
    return rmsnorm(x, w["final_norm.scale"], eps)


# ------------------------------------------------------------------ uses
@torch.no_grad()
def next_token_logits(arch: dict, w: dict, tokens: torch.Tensor, start: int, precision: str = "f32") -> torch.Tensor:
    """float32 logits (B, S - start, V) at positions start..S-1 of ``tokens`` (B, S):
    position t scores the token that follows it."""
    set_f32_matmul()
    nm = Numerics(precision)
    x = hidden(arch, w, tokens, nm)
    return nm.mm(x[:, start:], w["embedding.unembed"]) * (1 / arch["logits_scaling"])
