"""Plain PyTorch reference of the published Zamba2 language model (family ``zamba2``).

The benchmark's yardstick for ``zamba2-7b-instruct``.  It imports nothing of
the program, of JAX or of transformers: it takes a configuration as a plain
dict (the ``arch`` group of ``bench/configs/<name>.json``), weights as a dict
of tensors that the benchmark made from the seed, and token ids, and computes
in float32 with TF32 off.  The Mamba2 pieces (the causal conv, the chunked SSD
recurrence, the control's rounding) are ``mamba2_lm``'s.

The model, as transformers' ``models/zamba2/modeling_zamba2.py`` computes it
(``Zamba2ForCausalLM`` with eager attention and the Mixer's plain path,
``torch_forward``):

- e = the token embedding (V, D); the stream x starts as e;
- Mamba2 layer i: ``x + mixer(rmsnorm(x + t_i))``, t_i zero except at the
  sites ``hybrid_layer_ids``: site j (layer ``hybrid_layer_ids[j]``) adds
  ``linear_j(block_{j mod num_mem_blocks}(x, e))``;
- a shared block: ``u = rmsnorm(concat(x, e))`` (2D wide); attention from u:
  q, k and v (2D -> H x hd), RoPE over all hd dims (``mem_rope``), scores
  scaled by (hd / 2)^-0.5, causal softmax, o (H x hd -> D); ``rmsnorm``; the
  MLP ``down(gelu(g) * up)`` with ``[g | up] = h @ gate_up + (h @ lora_a_j) @
  lora_b_j`` (GELU exact, the site's LoRA); no residual of its own;
- the Mixer: ``mamba2_lm``'s, with B and C in ``ssm_ngroups`` groups (head h
  reads group h // (H / G)), the gated RMSNorm over each group's D_inner / G
  channels, and dt = max(softplus(dt + dt_bias), ``ssm_dt_min``);
- the final RMSNorm and the head tied to the embedding.

Departures from ``modeling_zamba2.py`` (transformers 4.57.6):

- one, in its plain full-sequence scan: ``Zamba2MambaMixer.torch_forward``
  sums the chunk states' decays over the target chunk (``.sum(dim=2)`` after
  ``segment_sum``) where the recurrence sums over the source chunk (its Mamba2
  and Bamba models transpose first), so past one chunk its output is not the
  recurrence.  This reference computes the recurrence, as the published CUDA
  path (``mamba_chunk_scan_combined``) and transformers' own step-by-step
  decode do; ``tests/test_torch_zamba2.py`` holds it to transformers' full
  forward within a chunk and to its decode past one;
- the dt floor is the plain path's (``time_step_min``); the CUDA path, with
  ``time_step_limit`` null, has none (softplus falls under 0.001 only where
  its input is under -6.9);
- layouts, as the served model's: ``in_proj`` is the columns of wz | wx | wb |
  wc | wdt, ``conv1d`` (C, 1, W) is conv_x | conv_b | conv_c as (W, C), each
  ``nn.Linear`` weight (out, in) is stored (in, out), q/k/v as (2D, H, hd) and
  o as (H, hd, D).

``precision="fp8"`` is the control, as in ``mamba2_lm``: every matrix
product's operands (the attention's scores and mixing too, and the scan's x,
B and C) rounded to float8 e4m3 with one scale a tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .mamba2_lm import F32, Numerics, causal_conv, const_value, rmsnorm, set_f32_matmul, ssd_chunked


# ----------------------------------------------------------------- layout
def dims(arch: dict) -> dict:
    d = arch["d_model"]
    di = d * arch["ssm_expand"]
    return {"d": d, "di": di, "h": di // arch["ssm_head_dim"], "p": arch["ssm_head_dim"], "n": arch["ssm_state"],
            "g": arch["ssm_ngroups"], "w": arch["ssm_conv_width"], "v": arch["vocab_size"],
            "heads": arch["num_heads"], "hd": arch["head_dim"], "ff": arch["d_ff"], "r": arch["adapter_rank"],
            "sites": len(arch["hybrid_layer_ids"]), "blocks": arch["num_mem_blocks"]}


def param_specs(arch: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """(name, shape, init) of every weight, named as the served model names its
    parameters.  ``init`` is ("normal", fan-in^-0.5), ("normal", 0.02) for the
    embedding, ("normal", 0.2) for the convs, or ("const", "zeros" | "ones" | "a_log")."""
    if arch["family"] != "zamba2":
        raise ValueError(f"this reference holds the zamba2 family alone, not {arch['family']!r}")
    if not arch["tie_embeddings"]:
        raise ValueError("the published Zamba2 ties its head to the embedding")
    k = dims(arch)
    d, di, h, gn, w, v = k["d"], k["di"], k["h"], k["g"] * k["n"], k["w"], k["v"]
    nh, hd, ff, r = k["heads"], k["hd"], k["ff"], k["r"]
    specs = [("embedding.embed", (v, d), ("normal", 0.02)), ("final_norm.scale", (d,), ("const", "ones"))]
    for i in range(arch["num_layers"]):
        pre = f"layers.{i}."
        specs += [
            (pre + "norm.scale", (d,), ("const", "ones")),
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
    for b in range(k["blocks"]):
        pre = f"blocks.{b}."
        specs += [
            (pre + "ln1.scale", (2 * d,), ("const", "ones")),
            (pre + "attn.wq", (2 * d, nh, hd), ("normal", (2 * d) ** -0.5)),
            (pre + "attn.wk", (2 * d, nh, hd), ("normal", (2 * d) ** -0.5)),
            (pre + "attn.wv", (2 * d, nh, hd), ("normal", (2 * d) ** -0.5)),
            (pre + "attn.wo", (nh, hd, d), ("normal", (nh * hd) ** -0.5)),
            (pre + "ln2.scale", (d,), ("const", "ones")),
            (pre + "gate_up", (d, 2 * ff), ("normal", d ** -0.5)),
            (pre + "down", (ff, d), ("normal", ff ** -0.5)),
        ]
    for j in range(k["sites"]):
        pre = f"sites.{j}."
        specs += [
            (pre + "lora_a", (d, r), ("normal", d ** -0.5)),
            (pre + "lora_b", (r, 2 * ff), ("normal", r ** -0.5)),
            (pre + "linear", (d, d), ("normal", d ** -0.5)),
        ]
    return specs


def weight_uses(arch: dict, name: str) -> int:
    """How many times a weight multiplies each token in a forward pass: the input
    embedding is a lookup and the tied head uses it once; a shared block's weights
    once at each of its sites."""
    if name.startswith("blocks."):
        b, blocks = int(name.split(".")[1]), arch["num_mem_blocks"]
        return sum(1 for j in range(len(arch["hybrid_layer_ids"])) if j % blocks == b)
    return 1


# ----------------------------------------------------------------- layers
def mixer(arch: dict, w: dict, pre: str, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    k = dims(arch)
    b, s, _ = x.shape
    h, p, n, g = k["h"], k["p"], k["n"], k["g"]
    z = nm.mm(x, w[pre + "wz"])
    xs = F.silu(causal_conv(nm.mm(x, w[pre + "wx"]), w[pre + "conv_x"], w[pre + "conv_bx"]))
    bm = F.silu(causal_conv(nm.mm(x, w[pre + "wb"]), w[pre + "conv_b"], w[pre + "conv_bb"]))
    cm = F.silu(causal_conv(nm.mm(x, w[pre + "wc"]), w[pre + "conv_c"], w[pre + "conv_bc"]))
    dt = F.softplus(nm.mm(x, w[pre + "wdt"]) + w[pre + "dt_bias"]).clamp(min=arch["ssm_dt_min"])
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


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated at positions 0..S-1 over all hd dims, frequencies theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd)
    freqs = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)[None, :, None, :]
    return x * emb.cos() + rotate_half(x) * emb.sin()


def attention(arch: dict, w: dict, pre: str, u: torch.Tensor, nm: Numerics) -> torch.Tensor:
    b, s, _ = u.shape
    nh, hd = arch["num_heads"], arch["head_dim"]
    q, k, v = (nm.mm(u, w[pre + name].reshape(u.shape[-1], nh * hd)).reshape(b, s, nh, hd) for name in ("wq", "wk", "wv"))
    if arch["mem_rope"]:
        q, k = rope(q, arch["rope_theta"]), rope(k, arch["rope_theta"])
    scores = torch.einsum("bqhd,bkhd->bhqk", nm.q(q), nm.q(k)) * (hd / 2) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", nm.q(probs), nm.q(v)).reshape(b, s, nh * hd)
    return nm.mm(out, w[pre + "wo"].reshape(nh * hd, -1))


def block(arch: dict, w: dict, j: int, x: torch.Tensor, e: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """What site j adds to its layer's input: block j mod num_mem_blocks, the site's LoRA and linear."""
    pre, site, eps = f"blocks.{j % arch['num_mem_blocks']}.", f"sites.{j}.", arch["norm_eps"]
    u = rmsnorm(torch.cat([x, e], dim=-1), w[pre + "ln1.scale"], eps)
    h = rmsnorm(attention(arch, w, pre + "attn.", u, nm), w[pre + "ln2.scale"], eps)
    gate, up = (nm.mm(h, w[pre + "gate_up"]) + nm.mm(nm.mm(h, w[site + "lora_a"]), w[site + "lora_b"])).chunk(2, dim=-1)
    return nm.mm(nm.mm(F.gelu(gate) * up, w[pre + "down"]), w[site + "linear"])


def hidden(arch: dict, w: dict, tokens: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S)."""
    e = w["embedding.embed"][tokens.long()]
    x = e
    sites = {layer: j for j, layer in enumerate(arch["hybrid_layer_ids"])}
    for i in range(arch["num_layers"]):
        t = block(arch, w, sites[i], x, e, nm) if i in sites else 0.0
        pre = f"layers.{i}."
        x = x + mixer(arch, w, pre + "ssm.", rmsnorm(x + t, w[pre + "norm.scale"], arch["norm_eps"]), nm)
    return rmsnorm(x, w["final_norm.scale"], arch["norm_eps"])


# ------------------------------------------------------------------ uses
@torch.no_grad()
def next_token_logits(arch: dict, w: dict, tokens: torch.Tensor, start: int, precision: str = "f32") -> torch.Tensor:
    """float32 logits (B, S - start, V) at positions start..S-1 of ``tokens`` (B, S):
    position t scores the token that follows it."""
    set_f32_matmul()
    nm = Numerics(precision)
    x = hidden(arch, w, tokens, nm)
    return nm.mm(x[:, start:], w["embedding.embed"].T)

