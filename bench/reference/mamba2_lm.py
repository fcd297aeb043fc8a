"""Plain PyTorch reference of the Mamba2 language model (family ``ssm``).

The benchmark's yardstick for ``mamba2-780m``.  It imports
nothing of the program: it takes a configuration as a plain dict (the
``arch`` group of ``bench/configs/<name>.json``), weights as a dict of tensors
that the benchmark made from the seed, and token ids, and computes in float32
with TF32 off.

The model, as the configuration states it:

- token embedding (V, D); tied output head (``x @ embed.T``) or an untied
  ``unembed`` (D, V);
- each layer ``x + mixer(rmsnorm(x))``, the Mamba2 mixer (arXiv:2405.21060):
  projections to z, x, B, C, dt; a causal depthwise conv of width W with bias
  on x, B and C, then SiLU; dt = softplus(dt + dt_bias); A = -exp(a_log); the
  SSD recurrence ``h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T``,
  ``y_t = C_t h_t + D x_t``; gated RMSNorm ``rmsnorm(y * silu(z))``; output
  projection;
- final RMSNorm and the head.

``precision="fp8"`` is the control: every matrix product's operands (and the
scan's x, B and C) are rounded to float8 e4m3 with one scale a tensor, then
multiplied in float32.  Its gradient passes the rounding straight through.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0  # the largest float8 e4m3fn


# ----------------------------------------------------------------- layout
def dims(arch: dict) -> dict:
    d = arch["d_model"]
    di = d * arch["ssm_expand"]
    h = di // arch["ssm_head_dim"]
    return {"d": d, "di": di, "h": h, "p": arch["ssm_head_dim"], "n": arch["ssm_state"], "g": 1,
            "w": arch["ssm_conv_width"], "v": arch["vocab_size"]}


def param_specs(arch: dict) -> list[tuple[str, tuple[int, ...], tuple]]:
    """(name, shape, init) of every weight, named as the served model names its
    parameters.  ``init`` is ("normal", std) or ("const", "zeros" | "ones" |
    "a_log").  ``uses`` of a weight per token is in ``weight_uses``."""
    if arch["family"] != "ssm":
        raise ValueError(f"this reference holds the ssm family alone, not {arch['family']!r}")
    k = dims(arch)
    d, di, h, gn, w, v = k["d"], k["di"], k["h"], k["g"] * k["n"], k["w"], k["v"]
    specs = [("embedding.embed", (v, d), ("normal", 0.02))]
    if not arch["tie_embeddings"]:
        specs.append(("embedding.unembed", (d, v), ("normal", d ** -0.5)))
    specs.append(("final_norm.scale", (d,), ("const", "ones")))
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
    return specs


def weight_uses(arch: dict, name: str) -> int:
    """How many times a weight multiplies each token in a forward pass: the input
    embedding is a lookup (0), and a tied embedding is used once, as the head."""
    if name == "embedding.embed":
        return 1 if arch["tie_embeddings"] else 0
    return 1


def const_value(kind: str, shape: tuple[int, ...], device) -> torch.Tensor:
    if kind == "zeros":
        return torch.zeros(shape, dtype=F32, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=F32, device=device)
    if kind == "a_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=F32, device=device))
    raise ValueError(kind)


# -------------------------------------------------------------- precision
class _RoundFP8(torch.autograd.Function):
    """float8 e4m3 rounding with one scale a tensor; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Numerics:
    """Where the control rounds: ``q`` is the identity in float32."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(x) if self.precision == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)


# ----------------------------------------------------------------- layers
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: out[t] = sum_i w[i] x[t - (W-1) + i] + b; x (B, S, C), w (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = b.expand_as(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int = 256):
    """The SSD recurrence, chunk-parallel, in float32.

    x (B, S, H, P), dt (B, S, H), a (H,), bmat and cmat (B, S, N) shared by
    every head.  Within a chunk the quadratic form with the decay mask; across
    chunks one carried state.  Returns y (B, S, H, P).
    """
    b, s, h, p = x.shape
    L = min(chunk, s)
    pad = -s % L
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bmat, cmat = F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad))
    nc = x.shape[1] // L
    n = bmat.shape[-1]
    xc = (x * dt[..., None]).reshape(b, nc, L, h, p)           # dt_t x_t
    la = (dt * a).reshape(b, nc, L, h).cumsum(dim=2)           # log decay from the chunk's start
    bc, cc = bmat.reshape(b, nc, L, n), cmat.reshape(b, nc, L, n)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]          # (b, c, t, s, h): log decay s -> t
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    y = torch.einsum("bcts,bctsh,bcshp->bcthp", cb, decay, xc)
    # each chunk's own contribution to the state at its end, then the carry
    to_end = torch.exp(la[:, :, -1:, :] - la)                  # (b, c, s, h)
    own = torch.einsum("bcsh,bcsn,bcshp->bchpn", to_end, bc, xc)
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(la[:, c, -1])[:, :, None, None] + own[:, c]
    entering = torch.stack(entering, dim=1)                    # (b, c, h, p, n)
    y = y + torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(la), cc, entering)
    return y.reshape(b, nc * L, h, p)[:, :s]


def mixer(arch: dict, w: dict, pre: str, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    k = dims(arch)
    b, s, _ = x.shape
    z = nm.mm(x, w[pre + "wz"])
    xs = nm.mm(x, w[pre + "wx"])
    bm = nm.mm(x, w[pre + "wb"])
    cm = nm.mm(x, w[pre + "wc"])
    dt = nm.mm(x, w[pre + "wdt"])
    xs = F.silu(causal_conv(xs, w[pre + "conv_x"], w[pre + "conv_bx"]))
    bm = F.silu(causal_conv(bm, w[pre + "conv_b"], w[pre + "conv_bb"]))
    cm = F.silu(causal_conv(cm, w[pre + "conv_c"], w[pre + "conv_bc"]))
    dt = F.softplus(dt + w[pre + "dt_bias"])
    a = -torch.exp(w[pre + "a_log"])
    xh = xs.reshape(b, s, k["h"], k["p"])
    y = ssd_chunked(nm.q(xh), dt, a, nm.q(bm), nm.q(cm), arch["ssm_chunk"])
    y = y + xh * w[pre + "d_skip"][:, None]
    y = rmsnorm(y.reshape(b, s, k["di"]) * F.silu(z), w[pre + "norm.scale"], arch["norm_eps"])
    return nm.mm(y, w[pre + "out_proj"])


def _layer(arch: dict, w: dict, i: int, nm: Numerics, x: torch.Tensor) -> torch.Tensor:
    pre = f"layers.{i}."
    return x + mixer(arch, w, pre + "ssm.", rmsnorm(x, w[pre + "norm.scale"], arch["norm_eps"]), nm)


def hidden(arch: dict, w: dict, tokens: torch.Tensor, nm: Numerics, remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S)."""
    x = w["embedding.embed"][tokens.long()]
    for i in range(arch["num_layers"]):
        if remat:
            x = checkpoint(_layer, arch, w, i, nm, x, use_reentrant=False)
        else:
            x = _layer(arch, w, i, nm, x)
    return rmsnorm(x, w["final_norm.scale"], arch["norm_eps"])


def head(arch: dict, w: dict, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    if arch["tie_embeddings"]:
        return nm.mm(x, w["embedding.embed"].T)
    return nm.mm(x, w["embedding.unembed"])


# ------------------------------------------------------------------ uses
def set_f32_matmul() -> None:
    """Plain float32 products: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@torch.no_grad()
def next_token_logits(arch: dict, w: dict, tokens: torch.Tensor, start: int, precision: str = "f32") -> torch.Tensor:
    """float32 logits (B, S - start, V) at positions start..S-1 of ``tokens`` (B, S):
    position t scores the token that follows it."""
    set_f32_matmul()
    nm = Numerics(precision)
    x = hidden(arch, w, tokens, nm)
    return head(arch, w, x[:, start:], nm)


def loss(arch: dict, w: dict, tokens: torch.Tensor, labels: torch.Tensor, precision: str = "f32",
         row_block: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy over every label, each layer recomputed in the backward.
    The head and the softmax run on ``row_block`` positions at a time."""
    set_f32_matmul()
    nm = Numerics(precision)
    x = hidden(arch, w, tokens, nm, remat=True)
    x, labels = x.reshape(-1, x.shape[-1]), labels.reshape(-1).long()
    total = x.new_zeros(())
    for lo in range(0, x.shape[0], row_block):
        part = lambda xb, lb: F.cross_entropy(head(arch, w, xb, nm), lb, reduction="sum")
        total = total + checkpoint(part, x[lo:lo + row_block], labels[lo:lo + row_block], use_reentrant=False)
    return total / labels.numel()


# ----------------------------------------------------------------- AdamW
def adamw_lr(ocfg: dict, step: int) -> float:
    """Linear warm-up, then a cosine down to ``min_lr_ratio`` of the peak at ``total_steps``."""
    warm = min(step / max(ocfg["warmup_steps"], 1), 1.0)
    frac = min(max((step - ocfg["warmup_steps"]) / max(ocfg["total_steps"] - ocfg["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return ocfg["lr"] * warm * (ocfg["min_lr_ratio"] + (1 - ocfg["min_lr_ratio"]) * cos)


@torch.no_grad()
def adamw_step(ocfg: dict, w: dict, grads: dict, state: dict) -> dict:
    """AdamW with decoupled weight decay and global-norm clipping, in float32, in place.
    Returns each weight's gradient after clipping, as the update used it."""
    state["step"] = state.get("step", 0) + 1
    t = state["step"]
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    scale = torch.clamp(ocfg["grad_clip"] / (norm + 1e-9), max=1.0) if ocfg["grad_clip"] else 1.0
    lr = adamw_lr(ocfg, t)
    b1, b2 = ocfg["b1"], ocfg["b2"]
    clipped = {}
    for name, g in grads.items():
        g = g * scale
        clipped[name] = g
        m = state.setdefault("m", {}).setdefault(name, torch.zeros_like(g))
        v = state.setdefault("v", {}).setdefault(name, torch.zeros_like(g))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + ocfg["eps"]) + ocfg["weight_decay"] * w[name]
        w[name].sub_(lr * update)
    return clipped
