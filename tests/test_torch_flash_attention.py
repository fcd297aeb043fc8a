"""The port's flash-attention plain version against the JAX package's kernel, on the CPU.

The same inputs, made with numpy from a seed, go through the port's
``ref.py``, the Pallas kernel in interpret mode and the reference's oracle,
at the bars of the reference's own kernel tests: 2e-5 in float32, 2e-2 in
bfloat16 (abs and rel).  A plain-torch mirror of the bfloat16 CUDA kernel's
schedule holds its arithmetic (P carried as two bfloat16 terms) to the bar
that the card tests hold the kernel to.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, s, h, kh, d, seed, dtype="float32"):
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
    jx = [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref, tol):
    np.testing.assert_allclose(_f32(port), _f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "b,s,h,kh,d,bq,bk",
    [
        (1, 128, 4, 2, 32, 64, 64),
        (2, 256, 8, 2, 64, 128, 128),
        (1, 256, 4, 4, 32, 64, 128),   # MHA
        (1, 512, 2, 1, 64, 128, 256),  # MQA, rectangular blocks
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_and_jax_ref(b, s, h, kh, d, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, s, h, kh, d, b * s + h, dtype)
    out = flash_attention_ref(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, interpret=True), TOL[dtype])
    _close(out, jax_ref(jq, jk, jv), TOL[dtype])


@pytest.mark.parametrize("window", [32, 1, 200])
def test_ref_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 128, 4, 2, 32, 0)
    out = flash_attention_ref(q, k, v, window=window)
    _close(out, flash_attention_pallas(jq, jk, jv, block_q=64, block_k=64, window=window, interpret=True), 2e-5)
    _close(out, jax_ref(jq, jk, jv, window=window), 2e-5)


def test_ref_is_causal():
    """Future tokens must not affect earlier outputs: perturb the tail, check the head."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 128, 2, 2, 32, 1)
    out1 = flash_attention_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = flash_attention_ref(q, k2, v2)
    np.testing.assert_allclose(out1[:, :100].numpy(), out2[:, :100].numpy(), atol=1e-6)
    pallas2 = flash_attention_pallas(jq, jnp.asarray(k2.numpy()), jnp.asarray(v2.numpy()),
                                     block_q=64, block_k=64, interpret=True)
    _close(out2, pallas2, 2e-5)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_ref_ragged_sequence(s):
    """The card kernel takes any S; its plain version does too (the Pallas kernel does not)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, s, 4, 2, 16, s)
    _close(flash_attention_ref(q, k, v), jax_ref(jq, jk, jv), 2e-5)


def test_ops_on_cpu_runs_the_plain_version():
    _, (q, k, v) = _inputs(1, 64, 4, 2, 32, 3)
    before = ops.LAUNCHES
    assert torch.equal(ops.flash_attention(q, k, v, window=16), flash_attention_ref(q, k, v, window=16))
    assert ops.LAUNCHES == before  # no kernel launched


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(1, 64, 4, 2, 32, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v)


# ------------------------------------------------- the bf16 kernel's arithmetic
# The card holds each bfloat16 output element within these bars of the float32
# plain version of the same inputs (chip_smoke.py's FA_BF16_VS_F32).
BF16_VS_F32 = dict(atol=1e-5, rtol=2**-7)


def _kernel_schedule(q, k, v, *, window=0, split_p=True, zero_shift=True, bq=64, bk=64):
    """``csrc/flash_attention.cu``'s bfloat16 kernel in plain torch: each 64-row
    consumer warpgroup's bq x bk tiles from its first row's window to its
    diagonal, float32 logits, an online softmax whose max is taken on the raw
    logits and whose exponent is one FMA, s * c + shift with c = scale * log2(e)
    and shift = -m * c (0 while the row's max is the mask value, unless
    ``zero_shift`` is false), rounded once as the FMA rounds (float64 holds the
    product exactly), P split into bfloat16 hi and lo terms for the product
    with v (or, with ``split_p`` false, rounded once), the output divided by
    max(l, 1e-30) and rounded to bfloat16."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qf = q.float().transpose(1, 2)                                      # (B, H, S, D)
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    # the wrapper passes the scale as a C float; the kernel multiplies it by log2(e) in float32
    scale_log2 = torch.tensor(d**-0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.empty(b, h, s, d)
    for q0 in range(0, s, bq):
        rows = torch.arange(q0, min(q0 + bq, s))
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        kt_lo = max(0, q0 - window + 1) // bk if window else 0
        for k0 in range(kt_lo * bk, rows[-1].item() + 1, bk):
            keys = torch.arange(k0, min(k0 + bk, s))
            x = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            keep = keys[None, :] <= rows[:, None]
            if window:
                keep &= rows[:, None] - keys[None, :] < window
            x = torch.where(keep, x, -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - m_new) * scale_log2)
            shift = -m_new * scale_log2
            if zero_shift:
                shift = torch.where(m_new == -1e30, 0.0, shift)
            p = torch.exp2((x.double() * scale_log2.double() + shift.double()[..., None]).float())
            l = l * alpha + p.sum(-1)
            p_hi = p.to(torch.bfloat16).float()
            pv = p_hi @ vf[:, :, keys]
            if split_p:
                pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vf[:, :, keys]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


# the card tests' shapes that are cheap here: ragged S with a window and D % 16 != 0,
# a sliding window, windows at D = 64 that leave some rows no key in their
# warpgroup's first tile, and ragged S at the head dim of qwen2.5-3b
MIRROR_SHAPES = [(1, 77, 2, 1, 24, 20), (2, 128, 4, 2, 32, 32), (2, 128, 4, 2, 64, 32),
                 (2, 300, 4, 1, 64, 70), (2, 1000, 4, 2, 128, 0)]


@pytest.mark.parametrize("b,s,h,kh,d,window", MIRROR_SHAPES)
def test_kernel_schedule_with_split_p_meets_the_card_bars(b, s, h, kh, d, window):
    _, (q, k, v) = _inputs(b, s, h, kh, d, b * s + h, "bfloat16")
    out = _kernel_schedule(q, k, v, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(), window=window)
    torch.testing.assert_close(out.float(), ref32, **BF16_VS_F32)
    _close(out, flash_attention_ref(q, k, v, window=window), TOL["bfloat16"])


def test_rounding_p_once_misses_the_card_bar():
    """A single bfloat16 rounding of P, as a textbook kernel does, fails the bar
    that the split passes: the check has teeth."""
    b, s, h, kh, d, window = MIRROR_SHAPES[-1]
    _, (q, k, v) = _inputs(b, s, h, kh, d, b * s + h, "bfloat16")
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(), window=window)
    once = _kernel_schedule(q, k, v, window=window, split_p=False).float()
    assert not torch.allclose(once, ref32, **BF16_VS_F32)
    assert torch.allclose(_kernel_schedule(q, k, v, window=window).float(), ref32, **BF16_VS_F32)


def test_rows_with_no_key_in_a_tile_need_the_zero_shift():
    """At D = 64 the FMA's rounding error of -1e30 * c is positive: a row whose
    keys in a tile all lie before its window would get p = inf, then NaN,
    without the kernel's zero shift."""
    b, s, h, kh, d, window = 2, 128, 4, 2, 64, 32
    _, (q, k, v) = _inputs(b, s, h, kh, d, b * s + h, "bfloat16")
    assert not torch.isfinite(_kernel_schedule(q, k, v, window=window, zero_shift=False).float()).all()
    assert torch.isfinite(_kernel_schedule(q, k, v, window=window).float()).all()
