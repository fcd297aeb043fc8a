"""The port's SSD scan (plain PyTorch path) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The JAX
side runs its Pallas kernel in interpret mode and its jnp reference, as the
reference's own kernel tests do.  A plain-torch mirror of the bfloat16 CUDA
kernel's four stages holds its roundings to the bars that the card tests hold
the kernel to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference_sequential, ssd_scan_ref


def _inputs(b, s, h, p, g, n, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal((b, s, h)))) * 0.5).astype(np.float32)
    a = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (r.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cm = (r.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


def _torch(arrays):
    return [torch.from_numpy(v) for v in arrays]


def _jax(arrays):
    return [jnp.asarray(v) for v in arrays]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "b,s,h,p,g,n,L",
    [
        (2, 64, 4, 16, 1, 16, 16),
        (1, 128, 4, 32, 2, 32, 32),
        (2, 256, 8, 64, 1, 64, 64),
        (1, 64, 2, 8, 1, 8, 64),  # single chunk
    ],
)
def test_ref_matches_jax_kernel_and_ref(b, s, h, p, g, n, L):
    arrays = _inputs(b, s, h, p, g, n, seed=s + h)
    y, st = ssd_scan_ref(*_torch(arrays), chunk=L)
    y_pl, st_pl = ssd_scan_pallas(*_jax(arrays), chunk=L, interpret=True)
    y_jr, st_jr = jax_ssd_scan_ref(*_jax(arrays), chunk=L)
    for ref_y, ref_st in ((y_pl, st_pl), (y_jr, st_jr)):
        _close(y, ref_y, 2e-4)
        _close(st, ref_st, 2e-4)


def test_chunked_ref_matches_sequential():
    x, dt, a, bm, cm = _torch(_inputs(2, 48, 4, 8, 2, 4, seed=3))
    y1, s1 = ssd_scan_ref(x, dt, a, bm, cm, chunk=16)
    y2, s2 = ssd_reference_sequential(x, dt, a, bm, cm)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-4, rtol=0)


def test_initial_state_continuation():
    """Splitting a sequence in half and carrying state == one pass."""
    x, dt, a, bm, cm = _torch(_inputs(1, 64, 2, 8, 1, 8, seed=4))
    y_full, s_full = ssd_scan_ref(x, dt, a, bm, cm, chunk=16)
    half = x.shape[1] // 2
    y1, s1 = ssd_scan_ref(x[:, :half], dt[:, :half], a, bm[:, :half], cm[:, :half], chunk=16)
    y2, s2 = ssd_scan_ref(
        x[:, half:], dt[:, half:], a, bm[:, half:], cm[:, half:], chunk=16, initial_state=s1
    )
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=0)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=0)
    # the sequential oracle carries the same state across the split
    y2s, s2s = ssd_reference_sequential(
        x[:, half:], dt[:, half:], a, bm[:, half:], cm[:, half:], initial_state=s1
    )
    torch.testing.assert_close(y2s, y2, atol=1e-4, rtol=0)
    torch.testing.assert_close(s2s, s2, atol=1e-4, rtol=0)


@pytest.mark.parametrize("s,L", [(40, 16), (100, 32)])
def test_ops_ragged_sequence_on_cpu_matches_jax(s, L):
    arrays = _inputs(2, s, 4, 8, 2, 8, seed=s)
    before = ops.LAUNCHES
    y, st = ops.ssd_scan(*_torch(arrays), chunk=L)
    assert ops.LAUNCHES == before  # the CPU path never reaches the kernel
    assert y.shape == (2, s, 4, 8) and st.shape == (2, 4, 8, 8)
    y_jr, st_jr = jax_ssd_scan_ref(*_jax(arrays), chunk=L)
    _close(y, y_jr, 2e-4)
    _close(st, st_jr, 2e-4)


@pytest.mark.parametrize("s,chunk,L", [(40, 16, 16), (1000, 256, 256), (10, 256, 16), (48, 64, 48)])
def test_kernel_padding_is_exact(s, chunk, L):
    """The zero padding the CUDA branch applies leaves y and the state unchanged."""
    x, dt, a, bm, cm = _torch(_inputs(1, s, 2, 8, 1, 8, seed=s))
    xp, dtp, bp, cp, kernel_L = ops.pad_to_chunks(x, dt, bm, cm, chunk=chunk)
    assert kernel_L == L and xp.shape[1] % L == 0 and xp.shape[1] - s < L
    y, st = ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
    yp, stp = ssd_scan_ref(xp, dtp, a, bp, cp, chunk=kernel_L)
    torch.testing.assert_close(yp[:, :s], y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(stp, st, atol=1e-4, rtol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    x, dt, a, bm, cm = _torch(_inputs(1, 16, 2, 8, 1, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan_cuda(x, dt, a, bm, cm, chunk=16)



# ------------------------------------------------- the bf16 kernel's arithmetic
# The card holds the bfloat16 kernel to these bars (abs and rel) against the
# float32 plain version of its inputs (tests/test_torch_gpu.py, chip_smoke.py).
CARD_BARS = {"y": 2e-2, "state": 1e-3}


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _terms(v, split):
    """v as the kernel feeds it to a bfloat16 product: hi (+ lo = v - hi)."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def _kernel_schedule(x, dt, a, bm, cm, *, L, split_state=True, split_scores=True, split_s_in=True):
    """``csrc/ssd_scan.cu``'s bfloat16 path in plain torch, stage by stage.

    1. ``cb``: C Bᵀ per (batch, chunk, group) from the bfloat16 inputs, float32 sums.
    2. ``chunk_state``: cum = cumsum(dt a); each chunk's own state
       (w x)ᵀ B with w_s = exp(cum_L - cum_s) dt_s, the float32 w x carried as
       bfloat16 hi + lo (rounded once with ``split_state`` false).
    3. ``state_pass``: S_in[c] = exp(cum_L[c-1]) S_in[c-1] + state[c-1] in float32.
    4. ``chunk_out``: y = exp(cum_l) C S_inᵀ + W x with W = CB exp(cum_l - cum_s) dt_s,
       masked to s <= l before the exp; W and S_in are each carried as hi + lo
       (rounded once with ``split_scores`` / ``split_s_in`` false); y rounded to bfloat16.

    The kernel takes the decay below its 64-row diagonal tiles as a product of
    two exps; that differs from the one exp here by float32 rounding only.
    """
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc, rep = s // L, h // g
    cc = cm.float().reshape(b, nc, L, g, n).transpose(2, 3)            # (B, nc, G, L, N)
    bc = bm.float().reshape(b, nc, L, g, n).transpose(2, 3)
    cb = cc @ bc.transpose(-1, -2)                                      # stage 1: (B, nc, G, L, L)
    dtc = dt.reshape(b, nc, L, h).transpose(2, 3)                       # (B, nc, H, L)
    cum = (dtc * a[:, None]).cumsum(-1)
    xc = x.float().reshape(b, nc, L, h, p).transpose(2, 3)             # (B, nc, H, L, P)
    wx = (torch.exp(cum[..., -1:] - cum) * dtc)[..., None] * xc
    bh = bc.repeat_interleave(rep, dim=2)
    states = sum(t.transpose(-1, -2) @ bh for t in _terms(wx, split_state))  # stage 2: (B, nc, H, P, N)
    run, s_in = torch.zeros(b, h, p, n), []
    for c in range(nc):                                                 # stage 3
        s_in.append(run)
        run = run * torch.exp(cum[:, c, :, -1])[..., None, None] + states[:, c]
    s_in = torch.stack(s_in, 1)
    causal = torch.ones(L, L, dtype=torch.bool).tril()                 # stage 4
    decay = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0))
    w = torch.where(causal, cb.repeat_interleave(rep, dim=2) * decay * dtc[..., None, :], 0.0)
    inter = sum(cc.repeat_interleave(rep, dim=2) @ t.transpose(-1, -2) for t in _terms(s_in, split_s_in))
    y = inter * torch.exp(cum)[..., None] + sum(t @ xc for t in _terms(w, split_scores))
    return y.transpose(2, 3).reshape(b, s, h, p).to(torch.bfloat16), run


def _bf16_inputs(b, s, h, p, g, n, seed):
    x, dt, a, bm, cm = _torch(_inputs(b, s, h, p, g, n, seed))
    return x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16()


def _worst(got, ref, bar):
    """The largest |got - ref| / (bar + bar |ref|): at most 1 inside the bar."""
    return ((got.float() - ref).abs() / (bar + bar * ref.abs())).max().item()


# chip_smoke.py's TEST_SHAPES (G = 2 and a single chunk among them), then a
# serving-width slice of mamba2-780m (P = 64, N = 128, L = 256) small enough here
MIRROR_SHAPES = [(2, 64, 4, 16, 1, 16, 16), (1, 128, 4, 32, 2, 32, 32), (2, 256, 8, 64, 1, 64, 64),
                 (1, 64, 2, 8, 1, 8, 64), (1, 1024, 2, 64, 1, 128, 256)]


@pytest.mark.parametrize("b,s,h,p,g,n,L", MIRROR_SHAPES)
def test_kernel_schedule_meets_the_card_bars(b, s, h, p, g, n, L):
    args = _bf16_inputs(b, s, h, p, g, n, seed=b * s + h)
    L = min(L, s)
    y, state = _kernel_schedule(*args, L=L)
    y_ref, state_ref = ssd_scan_ref(*args, chunk=L)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    assert _worst(y, y_ref, CARD_BARS["y"]) < 0.5  # the final bfloat16 rounding alone takes ~0.1
    assert _worst(state, state_ref, CARD_BARS["state"]) < 0.05


def test_rounding_once_misses_the_card_bars():
    """Each split is needed at the serving width.  The chunk states rounded once
    to bfloat16 miss the state bar.  The scores and S_in rounded once take
    0.58-1.08 of the y bar at this two-head slice, by seed (the serving shape
    has 96 times its elements), against 0.17 with the split."""
    b, s, h, p, g, n, L = MIRROR_SHAPES[-1]
    args = _bf16_inputs(b, s, h, p, g, n, seed=b * s + h)
    y_ref, state_ref = ssd_scan_ref(*args, chunk=L)
    y, state = _kernel_schedule(*args, L=L)
    assert _worst(y, y_ref, CARD_BARS["y"]) < 0.2 and _worst(state, state_ref, CARD_BARS["state"]) < 0.05
    _, state_once = _kernel_schedule(*args, L=L, split_state=False)
    assert _worst(state_once, state_ref, CARD_BARS["state"]) > 1
    y_once, _ = _kernel_schedule(*args, L=L, split_scores=False, split_s_in=False)
    assert _worst(y_once, y_ref, CARD_BARS["y"]) > max(0.5, 3 * _worst(y, y_ref, CARD_BARS["y"]))
