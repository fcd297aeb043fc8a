"""The port's SSD scan (plain PyTorch path) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The JAX
side runs its Pallas kernel in interpret mode and its jnp reference, as the
reference's own kernel tests do.
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

