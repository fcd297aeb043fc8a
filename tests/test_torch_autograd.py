"""The gradients of the two kernels' ``torch.autograd.Function``s, on the CPU.

On the card ``ops.SSDScan`` and ``ops.FlashAttention`` run the CUDA kernel
forward and the plain version's gradient backward, recomputed from the saved
inputs.  Here each Function is applied with its launch replaced by the plain
forward (in the test only), and its gradients are held against autograd of
the plain version and ``jax.grad`` of the reference's oracle, at the
reference kernels' f32 bars (``tests/test_kernels.py``): 2e-4 for the scan,
2e-5 for attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_fa_ref
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SSD_TOL = 2e-4
FA_TOL = 2e-5


@pytest.fixture
def plain_launches(monkeypatch):
    """Each kernel's launch replaced by its plain forward, y in x's dtype as the kernel writes it."""

    def ssd(x, dt, a, bmat, cmat, *, chunk):
        y, state = ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
        return y.to(x.dtype), state

    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda", ssd)
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", lambda q, k, v, *, window: flash_attention_ref(q, k, v, window=window))


def _ssd_inputs(b, s, h, p, g, n, seed):
    r = np.random.default_rng(seed)
    return [
        r.standard_normal((b, s, h, p)).astype(np.float32),
        (np.log1p(np.exp(r.standard_normal((b, s, h)))) * 0.5).astype(np.float32),
        (-np.exp(0.3 * r.standard_normal(h))).astype(np.float32),
        (0.5 * r.standard_normal((b, s, g, n))).astype(np.float32),
        (0.5 * r.standard_normal((b, s, g, n))).astype(np.float32),
    ]


def _leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,g,n,L", [
    (2, 64, 4, 16, 1, 16, 16),
    (1, 40, 4, 8, 2, 8, 16),  # S % L != 0: the Function pads and slices
    (1, 48, 2, 8, 1, 8, 64),  # one chunk shorter than L
])
@pytest.mark.parametrize("use_state", [True, False], ids=["y+state", "y-only"])
def test_ssd_function_gradients_match_plain_and_jax(plain_launches, b, s, h, p, g, n, L, use_state):
    arrays = _ssd_inputs(b, s, h, p, g, n, seed=s + h)
    r = np.random.default_rng(1)
    wy = r.standard_normal((b, s, h, p)).astype(np.float32)
    ws = r.standard_normal((b, h, p, n)).astype(np.float32)

    def loss(out, asarray):
        y, state = out
        total = (y * asarray(wy)).sum()
        return total + (state * asarray(ws)).sum() if use_state else total

    launches, backwards = ssd_ops.LAUNCHES, ssd_ops.BACKWARDS
    ins = _leaves(arrays)
    out = ssd_ops.SSDScan.apply(*ins, L)
    assert all(t.grad_fn is not None for t in out)
    got = torch.autograd.grad(loss(out, torch.from_numpy), ins)
    assert (ssd_ops.LAUNCHES, ssd_ops.BACKWARDS) == (launches + 1, backwards + 1)

    plain_ins = _leaves(arrays)
    plain = torch.autograd.grad(loss(ssd_scan_ref(*plain_ins, chunk=L), torch.from_numpy), plain_ins)
    ref = jax.grad(lambda *a: loss(jax_ssd_ref(*a, chunk=L), jnp.asarray), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, arrays))
    for name, a, b_, c in zip(("x", "dt", "a", "B", "C"), got, plain, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=SSD_TOL, rtol=SSD_TOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=SSD_TOL, rtol=SSD_TOL, err_msg=name)


def test_ssd_function_gives_no_gradient_to_inputs_that_need_none(plain_launches):
    arrays = _ssd_inputs(1, 32, 2, 8, 1, 8, seed=3)
    ins = [torch.tensor(a, requires_grad=i in (0, 4)) for i, a in enumerate(arrays)]
    y, _ = ssd_ops.SSDScan.apply(*ins, 16)
    y.sum().backward()
    assert [t.grad is not None for t in ins] == [True, False, False, False, True]


@pytest.mark.parametrize("b,s,h,kh,d,window", [
    (1, 64, 4, 2, 16, 0),
    (2, 48, 4, 1, 8, 0),
    (1, 64, 2, 2, 16, 24),  # sliding window
])
def test_flash_function_gradients_match_plain_and_jax(plain_launches, b, s, h, kh, d, window):
    r = np.random.default_rng(s + d)
    arrays = [r.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
    w = r.standard_normal((b, s, h, d)).astype(np.float32)

    launches, backwards = fa_ops.LAUNCHES, fa_ops.BACKWARDS
    ins = _leaves(arrays)
    out = fa_ops.FlashAttention.apply(*ins, window)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ins)
    assert (fa_ops.LAUNCHES, fa_ops.BACKWARDS) == (launches + 1, backwards + 1)

    plain_ins = _leaves(arrays)
    plain = torch.autograd.grad((flash_attention_ref(*plain_ins, window=window) * torch.from_numpy(w)).sum(), plain_ins)
    ref = jax.grad(lambda q, k, v: (jax_fa_ref(q, k, v, window=window) * jnp.asarray(w)).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, arrays))
    for name, a, b_, c in zip("qkv", got, plain, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=FA_TOL, rtol=FA_TOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=FA_TOL, rtol=FA_TOL, err_msg=name)


def test_cpu_paths_stay_plain_and_differentiable():
    """On CPU tensors the ops run the plain version (no launch, no Function), which autograd differentiates."""
    launches = (ssd_ops.LAUNCHES, fa_ops.LAUNCHES)
    x, dt, a, bm, cm = _leaves(_ssd_inputs(1, 32, 2, 8, 1, 8, seed=4))
    y, _ = ssd_ops.ssd_scan(x, F.softplus(dt), a, bm, cm, chunk=16)
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    out = fa_ops.flash_attention(q, q, q)
    assert y.grad_fn is not None and out.grad_fn is not None
    assert not isinstance(y.grad_fn, ssd_ops.SSDScan._backward_cls)
    assert (ssd_ops.LAUNCHES, fa_ops.LAUNCHES) == launches
