"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips (inside each test) where ``torch.cuda.is_available()`` is false.  Run on
a machine with an H100: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

pytestmark = pytest.mark.gpu

# f32 bar of the reference's kernel tests; bf16 y at its bf16 bar; the state
# stays f32 in both versions, so only the order of the sums differs there.
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD scan kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, s, h, p, g, n, seed, dtype, device):
    r = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(r.standard_normal(shape) * scale, dtype=torch.float32, device=device)

    x = t((b, s, h, p)).to(dtype)
    dt = F.softplus(t((b, s, h))) * 0.5
    a = -torch.exp(t((h,), 0.3))
    bm = t((b, s, g, n), 0.5).to(dtype)
    cm = t((b, s, g, n), 0.5).to(dtype)
    return x, dt, a, bm, cm


def _check(out, ref, dtype):
    ytol, stol = TOL[dtype]
    torch.testing.assert_close(out[0].float(), ref[0], atol=ytol, rtol=ytol)
    torch.testing.assert_close(out[1], ref[1], atol=stol, rtol=stol)


@pytest.mark.parametrize(
    "b,s,h,p,g,n,L",
    [
        (4, 1024, 48, 64, 1, 128, 256),  # mamba2-780m serving shape
        (2, 64, 4, 16, 1, 16, 16),
        (1, 128, 4, 32, 2, 32, 32),
        (2, 256, 8, 64, 1, 64, 64),
        (1, 64, 2, 8, 1, 8, 64),  # single chunk
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_ref(cuda, b, s, h, p, g, n, L, dtype):
    args = _inputs(b, s, h, p, g, n, s + h, dtype, cuda)
    out = kernel.ssd_scan_cuda(*args, chunk=min(L, s))
    torch.cuda.synchronize()
    assert out[0].dtype == dtype and out[1].dtype == torch.float32
    _check(out, ssd_scan_ref(*args, chunk=L), dtype)


@pytest.mark.parametrize("s,L", [(1000, 256), (40, 16), (10, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_ops_pads_ragged_sequence(cuda, s, L, dtype):
    args = _inputs(2, s, 4, 64, 1, 128, s, dtype, cuda)
    before = ops.LAUNCHES
    out = ops.ssd_scan(*args, chunk=L)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert out[0].shape == (2, s, 4, 64)
    _check(out, ssd_scan_ref(*args, chunk=L), dtype)


def test_ssd_kernel_rejects_what_it_cannot_take(cuda):
    x, dt, a, bm, cm = _inputs(1, 48, 2, 8, 1, 8, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk"):
        kernel.ssd_scan_cuda(x, dt, a, bm, cm, chunk=24)
    with pytest.raises(ValueError, match="dtype"):
        kernel.ssd_scan_cuda(x, dt, a, bm.to(torch.bfloat16), cm, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan_cuda(x.cpu(), dt, a, bm, cm, chunk=16)
