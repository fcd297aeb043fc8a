"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips (inside each test) where ``torch.cuda.is_available()`` is false.  Run on
a machine with an H100: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.merge_runs import kernel as merge_kernel
from repro_torch.kernels.merge_runs import ops as merge_ops
from repro_torch.kernels.merge_runs.ref import merge_runs_ref, words
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

pytestmark = pytest.mark.gpu

# ssd: f32 bar of the reference's kernel tests; bf16 y at its bf16 bar; the state
# stays f32 in both versions, so only the order of the sums differs there.
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
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
        (1, 64, 2, 8, 1, 8, 64),  # single chunk; ragged P and N in the bf16 MMA tiles
        (2, 4096, 8, 64, 1, 128, 256),  # 16 chunks: the bf16 state pass carries across many
        (1, 1024, 4, 64, 2, 128, 256),  # two groups at the serving chunk
        (1, 96, 3, 12, 1, 20, 32),  # P and N not multiples of 8: no 16-byte copies
        (1, 256, 2, 128, 1, 128, 64),  # two 64-wide P tiles in bf16
        (1, 256, 2, 64, 1, 192, 64),  # a full and a ragged 128-wide N tile in bf16
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


# ------------------------------------------------------------ flash attention
# The reference's kernel-test bars (tests/test_kernels.py): abs and rel.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _fa_inputs(b, s, h, kh, d, seed, dtype, device):
    r = np.random.default_rng(seed)
    return [
        torch.tensor(r.standard_normal(shape), dtype=torch.float32, device=device).to(dtype)
        for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))
    ]


@pytest.mark.parametrize(
    "b,s,h,kh,d,window",
    [
        (1, 128, 4, 2, 32, 0),
        (2, 256, 8, 2, 64, 0),
        (1, 256, 4, 4, 32, 0),     # MHA
        (1, 512, 2, 1, 64, 0),     # MQA
        (2, 128, 4, 2, 32, 32),    # sliding window
        (2, 1000, 4, 2, 128, 0),   # ragged S, the head dim of qwen2.5-3b
        (1, 77, 2, 1, 24, 20),     # ragged S and window, D % 16 != 0
        (4, 1024, 16, 2, 128, 0),  # the forward shape of qwen2.5-3b
        # windows that leave some rows no key in their warpgroup's first tile, at head
        # dims where the rounding error of -1e30 * scale * log2(e) is positive
        (2, 128, 4, 2, 64, 32),
        (2, 300, 4, 1, 64, 70),
        (1, 260, 4, 2, 48, 50),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_ref(cuda, b, s, h, kh, d, window, dtype):
    _check_flash(cuda, b, s, h, kh, d, window, dtype)


# the bf16 kernel's edges: D not a multiple of its 64-column TMA boxes (8, 48, 96),
# S of one row or one past a 64-key tile or the 128-row q tile, and a window wider than S
@pytest.mark.parametrize(
    "b,s,h,kh,d,window",
    [(1, s, 4, 2, d, 0) for d in (8, 48, 96) for s in (1, 65, 129)] + [(2, 100, 4, 1, 64, 500)],
)
def test_flash_bf16_kernel_edges(cuda, b, s, h, kh, d, window):
    _check_flash(cuda, b, s, h, kh, d, window, torch.bfloat16)


def _check_flash(device, b, s, h, kh, d, window, dtype):
    q, k, v = _fa_inputs(b, s, h, kh, d, b * s + h, dtype, device)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=FA_TOL[dtype], rtol=FA_TOL[dtype])
    if dtype == torch.bfloat16:
        # the kernel keeps the softmax in float32 and carries P into the product
        # with v as two bfloat16 terms (about 16 bits), then rounds its output:
        # each element lies within twice bfloat16's unit roundoff of the float32
        # plain version
        ref32 = flash_attention_ref(q.float(), k.float(), v.float(), window=window)
        torch.testing.assert_close(out.float(), ref32, atol=1e-5, rtol=2**-7)


def test_flash_kernel_is_causal(cuda):
    q, k, v = _fa_inputs(1, 128, 2, 2, 32, 1, torch.float32, cuda)
    out1 = fa_kernel.flash_attention_cuda(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = fa_kernel.flash_attention_cuda(q, k2, v2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out1[:, :100], out2[:, :100], atol=1e-6, rtol=0)


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v = _fa_inputs(1, 64, 4, 2, 136, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_cuda(q, k, v)
    q, k, v = _fa_inputs(1, 64, 4, 2, 20, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_cuda(q, k, v)
    q, k, v = _fa_inputs(1, 64, 4, 2, 32, 0, torch.float16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_cuda(q, k, v)
    q, k, v = _fa_inputs(1, 64, 4, 2, 32, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q.cpu(), k, v)
    q3, k3, v3 = _fa_inputs(1, 64, 6, 4, 32, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="agree"):
        fa_kernel.flash_attention_cuda(q3, k3, v3)
    qb, kb, vb = _fa_inputs(1, 64, 4, 2, 32, 0, torch.bfloat16, cuda)
    shifted = torch.empty(kb.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(kb.shape)
    shifted.copy_(kb)  # contiguous, its base 2 bytes past a 16-byte boundary
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.flash_attention_cuda(qb, shifted, vb)


# ---------------------------------------------------------------- merge runs
# The reference's bar (tests/test_kernels.py) is keys exactly equal and equal
# (key, payload) multisets, since its kernel leaves the order among equal keys
# open.  The port's kernel is a stable merge, so it is held to more: keys and
# payloads equal to the plain version in place (the multisets are checked too).
def _merge_inputs(g, t, key_dtype, seed, device, val_dtype=torch.int32, distinct=0):
    r = np.random.default_rng(seed)

    def keys():
        if key_dtype == torch.float32:
            return torch.from_numpy(np.sort(r.standard_normal((g, t)).astype(np.float32), axis=1))
        hi = distinct or (1 << 32 if key_dtype == torch.uint32 else 1 << 31)
        lo = 0 if distinct or key_dtype == torch.uint32 else -(1 << 31)
        k = np.sort(r.integers(lo, hi, (g, t), dtype=np.int64), axis=1)
        return torch.from_numpy(k.astype(np.uint32 if key_dtype == torch.uint32 else np.int32))

    def vals():
        if val_dtype == torch.float32:
            return torch.from_numpy(r.standard_normal((g, t)).astype(np.float32))
        return torch.from_numpy(r.integers(-(1 << 31), 1 << 31, (g, t)).astype(np.int32))

    return [x.to(device) for x in (keys(), keys(), vals(), vals())]


def _pairs(keys, vals):
    return torch.sort((words(keys).to(torch.int64) << 32) | (words(vals).to(torch.int64) & 0xFFFFFFFF), dim=1)[0]


def _check_merge(out, args):
    ref = merge_runs_ref(*args)
    torch.cuda.synchronize()
    assert out[0].dtype == args[0].dtype and out[1].dtype == args[2].dtype
    assert torch.equal(words(out[0]), words(ref[0]))
    assert torch.equal(words(out[1]), words(ref[1]))
    assert torch.equal(_pairs(*out), _pairs(*ref))


@pytest.mark.parametrize(
    "g,t", [(8, 64), (16, 128), (8, 256), (32, 32), (1, 512), (13, 64), (1000, 1), (1001, 2), (16384, 512)]
)
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.float32])
def test_merge_kernel_matches_ref(cuda, g, t, key_dtype):
    args = _merge_inputs(g, t, key_dtype, g * t, cuda)
    _check_merge(merge_kernel.merge_runs_cuda(*args), args)


@pytest.mark.parametrize("val_dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("distinct", [0, 3])
def test_merge_kernel_uint32_keys(cuda, val_dtype, distinct):
    args = _merge_inputs(64, 512, torch.uint32, 7, cuda, val_dtype=val_dtype, distinct=distinct)
    _check_merge(merge_kernel.merge_runs_cuda(*args), args)


def test_merge_kernel_takes_t_8192_and_refuses_16384(cuda):
    for key_dtype in (torch.int32, torch.uint32, torch.float32):
        args = _merge_inputs(5, merge_kernel.MAX_T, key_dtype, 3, cuda)
        _check_merge(merge_kernel.merge_runs_cuda(*args), args)
    with pytest.raises(ValueError, match="8192"):
        merge_kernel.merge_runs_cuda(*_merge_inputs(2, 2 * merge_kernel.MAX_T, torch.int32, 3, cuda))
    with pytest.raises(ValueError, match="power of two"):
        merge_kernel.merge_runs_cuda(*_merge_inputs(2, 48, torch.int32, 3, cuda))
    with pytest.raises(ValueError, match="int32, uint32 or float32"):
        merge_kernel.merge_runs_cuda(*(x.to(torch.int64) for x in _merge_inputs(2, 8, torch.int32, 3, cuda)))


@pytest.mark.parametrize("g,t", [(262144, 32), (1024, 8192)])
def test_merge_kernel_268_mb_shapes(cuda, g, t):
    """Short tiles (8 rows a block) and MAX_T (a row over 8 blocks), 268 MB each."""
    args = _merge_inputs(g, t, torch.int32, 12, cuda)
    _check_merge(merge_kernel.merge_runs_cuda(*args), args)


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("t", [64, 4096])
def test_merge_tiles_takes_a_misaligned_slice(cuda, key_dtype, t):
    """Tiles cut from larger tensors at an offset of one element: contiguous,
    4 bytes past a 16-byte boundary, so the kernel takes its 4-byte path."""
    args = _merge_inputs(7, t, key_dtype, 13, cuda, distinct=5 if key_dtype == torch.int32 else 0)
    shifted = []
    for x in args:
        s = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
        s.copy_(x)
        assert s.is_contiguous() and s.data_ptr() % 16 == 4
        shifted.append(s)
    _check_merge(merge_ops.merge_tiles(*shifted), args)


def test_merge_tiles_counts_launches(cuda):
    args = _merge_inputs(64, 512, torch.int32, 11, cuda)
    before = merge_ops.LAUNCHES
    out = merge_ops.merge_tiles(*args)
    forced = merge_ops.merge_tiles(*args, impl="cuda", block_rows=3)
    assert merge_ops.LAUNCHES == before + 2
    _check_merge(out, args)
    _check_merge(forced, args)


def test_merge_kernel_nan_keys_are_outside_the_contract(cuda):
    """A NaN compares false, so a row holding one may come out unsorted
    (ROADMAP section 3); the kernel still moves whole (key, payload) pairs, so
    every row keeps its multiset."""
    args = _merge_inputs(4, 64, torch.float32, 5, cuda)
    args[0][1, 10] = float("nan")
    args[1][2, 63] = float("nan")
    out = merge_kernel.merge_runs_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(_pairs(*out), _pairs(torch.cat(args[:2], 1), torch.cat(args[2:], 1)))
    ref = merge_runs_ref(*args)
    assert torch.equal(out[0][[0, 3]], ref[0][[0, 3]])  # rows without a NaN are merged as ever


@pytest.mark.parametrize("t", [64, 4096])
def test_merge_kernel_rows_out_of_order_keep_their_multisets(cuda, t):
    """As the CPU model shows (``test_torch_merge_runs.py``): NaNs inside A and B,
    or a descending run, make the searches' splits cross, and the kernel's
    clamps still move every (key, payload) pair once; a clean row merges as ever."""
    args = _merge_inputs(5, t, torch.float32, 5, cuda)
    args[0][1, 10] = float("nan")
    args[1][2, t - 1] = float("nan")
    args[0][3, t // 5] = args[1][3, t // 3] = float("nan")
    args[0][4] = args[0][4].flip(0)
    out = merge_kernel.merge_runs_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(_pairs(*out), _pairs(torch.cat(args[:2], 1), torch.cat(args[2:], 1)))
    ref = merge_runs_ref(*args)
    assert torch.equal(words(out[0][0]), words(ref[0][0])) and torch.equal(words(out[1][0]), words(ref[1][0]))
