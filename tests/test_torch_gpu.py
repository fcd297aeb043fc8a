"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips (inside each test) where ``torch.cuda.is_available()`` is false.  Run on
a machine with an H100: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.merge_runs import kernel as merge_kernel
from repro_torch.kernels.merge_runs import ops as merge_ops
from repro_torch.kernels.merge_runs.ref import merge_runs_ref, words
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssm_decode import ops as sd_ops
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.layers import kv_head_map

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
        (4, 1024, 80, 64, 1, 64, 256),  # zamba2-2.7b's Mamba2 layers at 4 x 1024 tokens
        (2, 1024, 112, 64, 2, 64, 256),  # zamba2-7b-instruct's: 112 heads over two B/C groups
        (2, 1024, 128, 64, 1, 128, 256),  # granite-4.0-h-small's: 128 heads, state 128
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


def test_ssd_kernel_at_falcon_h1s_shape(cuda):
    """bf16 at falcon-h1-34b-instruct's prefill shape: 32 heads of P 128 over two groups of N 256,
    chunk 128, 4 x 1024 tokens (eight chunks), within the bf16 bar of the plain scan.  (The f32
    kernel keeps a head's whole state and tiles in shared memory, 353 KB here: it refuses this shape.)"""
    args = _inputs(4, 1024, 32, 128, 2, 256, 7, torch.bfloat16, cuda)
    out = kernel.ssd_scan_cuda(*args, chunk=128)
    torch.cuda.synchronize()
    _check(out, ssd_scan_ref(*args, chunk=128), torch.bfloat16)


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


def _grads(fn, ins, weights):
    """Gradients of sum(out.float() * w) over the outputs, in x's dtype as the kernel writes y."""
    leaves = [t.detach().requires_grad_() for t in ins]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)  # the kernel's outputs carry the graph on the card
    loss = sum((o.to(ins[0].dtype).float() * w).sum() for o, w in zip(outs, weights))
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("b,s,h,p,g,n,L", [(4, 1024, 48, 64, 1, 128, 256), (4, 1024, 80, 64, 1, 64, 256)],
                         ids=["mamba2-780m", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_kernel_forward_plain_backward(cuda, b, s, h, p, g, n, L, dtype):
    """ops.ssd_scan on the card (kernel forward, plain backward) against autograd of
    the plain version, at the train path's shapes; bars are the forward's own (y's)."""
    args = _inputs(b, s, h, p, g, n, 11, dtype, cuda)
    r = torch.Generator(device=cuda).manual_seed(0)
    weights = [torch.randn((b, s, h, p), generator=r, device=cuda), torch.randn((b, h, p, n), generator=r, device=cuda)]
    launches, backwards = ops.LAUNCHES, ops.BACKWARDS
    got = _grads(lambda *t: ops.ssd_scan(*t, chunk=L), args, weights)
    assert (ops.LAUNCHES, ops.BACKWARDS) == (launches + 1, backwards + 1)
    ref = _grads(lambda *t: ssd_scan_ref(*t, chunk=L), args, weights)
    tol = TOL[dtype][0]
    for name, a, b_ in zip(("x", "dt", "a", "B", "C"), got, ref):
        assert a.dtype == b_.dtype, name
        torch.testing.assert_close(a.float(), b_.float(), atol=tol, rtol=tol, msg=name)


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
        (4, 1024, 32, 32, 80, 0),  # zamba2-2.7b's shared block: MHA, D=80 across two 64-column TMA boxes
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


@pytest.mark.parametrize("b,s,h,kh,d", [(4, 1024, 16, 2, 128), (4, 1024, 32, 32, 80)],
                         ids=["qwen2.5-3b", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_kernel_forward_plain_backward(cuda, b, s, h, kh, d, dtype):
    """fa_ops.flash_attention on the card (kernel forward, plain backward) against
    autograd of the plain version; bars are the forward's own."""
    args = _fa_inputs(b, s, h, kh, d, 12, dtype, cuda)
    w = [torch.randn((b, s, h, d), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)]
    launches, backwards = fa_ops.LAUNCHES, fa_ops.BACKWARDS
    got = _grads(lambda *t: fa_ops.flash_attention(*t), args, w)
    assert (fa_ops.LAUNCHES, fa_ops.BACKWARDS) == (launches + 1, backwards + 1)
    ref = _grads(lambda *t: flash_attention_ref(*t), args, w)
    for name, a, b_ in zip("qkv", got, ref):
        torch.testing.assert_close(a.float(), b_.float(), atol=FA_TOL[dtype], rtol=FA_TOL[dtype], msg=name)


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


def test_bench_kernels_run_the_cuda_kernels(cuda):
    """``bench_kernels`` on the card runs each CUDA kernel at the reference's
    bench shape (one warm-up and ``REPS`` timed launches) and holds it to its
    plain version; each row says ``impl=cuda``."""
    from repro_torch.benchmarks import bench_kernels

    counters = (fa_ops, ops, merge_ops)
    for m in counters:
        m.LAUNCHES = 0
    rows = []
    bench_kernels.main(rows.append, device="cuda")
    assert [m.LAUNCHES for m in counters] == [1 + bench_kernels.REPS] * 3
    for row, check in zip(rows, ("kernel_err", "kernel_err", "kernel_exact")):
        fields = dict(p.split("=", 1) for p in row.split(",", 2)[2].split(";"))
        assert fields["impl"] == "cuda" and check in fields and float(fields["kernel_us"]) > 0, row


def test_kernel_functions_refuse_dtensors(cuda):
    """The kernels read raw device pointers: handed a DTensor (here on the card's
    (1, 1) mesh), each entry point raises instead of reading its pointer, and
    makes no launch."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()

    def dt(t):
        return DTensor.from_local(t, mesh, [Replicate(), Replicate()])

    x, dtt, a, bm, cm = _inputs(1, 64, 2, 16, 1, 16, 0, torch.bfloat16, cuda)
    q, k, v = _fa_inputs(1, 64, 2, 2, 32, 0, torch.bfloat16, cuda)
    launches = ops.LAUNCHES, fa_ops.LAUNCHES
    with pytest.raises(TypeError, match="DTensor"):
        ops.ssd_scan(dt(x), dt(dtt), dt(a), dt(bm), dt(cm), chunk=16)
    with pytest.raises(TypeError, match="DTensor"):
        fa_ops.flash_attention(dt(q), dt(k), dt(v))
    assert (ops.LAUNCHES, fa_ops.LAUNCHES) == launches


# ------------------------------------------------------------- decode attention
CHUNK = da_kernel.CHUNK


@pytest.mark.parametrize(
    "b,smax,h,kh,d,orig,stored,window,pos",
    [(32, 1088, 32, 32, 224, 0, 32, 0, pos) for pos in (0, CHUNK - 1, CHUNK, 1056, 1087)]  # a zamba2 site
    + [(32, 1088, 32, 32, 224, 0, 32, 100, 1056)]                                          # with a window
    + [(4, 300, 8, 2, 128, 0, 2, w, pos) for w in (0, 50) for pos in (0, CHUNK - 1, CHUNK, 299)]  # grouped
    + [(32, 1088, 32, 8, 128, 0, 8, 0, pos) for pos in (0, CHUNK, 1056, 1087)]  # a granite-4.0-h-small layer
    + [(32, 1088, 20, 4, 128, 0, 4, 0, pos) for pos in (0, CHUNK, 1056, 1087)]  # falcon-h1-34b-instruct: 5 a group
    + [
        (2, 200, 8, 3, 64, 6, 3, 0, 130),     # padded q heads, clamped to the last kv head
        (2, 150, 32, 2, 64, 0, 2, 0, 149),    # 16 q heads a kv head: two rounds over the rows
        (2, 130, 4, 4, 96, 0, 8, 7, 129),     # k and v a view of a wider cache, by strides
        (1, 70, 2, 1, 256, 0, 1, 0, 69),      # the widest head
        (1, 70, 2, 2, 8, 0, 2, 0, 5),         # the narrowest
    ],
)
def test_decode_attention_kernel_matches_plain(cuda, b, smax, h, kh, d, orig, stored, window, pos):
    """The kernel against its plain version over the same bfloat16 inputs, at zamba2's site
    shape (H = K = 32, D = 224, Smax 1088, its (D / 2)^-0.5 scale) and others, at ``pos`` on
    the chunk edges.  Rows outside ``max(0, pos - window + 1) .. pos`` are NaN when the kernel
    runs: it never loads them.

    The plain path rounds the scores to bfloat16 before the softmax and the probabilities
    after it; the kernel keeps both in float32 and rounds only its output.  So it lies within
    the reference kernel tests' bfloat16 bar (2e-2, abs and rel) of the plain path, and
    within twice bfloat16's unit roundoff (2^-7 rel) of the float32 plain version."""
    r = np.random.default_rng(b * smax + h + pos)
    q = torch.tensor(r.standard_normal((b, 1, h, d)), dtype=torch.float32, device=cuda).to(torch.bfloat16)
    k, v = (torch.tensor(r.standard_normal((b, smax, stored, d)), dtype=torch.float32, device=cuda)
            .to(torch.bfloat16)[:, :, :kh] for _ in range(2))
    kvm = kv_head_map(h, kh, orig).to(cuda)
    at = torch.tensor(pos, dtype=torch.int32, device=cuda)
    scale = (d / 2) ** -0.5
    ref = decode_attention_ref(q, k, v, kvm, at, scale=scale, window=window)
    ref32 = decode_attention_ref(q.float(), k.float(), v.float(), kvm, at, scale=scale, window=window)
    kpos = torch.arange(smax, device=cuda)
    outside = (kpos > pos) | ((kpos <= pos - window) if window else torch.zeros_like(kpos, dtype=torch.bool))
    k[:, outside], v[:, outside] = float("nan"), float("nan")
    before = da_ops.LAUNCHES
    out = da_ops.decode_attention(q, k, v, kvm, at, scale=scale, window=window)
    torch.cuda.synchronize()
    assert da_ops.LAUNCHES == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref32, atol=1e-5, rtol=2**-7)
    again = da_ops.decode_attention(q, k, v, kvm, at, scale=scale, window=window)
    assert torch.equal(again, out)  # no atomics: the same inputs give the same bits


def test_decode_attention_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16, device=cuda)
    kvm = torch.tensor([0, 0, 1, 1], device=cuda)
    at = torch.tensor(3, dtype=torch.int32, device=cuda)
    launches = da_ops.LAUNCHES
    cases = [
        (q.float(), k, k, kvm, at, "bfloat16"),                             # dtype
        (q, k[..., :60], k[..., :60], kvm, at, "shapes"),                   # D differs from q's
        (q[..., :60], k[..., :60].contiguous(), k[..., :60].contiguous(), kvm, at, "D % 8"),
        (q, k.transpose(2, 3).contiguous().transpose(2, 3), k, kvm, at, "contiguous"),  # D strided
        (q, k, k, kvm.int(), at, "int64"),                                 # the map's dtype
        (q, k, k, kvm, at.long(), "int32"),                                # pos's dtype
        (q, k, k, kvm, at.cpu(), "CUDA"),                                  # pos on the host
    ]
    for qq, kk, vv, m, p, match in cases:
        with pytest.raises(ValueError, match=match):
            da_ops.decode_attention(qq, kk, vv, m, p, scale=0.1)
    assert da_ops.LAUNCHES == launches


def test_replayed_zamba2_decode_launches_the_kernel_at_capture_only(cuda):
    """The tiny bfloat16 zamba2 served through replayed graphs: ``LAUNCHES`` rises by the
    sites once for each ``decode_step`` run while a graph is captured (its warm-up step and
    the captured one) and by nothing per replay, so each replayed step runs the kernel."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request

    cfg, _, make = _graph_engine(cuda, "bfloat16", "zamba2")
    eng = make()
    sites = len(cfg.hybrid_layer_ids)
    counts = []
    for _ in range(2):  # the first batch captures, the second (same shape) only replays
        before = (da_ops.LAUNCHES, dict(transformer.DECODE_GRAPHS))
        eng.run_batch([Request(i, torch.arange(8) * (i + 1) % cfg.vocab_size, max_new_tokens=5) for i in range(4)])
        counts.append((da_ops.LAUNCHES - before[0],
                       transformer.DECODE_GRAPHS["captures"] - before[1]["captures"],
                       transformer.DECODE_GRAPHS["replays"] - before[1]["replays"]))
    assert counts == [(2 * sites, 1, 4), (0, 0, 4)]


# ------------------------------------------------------------- ssm decode
def _sd_inputs(b, h, g, p, n, dtype, seed):
    """A layer's state, and x, B and C as the Mixer's decode slices them from its conv output
    (views of one wider (B, H P + 2 G N) row, by strides), dt after softplus, a as initialised."""
    r = np.random.default_rng(seed)
    state = torch.tensor(r.standard_normal((b, h, p, n)), dtype=torch.float32, device="cuda")
    row = torch.tensor(r.standard_normal((b, h * p + 2 * g * n)), dtype=torch.float32, device="cuda").to(dtype)
    x = row[:, :h * p].reshape(b, h, p)
    bvec = row[:, h * p:h * p + g * n].reshape(b, g, n)
    cvec = row[:, h * p + g * n:].reshape(b, g, n)
    dt = F.softplus(torch.tensor(r.standard_normal((b, h)), dtype=torch.float32, device="cuda"))
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device="cuda")))
    return state, x, dt, a, bvec, cvec


@pytest.mark.parametrize("into", ["other", "in-place"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,g,p,n", [
    (32, 48, 1, 64, 128),    # mamba2-780m.chat
    (32, 112, 2, 64, 64),    # zamba2-7b-instruct.chat
    (32, 128, 1, 64, 128),   # granite-4.0-h-small.chat
    (32, 32, 2, 128, 256),   # falcon-h1-34b-instruct.chat: two float4 a lane
    (3, 48, 1, 64, 128),     # a ragged batch
    (2, 8, 2, 24, 256),      # two float4 a lane, P not a multiple of the tile
    (4, 8, 1, 16, 16),       # the tiny models' rows
])
def test_ssm_decode_kernel_matches_plain(cuda, b, h, g, p, n, dtype, into):
    """The kernel's new state is the plain step's bit for bit, into another tensor or over the
    state itself; its y lies within 1e-5 x sum |new * C| of the exact sum (the kernel's stated
    tolerance: only the order of y's sums differs), as the plain einsum's does; the same inputs
    give the same bits again."""
    state, x, dt, a, bvec, cvec = _sd_inputs(b, h, g, p, n, dtype, seed=b * h + n)
    want, want_y = ssm_decode_ref(state, x, dt, a, bvec, cvec)
    before = sd_ops.LAUNCHES
    runs = []
    for _ in range(2):
        src = state.clone()
        out = src if into == "in-place" else torch.full_like(state, float("nan"))
        new, y = sd_ops.ssm_decode(src, x, dt, a, bvec, cvec, out=out)
        torch.cuda.synchronize()
        assert new is out and y.dtype == torch.float32 and y.shape == (b, h, p)
        runs.append((new, y))
    assert sd_ops.LAUNCHES == before + 2
    new, y = runs[0]
    assert torch.equal(new, want)
    cvec_h = cvec.repeat_interleave(h // g, dim=1).double()
    exact = torch.einsum("bhpn,bhn->bhp", want.double(), cvec_h)
    scale = torch.einsum("bhpn,bhn->bhp", want.double().abs(), cvec_h.abs())
    assert ((y.double() - exact).abs() <= 1e-5 * scale).all()
    assert ((want_y.double() - exact).abs() <= 1e-5 * scale).all()
    assert torch.equal(runs[1][0], new) and torch.equal(runs[1][1], y)  # no atomics


@pytest.mark.parametrize("b,h,g,p,n,ranks", [
    (32, 48, 1, 64, 128, 4),   # mamba2-780m's heads over a model axis of 4
    (32, 112, 2, 64, 64, 2),   # zamba2-7b-instruct's over 2: 56 heads a rank on both groups
    (4, 80, 1, 64, 64, 2),     # zamba2-2.7b's f32 decode twins
])
def test_ssm_decode_kernel_takes_a_ranks_heads(cuda, b, h, g, p, n, ranks):
    """A sharded decode hands the kernel its rank's heads (with all of B and C): the kernel's new
    state there is the plain step's bit for bit, and its y within the stated tolerance, on each
    rank's slice, in bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        state, x, dt, a, bvec, cvec = _sd_inputs(b, h, g, p, n, dtype, seed=h + n)
        hl = h // ranks
        for r in range(ranks):
            part = slice(r * hl, (r + 1) * hl)
            st, xl, dtl, al = state[:, part].contiguous(), x[:, part], dt[:, part].contiguous(), a[part].contiguous()
            want, _ = ssm_decode_ref(st, xl, dtl, al, bvec, cvec)
            new, y = sd_ops.ssm_decode(st, xl, dtl, al, bvec, cvec, out=torch.empty_like(st))
            assert torch.equal(new, want)
            cvec_h = cvec.repeat_interleave(hl // g, dim=1).double()
            exact = torch.einsum("bhpn,bhn->bhp", want.double(), cvec_h)
            scale = torch.einsum("bhpn,bhn->bhp", want.double().abs(), cvec_h.abs())
            assert ((y.double() - exact).abs() <= 1e-5 * scale).all()


def test_ssm_decode_kernel_rejects_what_it_cannot_take(cuda):
    """What the kernel cannot take raises, from the kernel's launcher and from the dispatcher the
    model calls alike: a CUDA call never falls back to the plain step."""
    state, x, dt, a, bvec, cvec = _sd_inputs(2, 4, 2, 8, 16, torch.bfloat16, seed=0)
    from repro_torch.kernels.ssm_decode import kernel as sd_kernel

    cases = [
        (state, x.half(), dt, a, bvec.half(), cvec.half(), state, "float32 or bfloat16"),  # x's dtype
        (state, x, dt, a, bvec.float(), cvec, state, "share"),                            # B's differs
        (state.double(), x, dt, a, bvec, cvec, state.double(), "float32"),                # the state's
        (state[..., :12].contiguous(), x, dt, a, bvec[..., :12], cvec[..., :12],
         state[..., :12].contiguous(), "N in"),                                           # N = 12
        (state, x, dt, a, bvec, cvec, state.transpose(2, 3).contiguous().transpose(2, 3), "contiguous"),
        (state, x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bvec, cvec, state, "last axis"),
        (state, x, dt.cpu(), a, bvec, cvec, state, "CUDA"),                               # dt on the host
        (state, x, dt, a, bvec[:, :1].expand(2, 3, 16), cvec[:, :1].expand(2, 3, 16), state, "H % G"),
        (state, x[:1], dt, a, bvec, cvec, state, "do not agree"),                         # B differs
        (state, x, dt, a[:2], bvec, cvec, state, "do not agree"),                         # a's heads
    ]
    launches = sd_ops.LAUNCHES
    for st, xx, d, aa, bb, cc, out, match in cases:
        with pytest.raises(ValueError, match=match):
            sd_kernel.ssm_decode_cuda(st, xx, d, aa, bb, cc, out)
        with pytest.raises(ValueError, match=match):
            sd_ops.ssm_decode(st, xx, d, aa, bb, cc, out=out)
    assert sd_ops.LAUNCHES == launches


@pytest.mark.parametrize("arch,compute_dtype", [("mamba2-780m", "bfloat16"), ("zamba2", "bfloat16"),
                                                ("granite", "bfloat16"), ("falcon_h1", "bfloat16")])
def test_replayed_decode_launches_the_ssm_kernel_at_capture_only(cuda, arch, compute_dtype):
    """A model served through replayed graphs: ``ssm_decode``'s ``LAUNCHES`` rises by the Mamba2
    layers once for each ``decode_step`` run while a graph is captured (its warm-up step and the
    captured one) and by nothing per replay, so each replayed step runs the kernel."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request

    cfg, _, make = _graph_engine(cuda, compute_dtype, arch)
    eng = make()
    rows = transformer.ssm_rows(cfg)
    counts = []
    for _ in range(2):  # the first batch captures, the second (same shape) only replays
        before = (sd_ops.LAUNCHES, dict(transformer.DECODE_GRAPHS))
        eng.run_batch([Request(i, torch.arange(8) * (i + 1) % cfg.vocab_size, max_new_tokens=5) for i in range(4)])
        counts.append((sd_ops.LAUNCHES - before[0],
                       transformer.DECODE_GRAPHS["captures"] - before[1]["captures"],
                       transformer.DECODE_GRAPHS["replays"] - before[1]["replays"]))
    assert counts == [(2 * rows, 1, 4), (0, 0, 4)]


# ------------------------------------------------------------- decode graphs
def _graph_engine(cuda, compute_dtype="float32", arch="mamba2-780m"):
    """A reduced model on the card (the registry's ``arch``, or with ``"zamba2"``, ``"granite"`` or
    ``"falcon_h1"`` the tiny model of ``test_torch_<arch>.py``, its params in ``compute_dtype`` too) and a
    maker of engines over it."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer
    from repro_torch.models.config import ArchConfig
    from repro_torch.serve.engine import ServeEngine

    if arch in ("zamba2", "granite", "falcon_h1"):
        tiny = __import__(f"test_torch_{arch}")
        cfg = ArchConfig(**dict(tiny.ARCH, param_dtype=compute_dtype, compute_dtype=compute_dtype))
    else:
        cfg = dataclasses.replace(ARCHS[arch].reduced(), compute_dtype=compute_dtype)
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    return cfg, params, lambda: ServeEngine(cfg, params, max_len=64, batch_size=4)


@pytest.mark.parametrize("arch,compute_dtype", [("mamba2-780m", "float32"), ("mamba2-780m", "bfloat16"),
                                                ("zamba2", "bfloat16"), ("granite", "bfloat16"),
                                                ("falcon_h1", "bfloat16")],
                         ids=["float32", "bfloat16", "zamba2-bfloat16", "granite-bfloat16", "falcon_h1-bfloat16"])
def test_served_by_replayed_graphs_is_the_eager_decode_bit_for_bit(cuda, arch, compute_dtype):
    """Three batches (two of 4 requests with other prompts, then one of 2) through an engine
    whose decode replays captured graphs: each step's logits and cache, and so every served
    token, are those of an eager ``prefill`` + ``decode_step`` loop, bit for bit; no state
    carries from one batch into the next through the static cache.  Each shape captures
    one graph (the capture itself refuses a step that reads back to the host), and each
    decode call replays it.  The eager step syncs with the host nowhere: zamba2's keeps
    ``pos`` on the card and writes each site's K/V row there."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request

    cfg, params, make = _graph_engine(cuda, compute_dtype, arch)
    eng = make()
    assert eng._graphs is not None
    seen, real = [], eng._decode

    def spy(p, cache, tok):
        logits, new = real(p, cache, tok)
        seen.append((logits.clone(), [t.clone() for t in transformer._leaves(new)]))
        return logits, new

    eng._decode = spy
    before = dict(transformer.DECODE_GRAPHS)
    g = torch.Generator().manual_seed(5)
    new_tokens = 6
    for b, s in [(4, 16), (4, 24), (2, 8)]:
        prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
        seen.clear()
        served = eng.run_batch([Request(i, prompts[i], max_new_tokens=new_tokens) for i in range(b)])
        logits, cache = transformer.prefill(cfg, params, {"tokens": prompts.to(cuda)}, 64)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        want = [tok[:, 0].tolist()]
        assert len(seen) == new_tokens - 1
        for got_logits, got_cache in seen:
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = transformer.decode_step(cfg, params, cache, tok)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.equal(got_logits, logits)
            assert all(torch.equal(x, y) for x, y in zip(got_cache, transformer._leaves(cache)))
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            want.append(tok[:, 0].tolist())
        assert [r.output for r in served] == [list(t) for t in zip(*want)]
    assert transformer.DECODE_GRAPHS["captures"] - before["captures"] == 2  # batches of 4, then of 2
    assert transformer.DECODE_GRAPHS["replays"] - before["replays"] == 3 * (new_tokens - 1)


def test_batches_of_changing_size_hold_one_graph(cuda):
    """An engine that serves batches of several sizes captures a graph for each change of size
    and holds only the latest: what it keeps on the card never grows past what the largest
    batch left behind."""
    import gc

    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request

    cfg, _, make = _graph_engine(cuda)
    eng = make()
    before = dict(transformer.DECODE_GRAPHS)
    sizes, held = [4, 2, 3, 1, 4, 4], []
    for b in sizes:
        eng.run_batch([Request(i, torch.arange(8) * (i + 1) % cfg.vocab_size, max_new_tokens=4) for i in range(b)])
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert transformer.DECODE_GRAPHS["captures"] - before["captures"] == len(sizes) - 1
    assert max(held) == held[0], held


def test_deleting_the_engine_releases_its_graphs(cuda):
    """The static cache, the graph and its pool belong to the engine: once it is gone the
    card holds what it held before the engine's first batch."""
    import gc

    from repro_torch.serve.engine import Request

    cfg, _, make = _graph_engine(cuda)

    def reqs():
        return [Request(i, torch.arange(8) * (i + 1) % cfg.vocab_size, max_new_tokens=4) for i in range(4)]

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    make().run_batch(reqs())  # the process keeps what it makes once (streams' cuBLAS workspaces)
    base = settle()
    eng = make()
    eng.run_batch(reqs())
    assert torch.cuda.memory_allocated() > base[0]
    del eng
    allocated, reserved = settle()
    assert allocated == base[0] and reserved <= base[1]


# ------------------------------------------------------------------- zamba2
def test_zamba2_site_at_published_widths_matches_reference(cuda):
    """One site of the published Zamba2-7B-Instruct at its widths (2 Mamba2 layers, the site at
    layer 1, the whole vocabulary) in bf16 on the card: prefill over a ragged second chunk, then
    4 decode steps through the cache, against the float32 reference over the same weights.

    bf16 rounds each product's operands to 8 bits (2^-9 relative); through two layers and a
    site the logits, whose spread is ~1.2 (a unit-norm state against the 0.02-scale tied
    embedding), move by a few hundredths.  A wrong site, group, scale or rotation moves them by
    tenths: the bars are 0.15 at the worst logit and 0.03 on average."""
    import json
    from pathlib import Path

    from bench.harness import program
    from bench.reference import zamba2_lm as ref
    from repro_torch.models import get_model

    conf = json.loads((Path(__file__).resolve().parents[1] / "bench" / "configs" / "zamba2-7b-instruct.json").read_text())
    arch = dict(conf["arch"], num_layers=2, hybrid_layer_ids=[1], num_mem_blocks=1)
    cfg = program.arch_config(arch)
    model = program.build(cfg, ref, arch, 11, cuda)
    toks = torch.randint(0, arch["vocab_size"], (2, 300 + 4), generator=torch.Generator().manual_seed(3)).to(cuda)
    m = get_model(cfg)
    logits, cache = m.prefill(cfg, model, {"tokens": toks[:, :300]}, max_len=320)
    got = [logits[:, 0]]
    for t in range(300, 303):
        logits, cache = m.decode_step(cfg, model, cache, toks[:, t:t + 1])
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1).float()
    del model, cache
    torch.cuda.empty_cache()
    w = program.reference_weights(ref, arch, 11, cuda)
    want = ref.next_token_logits(arch, w, toks[:, :303], 299)
    diff = (got - want).abs()
    print(f"zamba2 site bf16 vs f32: max {float(diff.max()):.5f} mean {float(diff.mean()):.6f} "
          f"logit std {float(want.std()):.4f}")
    assert float(diff.max()) <= 0.15 and float(diff.mean()) <= 0.03


# ------------------------------------------------------------------ granite
def test_granite_at_published_widths_serves_a_batch_under_80_gb(cuda):
    """granite-4.0-h-small as the benchmark builds it (bf16, 40 layers, 9 of 72 experts, the whole
    vocabulary) serves one batch of the ``chat`` mix's longest prompts through ``ServeEngine``: 32 x 1024
    tokens, decode replayed as a captured graph.  The card's peak stays under 80 GB, with room for the
    graph's static cache beside the prefill's; each request gets its tokens, in the vocabulary."""
    import gc
    import json
    from pathlib import Path

    from bench.harness import program
    from bench.reference import granite_moe_hybrid_lm as ref
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    conf = json.loads((Path(__file__).resolve().parents[1] / "bench" / "configs" / "granite-4.0-h-small.json").read_text())
    arch = conf["arch"]
    cfg = program.arch_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = program.build(cfg, ref, arch, 5, cuda)
    eng = ServeEngine(cfg, params, max_len=1088, batch_size=32)
    before = dict(transformer.DECODE_GRAPHS)
    g = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (32, 1024), generator=g)
    out = eng.run_batch([Request(i, prompts[i], max_new_tokens=4) for i in range(32)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"granite-4.0-h-small 32 x 1024, 4 new tokens: peak {peak} B")
    assert all(len(r.output) == 4 and all(0 <= t < cfg.vocab_size for t in r.output) for r in out)
    assert transformer.DECODE_GRAPHS["captures"] - before["captures"] == 1
    assert transformer.DECODE_GRAPHS["replays"] - before["replays"] == 3
    assert peak < 80e9
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- falcon_h1
def test_falcon_h1_at_published_widths_serves_a_batch_under_80_gb(cuda):
    """falcon-h1-34b-instruct as the benchmark builds it (bf16, stage 0's 18 layers, each holding K/V
    and an f32 state of 32 x 128 x 256 a sequence, the untied head over the whole vocabulary) serves one
    batch of the ``chat`` mix's longest prompts through ``ServeEngine``: 32 x 1024 tokens, decode
    replayed as a captured graph through the decode-attention and decode-state kernels.  The card's peak
    stays under 80 GB; each request gets its tokens, in the vocabulary."""
    import gc
    import json
    from pathlib import Path

    from bench.harness import program
    from bench.reference import falcon_h1_lm as ref
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    conf = json.loads((Path(__file__).resolve().parents[1] / "bench" / "configs" / "falcon-h1-34b-instruct.json").read_text())
    arch = conf["arch"]
    cfg = program.arch_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = program.build(cfg, ref, arch, 5, cuda)
    eng = ServeEngine(cfg, params, max_len=1088, batch_size=32)
    before = (dict(transformer.DECODE_GRAPHS), da_ops.LAUNCHES, sd_ops.LAUNCHES, ops.LAUNCHES)
    prompts = torch.randint(0, cfg.vocab_size, (32, 1024), generator=torch.Generator().manual_seed(7))
    out = eng.run_batch([Request(i, prompts[i], max_new_tokens=4) for i in range(32)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"falcon-h1-34b-instruct 32 x 1024, 4 new tokens: peak {peak} B")
    assert all(len(r.output) == 4 and all(0 <= t < cfg.vocab_size for t in r.output) for r in out)
    assert transformer.DECODE_GRAPHS["captures"] - before[0]["captures"] == 1
    assert transformer.DECODE_GRAPHS["replays"] - before[0]["replays"] == 3
    # each of the 18 layers: one scan in prefill; one attention and one state update a step, counted at capture
    assert (da_ops.LAUNCHES - before[1], sd_ops.LAUNCHES - before[2], ops.LAUNCHES - before[3]) == (36, 36, 18)
    assert peak < 80e9
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
