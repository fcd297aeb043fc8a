"""The port's compaction merge (``repro_torch.kernels.merge_runs``) on the CPU
against the reference: the Pallas kernel in interpret mode, its oracle and its
``merge_sorted_runs``.  Against the Pallas kernel the bar is the reference's
own: keys exactly equal and equal sorted (key, payload) multisets, since that
kernel leaves the order of payloads among equal keys open.  The port's kernel
is a stable merge path; its numpy model is held to the plain version in place,
keys and payloads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.merge_runs import ops as jops
from repro.kernels.merge_runs.kernel import merge_runs_pallas
from repro.kernels.merge_runs.ref import merge_runs_ref as jax_merge_runs_ref
from repro_torch.kernels.merge_runs import ops
from repro_torch.kernels.merge_runs.ref import merge_runs_ref

SWEEP = [(8, 64), (16, 128), (8, 256), (32, 32), (1, 512)]  # tests/test_kernels.py's shapes


def _runs(g, t, key_dtype, seed, val_dtype=np.int32):
    rng = np.random.default_rng(seed)
    if key_dtype == np.float32:
        ak, bk = (np.sort(rng.standard_normal((g, t)).astype(np.float32), axis=1) for _ in range(2))
    elif key_dtype == np.uint32:  # the top bit set on about half the keys
        ak, bk = (np.sort(rng.integers(0, 1 << 32, (g, t), dtype=np.uint64).astype(np.uint32), axis=1)
                  for _ in range(2))
    else:
        ak, bk = (np.sort(rng.integers(0, 1 << 30, (g, t)).astype(key_dtype), axis=1) for _ in range(2))
    if val_dtype == np.float32:
        av, bv = (rng.standard_normal((g, t)).astype(np.float32) for _ in range(2))
    else:
        av, bv = (rng.integers(0, 1 << 30, (g, t)).astype(val_dtype) for _ in range(2))
    return ak, bk, av, bv


def _pairs(keys, vals):
    return sorted(zip(np.asarray(keys).ravel().tolist(), np.asarray(vals).ravel().tolist()))


def _check_against_reference(ak, bk, av, bv, *, pallas: bool = True):
    """Port ref and merge_tiles (CPU) against the reference's oracle and kernel."""
    tk, tv = merge_runs_ref(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    mk, mv = ops.merge_tiles(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    rk, rv = jax_merge_runs_ref(*(jnp.asarray(x) for x in (ak, bk, av, bv)))
    rk, rv = np.asarray(rk), np.asarray(rv)
    for k, v in ((tk, tv), (mk, mv)):
        assert k.dtype == torch.from_numpy(ak).dtype and v.dtype == torch.from_numpy(av).dtype
        assert k.shape == (ak.shape[0], 2 * ak.shape[1])
        np.testing.assert_array_equal(k.numpy(), rk)
        # both oracles are stable sorts of the same concatenation: payloads agree in place
        np.testing.assert_array_equal(v.numpy(), rv)
    if pallas:
        ok, ov = merge_runs_pallas(*(jnp.asarray(x) for x in (ak, bk, av, bv)), interpret=True)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(ok))
        assert _pairs(tk.numpy(), tv.numpy()) == _pairs(ok, ov)


@pytest.mark.parametrize("g,t", SWEEP)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_merge_matches_reference_sweep(g, t, dtype):
    _check_against_reference(*_runs(g, t, dtype, seed=g * t))


def test_merge_uint32_keys():
    _check_against_reference(*_runs(8, 128, np.uint32, seed=3))


def test_merge_float32_payloads():
    _check_against_reference(*_runs(8, 64, np.int32, seed=4, val_dtype=np.float32))


def test_merge_with_duplicates():
    ak = np.array([[1, 1, 2, 2, 3, 3, 4, 4]], np.int32)
    bk = np.array([[1, 2, 2, 3, 3, 3, 5, 9]], np.int32)
    av = np.arange(8, dtype=np.int32)[None]
    bv = (np.arange(8, dtype=np.int32) + 100)[None]
    _check_against_reference(ak, bk, av, bv)
    mk, _ = ops.merge_tiles(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    assert np.array_equal(mk.numpy()[0], np.sort(np.concatenate([ak[0], bk[0]])))


# csrc/merge_runs.cu's constants: outputs a thread merges, threads a block, staging words
KE, THREADS = 8, 256
WORDS = KE * THREADS + 16


def _split(a, a0, na, b, b0, nb, d):
    """The kernel's ``split``: the first i in [max(0, d - nb), min(d, na)) with
    not a[a0 + i] <= b[b0 + d - 1 - i] (ties go to A), else min(d, na)."""
    lo, hi = max(0, d - nb), min(d, na)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[a0 + mid] <= b[b0 + d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _warp_split(a, b, t, d):
    """The kernel's ``warp_split``: the same split, lane l of 32 probing
    lo + (hi - lo) l / 32 each step."""
    lo, hi = max(0, d - t), min(d, t)
    while lo < hi:
        n = hi - lo
        c = sum(bool(a[i] <= b[d - 1 - i]) for i in (lo + ((n * lane) >> 5) for lane in range(32)))
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + ((n * (c - 1)) >> 5) + 1, (lo + ((n * c) >> 5) if c < 32 else hi)
    return lo


def _clamp(splits, diags, na, nb, width):
    """The kernel's clamp of a unit's splits, in order: each step takes 0..width
    keys of A and the rest of B.  Splits of ascending runs come out as they
    went in."""
    out, prev = [], 0
    for s, d in zip(splits, diags):
        prev = 0 if d == 0 else min(max(s, max(prev, d - nb)), min(prev + width, na))
        out.append(prev)
    return out


def _merge_path(ak, bk, av, bv, vec=None):
    """The kernel's index arithmetic in numpy (``csrc/merge_runs.cu``): blocks
    of 256 threads, e = min(8, 2T) outputs a thread; whole rows a block when
    2T fits its span, else one span of a row between two of the row's clamped
    block splits (``_warp_split``); staging into arrays of the kernel's size,
    rounded out to 4 words on the 16-byte path (``vec``, taken when T >= 4 and
    the pointers are aligned), so that a read outside them raises; each
    thread's two searches, the clamp where a range is unsound, and the
    bounded sequential merge."""
    g, t = ak.shape
    n = 2 * t
    vec = 2 * t >= KE if vec is None else vec
    e = min(KE, n)
    span = THREADS * e
    q = 4 if vec else 1
    ok, ov = np.zeros((g, n), ak.dtype), np.zeros((g, n), av.dtype)
    blocks = -(-g // (span // n)) if n <= span else g * (n // span)
    for blk in range(blocks):
        sk, sv = np.zeros(WORDS, ak.dtype), np.zeros(WORDS, av.dtype)
        if n <= span:
            rows_per_block = span // n
            row0 = blk * rows_per_block
            live = min(rows_per_block, g - row0)
            half = span // 2
            sk[:live * t], sk[half:half + live * t] = ak[row0:row0 + live].ravel(), bk[row0:row0 + live].ravel()
            sv[:live * t], sv[half:half + live * t] = av[row0:row0 + live].ravel(), bv[row0:row0 + live].ravel()
            na = nb = t
            unit = n
            units = [(r * t, half + r * t, row0 + r, 0) for r in range(live)]
        else:
            per_row = n // span
            row, part = divmod(blk, per_row)
            diags = [k * span for k in range(1, per_row + 1)]
            splits = _clamp([_warp_split(ak[row], bk[row], t, dk) for dk in diags[:-1]] + [t], diags, t, t, span)
            i0, i1 = ([0] + splits)[part], splits[part]
            j0, j1 = part * span - i0, (part + 1) * span - i1
            a_lo, b_lo = i0 & ~(q - 1), j0 & ~(q - 1)
            a_words, b_words = ((i1 + q - 1) & ~(q - 1)) - a_lo, ((j1 + q - 1) & ~(q - 1)) - b_lo
            sk[:a_words], sk[a_words:a_words + b_words] = ak[row, a_lo:a_lo + a_words], bk[row, b_lo:b_lo + b_words]
            sv[:a_words], sv[a_words:a_words + b_words] = av[row, a_lo:a_lo + a_words], bv[row, b_lo:b_lo + b_words]
            na, nb = i1 - i0, span - (i1 - i0)
            unit = span
            units = [(i0 - a_lo, a_words + j0 - b_lo, row, part * span)]
        for a0, b0, row, col in units:
            diags = list(range(0, unit, e))
            starts = [_split(sk, a0, na, sk, b0, nb, d) for d in diags]
            ends = [_split(sk, a0, na, sk, b0, nb, d + e) for d in diags]
            if any(s1 < s0 or s1 - s0 > e for s0, s1 in zip(starts, ends)):
                starts = _clamp(starts, diags, na, nb, e)
                ends = starts[1:] + [na]
            for d, s0, s1 in zip(diags, starts, ends):
                i, j, j1 = s0, d - s0, d + e - s1
                x, y = sk[a0 + i], sk[b0 + j]
                for k in range(col + d, col + d + e):
                    if j >= j1 or (i < s1 and x <= y):
                        ok[row, k], ov[row, k] = x, sv[a0 + i]
                        i += 1
                        x = sk[a0 + i]
                    else:
                        ok[row, k], ov[row, k] = y, sv[b0 + j]
                        j += 1
                        y = sk[b0 + j]
    return ok, ov


# keys drawn from 4 values: the sign bit, the top bit and -0.0 against +0.0 among them
FEW = {np.int32: [-(1 << 31), -1, 0, (1 << 31) - 1], np.uint32: [0, 1, 1 << 31, (1 << 32) - 1],
       np.float32: [-1.5, -0.0, 0.0, 2.5]}


def _patterned(g, t, dtype, pattern, seed):
    """Two ascending (g, t) key tiles and int32 payloads: ``random`` keys,
    ``few`` (4 values), or ``disjoint`` runs, A below B in even rows and B below
    A in odd ones."""
    ak, bk, av, bv = _runs(g, t, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    if pattern == "few":
        ak, bk = (np.sort(np.array(FEW[dtype], dtype)[rng.integers(0, 4, (g, t))], axis=1, kind="stable")
                  for _ in range(2))
    elif pattern == "disjoint":
        both = np.sort(np.concatenate([ak, bk], axis=1), axis=1)
        lo, hi = both[:, :t], both[:, t:]
        odd = (np.arange(g) % 2 == 1)[:, None]
        ak, bk = np.where(odd, hi, lo), np.where(odd, lo, hi)
    return ak, bk, av, bv


def _check_model(ak, bk, av, bv, vec=None):
    """The model against the plain version in place, keys and payloads, as words."""
    mk, mv = _merge_path(ak, bk, av, bv, vec)
    rk, rv = merge_runs_ref(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    np.testing.assert_array_equal(mk.view(np.int32), rk.numpy().view(np.int32))
    np.testing.assert_array_equal(mv.view(np.int32), rv.numpy().view(np.int32))


@pytest.mark.parametrize("pattern", ["random", "few", "disjoint"])
@pytest.mark.parametrize("g,t", [(3, 1), (5, 2), (13, 8), (7, 64), (2, 1024)])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_kernel_merge_path_matches_ref(g, t, dtype, pattern):
    """The kernel's tiling, search and merge, rehearsed on the CPU: T = 1 and 2
    (the 4-byte path), G not a multiple of a block's rows, and ties."""
    _check_model(*_patterned(g, t, dtype, pattern, seed=g + t))


@pytest.mark.parametrize("pattern", ["random", "few", "disjoint"])
@pytest.mark.parametrize("vec", [True, False])
def test_kernel_merge_path_splits_long_rows(pattern, vec):
    """T > 1024: a row spans several blocks, each staging the ranges between
    its two splits, rounded out to 16 bytes on the vector path and not on the
    4-byte one (misaligned inputs)."""
    for (g, t), dtype in zip([(2, 2048), (1, 8192)], [np.uint32, np.float32]):
        _check_model(*_patterned(g, t, dtype, pattern, seed=t), vec=vec)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_every_diagonal_splits_as_the_stable_merge(dtype):
    """At every diagonal d of a T = 64 row, both searches take as many of A's
    keys as the first d outputs of the stable merge hold."""
    for pattern in ("random", "few", "disjoint"):
        for row, (a, b) in enumerate(zip(*_patterned(2, 64, dtype, pattern, seed=9)[:2])):
            order = np.argsort(np.concatenate([a, b]), kind="stable")
            for d in range(129):
                want = int((order[:d] < 64).sum())
                assert _split(a, 0, 64, b, 0, 64, d) == want, (pattern, row, d)
                assert _warp_split(a, b, 64, d) == want, (pattern, row, d)


@pytest.mark.parametrize("t", [64, 4096])
@pytest.mark.parametrize("vec", [True, False])
def test_kernel_merge_path_keeps_nan_rows_multisets(t, vec):
    """NaN keys are outside the contract, as on the card
    (``test_torch_gpu.py::test_merge_kernel_nan_keys_are_outside_the_contract``):
    NaNs inside A and B, or a run that descends, make the searches' splits
    cross, and the clamps still move every (key, payload) pair of such a row
    exactly once; a row without a NaN merges as ever."""
    ak, bk, av, bv = _runs(5, t, np.float32, seed=5)
    ak[1, 10] = np.nan
    bk[2, t - 1] = np.nan
    ak[3, t // 5], bk[3, t // 3] = np.nan, np.nan
    ak[4] = ak[4, ::-1]  # descending: the row's block splits cross too
    mk, mv = _merge_path(ak, bk, av, bv, vec)
    rk, rv = merge_runs_ref(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    np.testing.assert_array_equal(mk[0].view(np.int32), rk.numpy()[0].view(np.int32))
    np.testing.assert_array_equal(mv[0], rv.numpy()[0])
    for r in range(5):
        got = _pairs(mk[r].view(np.int32), mv[r])
        assert got == _pairs(np.concatenate([ak[r], bk[r]]).view(np.int32), np.concatenate([av[r], bv[r]]))


def _check_merge_sorted_runs(a, b):
    mk, mv = ops.merge_sorted_runs(torch.from_numpy(a), torch.from_numpy(b))
    rk, rv = jops.merge_sorted_runs(jnp.asarray(a), jnp.asarray(b))
    assert mk.dtype == torch.from_numpy(a).dtype and mv.dtype == torch.int32
    np.testing.assert_array_equal(mk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(mk.numpy(), np.sort(np.concatenate([a, b]), kind="stable"))
    assert int((mv.numpy() == 0).sum()) == len(a)


def test_merge_sorted_runs_full():
    rng = np.random.default_rng(7)
    a = np.sort(rng.integers(0, 1 << 28, 3000).astype(np.int32))
    b = np.sort(rng.integers(0, 1 << 28, 1234).astype(np.int32))
    _check_merge_sorted_runs(a, b)


def test_merge_sorted_runs_uint32():
    rng = np.random.default_rng(8)
    a = np.sort(rng.integers(0, 1 << 32, 700, dtype=np.uint64).astype(np.uint32))
    b = np.sort(rng.integers(0, 1 << 32, 900, dtype=np.uint64).astype(np.uint32))
    _check_merge_sorted_runs(a, b)


def test_merge_sorted_runs_equal_keys_put_a_first():
    a = np.array([1, 2, 2, 5, 7, 7, 7], np.int32)
    b = np.array([2, 2, 3, 7, 7, 9], np.int32)
    _check_merge_sorted_runs(a, b)
    _, flags = ops.merge_sorted_runs(torch.from_numpy(a), torch.from_numpy(b))
    assert flags.tolist() == [0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1]


@pytest.mark.parametrize("na,nb", [(0, 5), (6, 0), (0, 0)])
def test_merge_sorted_runs_empty(na, nb):
    a = np.arange(na, dtype=np.int32) * 3
    b = np.arange(nb, dtype=np.int32) * 2
    _check_merge_sorted_runs(a, b)


def test_merge_tiles_dispatch():
    ak, bk, av, bv = (torch.from_numpy(x) for x in _runs(2, 8, np.int32, seed=5))
    before = ops.LAUNCHES
    ops.merge_tiles(ak, bk, av, bv, block_rows=3)  # any block_rows >= 1: no result changes
    assert ops.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        ops.merge_tiles(ak, bk, av, bv, impl="cuda")  # the kernel, forced, refuses a CPU tensor
    with pytest.raises(ValueError, match="impl"):
        ops.merge_tiles(ak, bk, av, bv, impl="pallas")
    with pytest.raises(ValueError, match="block_rows"):
        ops.merge_tiles(ak, bk, av, bv, block_rows=0)


def test_ref_sorts_nan_last_like_the_reference():
    """NaN keys are outside the kernel's contract (ROADMAP section 3): the plain
    version, like the reference's oracle, sorts them last."""
    ak = np.array([[0.5, 1.0, np.nan, np.nan]], np.float32)
    bk = np.array([[-1.0, 0.5, 2.0, np.nan]], np.float32)
    av, bv = np.arange(4, dtype=np.int32)[None], np.arange(4, 8, dtype=np.int32)[None]
    tk, tv = merge_runs_ref(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    rk, rv = jax_merge_runs_ref(*(jnp.asarray(x) for x in (ak, bk, av, bv)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))  # NaN == NaN here
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert np.isnan(tk.numpy()[0, -3:]).all()
