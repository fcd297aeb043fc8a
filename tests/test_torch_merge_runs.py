"""The port's compaction merge (``repro_torch.kernels.merge_runs``) on the CPU
against the reference: the Pallas kernel in interpret mode, its oracle and its
``merge_sorted_runs``.  The bar is the reference's own: keys exactly equal and
equal sorted (key, payload) multisets, since the kernel leaves the order of
payloads among equal keys open."""
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


def _network(ak, bk, av, bv):
    """The CUDA kernel's arithmetic in numpy (``csrc/merge_runs.cu``): B loaded
    reversed to position 2T-1-c, then the stages from stride T down to 1 with
    the kernel's pair-to-position formula and its strict swap rule."""
    g, t = ak.shape
    n = 2 * t
    sk = np.empty((g, n), ak.dtype)
    sv = np.empty((g, n), av.dtype)
    c = np.arange(t)
    sk[:, c], sv[:, c] = ak, av
    sk[:, n - 1 - c], sv[:, n - 1 - c] = bk, bv
    stride = t
    while stride >= 1:
        lo = ((c & ~(stride - 1)) << 1) + (c & (stride - 1))
        hi = lo + stride
        kl, kh, vl, vh = sk[:, lo], sk[:, hi], sv[:, lo], sv[:, hi]
        swap = kl > kh
        sk[:, lo], sk[:, hi] = np.where(swap, kh, kl), np.where(swap, kl, kh)
        sv[:, lo], sv[:, hi] = np.where(swap, vh, vl), np.where(swap, vl, vh)
        stride //= 2
    return sk, sv


@pytest.mark.parametrize("g,t", [(3, 1), (5, 2), (13, 8), (7, 64), (2, 1024)])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_kernel_network_matches_ref(g, t, dtype):
    """The kernel's indexing, rehearsed on the CPU: T = 1, G not a multiple of 8,
    uint32 keys, and few distinct keys so that runs share values."""
    ak, bk, av, bv = _runs(g, t, dtype, seed=g + t)
    if dtype == np.int32:
        rng = np.random.default_rng(t)
        ak, bk = (np.sort(rng.integers(0, 4, (g, t)).astype(np.int32), axis=1) for _ in range(2))
    nk, nv = _network(ak, bk, av, bv)
    rk, rv = merge_runs_ref(*(torch.from_numpy(x) for x in (ak, bk, av, bv)))
    np.testing.assert_array_equal(nk, rk.numpy())
    assert _pairs(nk, nv) == _pairs(rk.numpy(), rv.numpy())


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
