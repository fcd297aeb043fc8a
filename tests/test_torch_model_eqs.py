"""The port's I/O-amplification model (``repro_torch.core.model``) against the
reference's: Eq. 4 bit for bit in float32, the vectorized classifier exactly,
the closed forms equal."""
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro_torch.core import model as M

LEVELS_F = [(2, 4), (3, 4), (3, 8), (4, 8), (5, 10)]  # tests/test_model_eqs.py's pairs


def _p_grid() -> np.ndarray:
    rng = np.random.default_rng(0)
    paper = [0.0, 0.01, 0.012, 0.02, 0.094, 0.1, 0.2, 0.33, 0.5, 1.0]
    return np.concatenate([paper, np.linspace(0.0, 1.0, 1001), rng.random(2000)]).astype(np.float32)


@pytest.mark.parametrize("levels,f", LEVELS_F)
def test_separation_benefit_bit_identical(levels, f):
    p = _p_grid()
    ref = np.asarray(JM.separation_benefit(levels, f, p))
    got = M.separation_benefit(levels, f, torch.from_numpy(p))
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    # scalars and numpy arrays on an explicit device give the same bits
    assert np.array_equal(M.separation_benefit(levels, f, p, device="cpu").numpy(), ref)
    for x in (0.012, 0.33):
        assert float(M.separation_benefit(levels, f, x, device="cpu")) == float(JM.separation_benefit(levels, f, x))


def _sizes(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 64, n), rng.integers(0, 5000, n)


def _boundary_sizes(pol) -> tuple[np.ndarray, np.ndarray]:
    """Sizes whose float32 p lies exactly on T_SM or T_ML, or next to them."""
    ks, vs = [], []
    for k in range(1, 40):
        for v in range(0, 2000):
            p = np.float32(min(k, pol.prefix_size)) / np.float32(k + v)
            for t in (pol.t_sm, pol.t_ml):
                if abs(float(p) - t) <= 2e-3:
                    ks.append(k)
                    vs.append(v)
    return np.array(ks), np.array(vs)


@pytest.mark.parametrize(
    "pol", [M.SizePolicy(), M.SizePolicy(t_sm=0.1, t_ml=0.05, prefix_size=8)], ids=["paper", "shifted"]
)
def test_p_of_and_classify_exact(pol):
    jpol = JM.SizePolicy(t_sm=pol.t_sm, t_ml=pol.t_ml, prefix_size=pol.prefix_size)
    bk, bv = _boundary_sizes(pol)
    on_threshold = np.float32(np.minimum(bk, pol.prefix_size)) / np.float32(bk + bv)
    assert (on_threshold == np.float32(pol.t_sm)).any() and (on_threshold == np.float32(pol.t_ml)).any()
    rk, rv = _sizes(5000, 1)
    for ks, vs in ((bk, bv), (rk, rv)):
        p_ref = np.asarray(jpol.p_of(ks, vs))
        p = pol.p_of(torch.from_numpy(ks), torch.from_numpy(vs))
        assert p.dtype == torch.float32 and np.array_equal(p.numpy(), p_ref)
        c_ref = np.asarray(jpol.classify(ks, vs))
        c = pol.classify(torch.from_numpy(ks), torch.from_numpy(vs))
        assert c.dtype == torch.int32 and np.array_equal(c.numpy(), c_ref)
        assert np.array_equal(pol.classify(ks, vs, device="cpu").numpy(), c_ref)


def test_classify_scalar_and_closed_forms_equal():
    pol, jpol = M.SizePolicy(), JM.SizePolicy()
    assert pol == M.SizePolicy(**vars(jpol))
    ks, vs = _sizes(2000, 2)
    assert [pol.classify_scalar(int(k), int(v)) for k, v in zip(ks, vs)] == [
        jpol.classify_scalar(int(k), int(v)) for k, v in zip(ks, vs)
    ]
    assert (M.T_SM, M.T_ML) == (JM.T_SM, JM.T_ML)
    for levels, f in LEVELS_F:
        assert M.amplification_inplace_sum(levels, f, 1024.0) == JM.amplification_inplace_sum(levels, f, 1024.0)
        assert M.amplification_inplace(levels, f, 3.0) == JM.amplification_inplace(levels, f, 3.0)
        for p in (0.01, 0.2, 0.5):
            assert M.amplification_separated(levels, f, p, 2.0) == JM.amplification_separated(levels, f, p, 2.0)
        for i in range(levels):
            assert M.capacity_ratio(levels + 1, f, i) == JM.capacity_ratio(levels + 1, f, i)
        ps = [0.012, 0.094, 0.33]
        assert np.array_equal(M.expected_benefit_table(levels, f, ps), JM.expected_benefit_table(levels, f, ps))
    for data, l0, f in ((100 * 2**30, 2**27, 8), (2**27, 2**27, 8), (5e6, 1 << 14, 4)):
        assert M.levels_for_dataset(data, l0, f) == JM.levels_for_dataset(data, l0, f)


def test_numpy_input_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.separation_benefit(4, 8, np.array([0.1, 0.2]))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.SizePolicy().classify(np.array([24]), np.array([104]))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.SizePolicy().p_of(24, 104)
    # a tensor keeps its device; the store's scalar path needs no tensor at all
    assert M.SizePolicy().classify(torch.tensor([24]), torch.tensor([104])).tolist() == [1]
    assert M.SizePolicy().classify_scalar(24, 1004) == 2
