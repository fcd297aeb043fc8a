"""The port's optimizer and gradient compression, on the CPU: the reference's
unit tests (``tests/test_optim_compress.py``) ported, then ``adamw.update``,
``lr_at`` and ``compress_grads`` against the reference on the same arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.train import compress as jax_compress
from repro_torch.optim import adamw
from repro_torch.train.compress import (
    compress_grads,
    dequantize_int8,
    init_error_state,
    quantize_int8,
    wire_savings,
)

TOL = 1e-6  # float32 elementwise arithmetic in both packages


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0, grad_clip=0)
    params = {"x": torch.tensor([5.0, -3.0], requires_grad=True)}
    opt = adamw.init(params)
    for _ in range(150):
        loss = (params["x"] ** 2).sum()
        (g,) = torch.autograd.grad(loss, [params["x"]])
        adamw.update(cfg, {"x": g}, opt, params)
    assert float(params["x"].detach().abs().max()) < 0.1


def test_lr_schedule_warmup_and_cosine():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(adamw.lr_at(cfg, torch.tensor(0))) == 0.0
    assert float(adamw.lr_at(cfg, torch.tensor(10))) == 1.0
    end = float(adamw.lr_at(cfg, torch.tensor(100)))
    assert abs(end - 0.1) < 1e-5
    mid = float(adamw.lr_at(cfg, torch.tensor(55)))
    assert 0.1 < mid < 1.0


def test_grad_clip_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=0, grad_clip=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    opt = adamw.init(params)
    huge = {"x": torch.full((4,), 1e6)}
    metrics = adamw.update(cfg, huge, opt, params)
    assert float(metrics["grad_norm"]) > 1e5
    assert torch.isfinite(params["x"]).all()
    assert float(params["x"].abs().max()) < 10.0


def test_int8_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_preserves_signal():
    """With error feedback, the *sum* of compressed grads tracks the true sum."""
    g = {"w": torch.full((64,), 0.003)}  # small grads that int8 rounds to ~0 alone
    e = init_error_state(g)
    total = torch.zeros(64)
    for _ in range(50):
        out, e = compress_grads(g, method="int8", error_state=e)
        total = total + out["w"]
    expect = 0.003 * 50
    np.testing.assert_allclose(total.numpy(), expect, rtol=0.05)


def test_topk_keeps_largest():
    g = {"w": torch.arange(100, dtype=torch.float32)}
    out = compress_grads(g, method="topk", topk_frac=0.05)
    w = out["w"].numpy()
    assert (w != 0).sum() == 5
    assert w[-5:].all()


# ------------------------------------------------------ against the reference
def _tree(seed, shapes=(("a", (4, 6)), ("b", (17,)), ("c", (3, 5, 2)))):
    r = np.random.default_rng(seed)
    return {k: (r.standard_normal(s) * 10.0 ** r.uniform(-3, 1)).astype(np.float32) for k, s in shapes}


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 150, 10_000, 20_000])
def test_lr_at_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=10_000, min_lr_ratio=0.1)
    got = adamw.lr_at(adamw.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    ref = jax_adamw.lr_at(jax_adamw.AdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=TOL, atol=0)


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-2, warmup_steps=0, grad_clip=1.0),
    dict(lr=1e-2, warmup_steps=3, grad_clip=0.0, weight_decay=0.0),
    dict(lr=1e-3, warmup_steps=2, grad_clip=100.0),
])
def test_adamw_update_matches_reference_over_steps(cfg):
    """Five updates from the same params and grads: params, mu, nu, step and metrics."""
    params = _tree(0)
    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ref = {k: jnp.asarray(v) for k, v in params.items()}
    opt, jopt = adamw.init(port), jax_adamw.init(ref)
    for i in range(5):
        grads = _tree(10 + i)
        metrics = adamw.update(adamw.AdamWConfig(**cfg), {k: torch.from_numpy(v) for k, v in grads.items()}, opt, port)
        ref, jopt, jmetrics = jax_adamw.update(jax_adamw.AdamWConfig(**cfg), {k: jnp.asarray(v) for k, v in grads.items()}, jopt, ref)
        assert int(opt["step"]) == int(jopt["step"]) == i + 1 and opt["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=TOL)
        for k in params:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), rtol=TOL, atol=TOL * cfg["lr"])
            np.testing.assert_allclose(opt["mu"][k].numpy(), np.asarray(jopt["mu"][k]), rtol=TOL, atol=1e-9)
            np.testing.assert_allclose(opt["nu"][k].numpy(), np.asarray(jopt["nu"][k]), rtol=TOL, atol=1e-12)


def test_global_norm_matches_reference():
    tree = {"x": _tree(1), "y": {"z": np.full((3,), 2.0, np.float32)}}
    got = adamw.global_norm(jax.tree.map(torch.from_numpy, tree))
    np.testing.assert_allclose(float(got), float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=TOL)


@pytest.mark.parametrize("method,frac", [("int8", 0.01), ("topk", 0.01), ("topk", 0.25)])
def test_compress_grads_matches_reference(method, frac):
    grads = _tree(2)
    grads["ties"] = np.array([3.0, -3.0, 3.0, 1.0, -2.0, 0.5, 3.0, 0.0], np.float32)  # top-k keeps every tie
    got = compress_grads({k: torch.from_numpy(v) for k, v in grads.items()}, method=method, topk_frac=frac)
    ref = jax_compress.compress_grads({k: jnp.asarray(v) for k, v in grads.items()}, method=method, topk_frac=frac)
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_compress_grads_with_error_state_matches_reference():
    grads, errs = _tree(3), _tree(4)
    got, got_e = compress_grads({k: torch.from_numpy(v) for k, v in grads.items()}, method="int8",
                                error_state={k: torch.from_numpy(v) for k, v in errs.items()})
    ref, ref_e = jax_compress.compress_grads({k: jnp.asarray(v) for k, v in grads.items()}, method="int8",
                                             error_state={k: jnp.asarray(v) for k, v in errs.items()})
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        np.testing.assert_allclose(got_e[k].numpy(), np.asarray(ref_e[k]), rtol=TOL, atol=TOL, err_msg=k)


def test_quantize_rounds_half_to_even_as_the_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5], np.float32)  # scale = 1 (+1e-12)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_init_error_state_and_wire_savings():
    shapes = {"a": torch.empty((2, 3), device="meta"), "b": {"c": torch.zeros(4)}}
    e = init_error_state(shapes, device="cpu")
    assert e["a"].shape == (2, 3) and e["a"].device.type == "cpu" and e["b"]["c"].dtype == torch.float32
    assert not e["a"].any() and not e["b"]["c"].any()
    for method in ("int8", "topk", "none"):
        assert wire_savings(method) == jax_compress.wire_savings(method)
