"""The port's training step against the JAX package's, on the CPU.

One ``make_train_fn`` step from the same params (the reference's perturbed
PRNGKey(0) tree, ``tests/torch_parity.py``) and the same ``host_batch``: the
loss, lr and grad norm, every param and every AdamW moment after the step.
AdamW's first step moves each param by about lr times the sign of its
gradient, so the params are held to 1e-3 of lr: a wrong gradient moves an
element by 2 lr.  Then the reference's system tests of training, ported:
the loss falls over 30 steps, and a run restored from a checkpoint equals
the uninterrupted one bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.train.step import make_train_fn as jax_make_train_fn
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.convert import _port_leaves
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.train.step import make_decode_fn, make_prefill_fn, make_train_fn
from torch_parity import build

OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=50)
PARAM_TOL = 1e-3 * OCFG["lr"]  # of the step's size, lr
MOMENT_TOL = 1e-4
GRAD_TOL = 1e-4  # of each leaf's largest |gradient|
# bf16 gradients are rounded at other places in the two packages: one bf16
# unit roundoff of the leaf's largest (1.2e-3 of it measured on qwen2.5-3b)
GRAD_TOL_BF16 = 2**-8
TOL = 1e-4


def _batches(cfg, seq_len=24, global_batch=2, step=0):
    hb = host_batch(cfg, DataConfig(seq_len=seq_len, global_batch=global_batch, seed=0), step)
    return {k: torch.from_numpy(v) for k, v in hb.items()}, {k: jnp.asarray(v) for k, v in hb.items()}


def _step_both(monkeypatch, name, **kw):
    """One step of each package from the same params and batch.  Returns, per
    package, (params, opt state, metrics, the grads that AdamW was given)."""
    seen = {}

    def spy(key, update):
        def run(cfg, grads, state, params):
            seen[key] = grads
            return update(cfg, grads, state, params)
        return run

    monkeypatch.setattr(adamw, "update", spy("port", adamw.update))
    monkeypatch.setattr(jax_adamw, "update", spy("ref", jax_adamw.update))
    cfg, params, jcfg, jparams = build(name)
    batch, jbatch = _batches(cfg)
    opt = adamw.init(params)
    params, opt, metrics = make_train_fn(cfg, adamw.AdamWConfig(**OCFG), **kw)(params, opt, batch)
    jstep = jax.jit(lambda p, o, b: (*jax_make_train_fn(jcfg, jax_adamw.AdamWConfig(**OCFG), **kw)(p, o, b), seen["ref"]))
    jparams, jopt, jmetrics, jgrads = jstep(jparams, jax_adamw.init(jparams), jbatch)
    return (params, opt, metrics, seen["port"]), (jparams, jopt, jmetrics, jgrads)


def _check_step(port, ref, grad_tol=GRAD_TOL):
    """Loss, lr, grad norm, the grads AdamW saw, the params and moments after the step.

    Where the clipped gradient lies within 100 eps of zero, AdamW's first step
    lr g / (|g| + eps) turns a difference of float noise in g into a visible
    one (up to 2 lr where the sign differs), so a param there may miss
    PARAM_TOL; every such element must have the reference's clipped gradient
    below 100 eps, and the gradients themselves are held at ``grad_tol`` of
    each leaf's largest.
    """
    (params, opt, metrics, grads), (jparams, jopt, jmetrics, jgrads) = port, ref
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(jmetrics["lr"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]), rtol=TOL)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1 == int(jopt["step"])
    ocfg = adamw.AdamWConfig(**OCFG)
    clip = min(1.0, ocfg.grad_clip / (float(jmetrics["grad_norm"]) + 1e-9))
    jg = _port_leaves(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads))
    ref = _port_leaves(jax.tree.map(np.asarray, jparams))
    port = dict(params.named_parameters())
    assert sorted(ref) == sorted(port) == sorted(jg) == sorted(grads)
    noisy = []
    for name, p in port.items():
        g = grads[name].to(torch.float32).numpy()
        np.testing.assert_allclose(g, jg[name], atol=grad_tol * np.abs(jg[name]).max(), rtol=TOL,
                                   err_msg=f"grad {name}")
        miss = np.abs(p.detach().numpy() - ref[name]) > PARAM_TOL
        noisy += [(name, i, float(jg[name][i] * clip)) for i in zip(*np.nonzero(miss))]
    assert all(abs(g) < 100 * ocfg.eps for _, _, g in noisy), [x for x in noisy if abs(x[2]) >= 100 * ocfg.eps]
    assert len(noisy) <= 1e-3 * sum(p.numel() for p in port.values()), noisy
    for moment in ("mu", "nu"):
        ref = _port_leaves(jax.tree.map(np.asarray, jopt[moment]))
        assert sorted(ref) == sorted(opt[moment])
        for name, t in opt[moment].items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), ref[name], atol=MOMENT_TOL, rtol=0, err_msg=f"{moment} {name}")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_matches_reference(monkeypatch, name):
    _check_step(*_step_both(monkeypatch, name))


@pytest.mark.parametrize("kw", [
    {"grad_dtype": "bfloat16"},
    {"accum_steps": 2},
    {"compress": "int8"},
    {"compress": "topk"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_train_step_branches_match_reference(monkeypatch, kw):
    grad_tol = GRAD_TOL_BF16 if kw.get("grad_dtype") == "bfloat16" else GRAD_TOL
    _check_step(*_step_both(monkeypatch, "qwen2.5-3b", **kw), grad_tol=grad_tol)


def test_train_step_updates_in_place_and_returns_the_same_objects():
    cfg, params, _, _ = build("mamba2-780m")
    opt = adamw.init(params)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    out_params, out_opt, metrics = make_train_fn(cfg, adamw.AdamWConfig(**OCFG))(params, opt, _batches(cfg)[0])
    assert out_params is params and out_opt is opt
    assert sorted(metrics) == ["grad_norm", "loss", "lr"] and all(v.shape == () for v in metrics.values())
    assert all(not torch.equal(before[n], p) for n, p in params.named_parameters() if p.numel() > 1)


def test_training_reduces_loss():
    cfg = ARCHS["qwen2.5-3b"].reduced()
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step_fn = make_train_fn(cfg, ocfg)
    m = get_model(cfg)
    params = m.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw.init(params)
    dcfg = DataConfig(seq_len=32, global_batch=4, seed=0)
    losses = []
    for step in range(30):
        batch = {k: torch.from_numpy(v) for k, v in host_batch(cfg, dcfg, step % 4).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_checkpoint_restart_resumes_identically(tmp_path):
    """Crash at step 10, restore, re-run: params must match the uninterrupted run bitwise."""
    cfg = ARCHS["mamba2-780m"].reduced()
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50)
    step_fn = make_train_fn(cfg, ocfg)
    m = get_model(cfg)
    dcfg = DataConfig(seq_len=16, global_batch=2, seed=1)

    def fresh():
        return m.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")

    def run(upto, params, opt, start=0):
        for step in range(start, upto):
            batch = {k: torch.from_numpy(v) for k, v in host_batch(cfg, dcfg, step).items()}
            params, opt, _ = step_fn(params, opt, batch)
        return params, opt

    ref_params, _ = run(15, *(lambda p: (p, adamw.init(p)))(fresh()))
    p, o = run(10, *(lambda p: (p, adamw.init(p)))(fresh()))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, {"params": dict(p.named_parameters()), "opt": o})
    del p, o  # crash
    model = fresh()
    like = {"params": dict(model.named_parameters()), "opt": adamw.init(model)}
    restored, step = mgr.restore(like)
    assert step == 10
    model.load_state_dict(restored["params"])
    p2, _ = run(15, model, restored["opt"], start=10)
    for (name, a), b in zip(ref_params.named_parameters(), p2.parameters()):
        assert torch.equal(a, b), name


def test_prefill_and_decode_fns():
    """make_prefill_fn and make_decode_fn wrap the model's prefill and decode_step,
    the decode fn returning the greedy next token as int32 (B, 1)."""
    cfg, params, _, _ = build("mamba2-780m")
    m = get_model(cfg)
    batch, _ = _batches(cfg, seq_len=20)
    logits, cache = make_prefill_fn(cfg, 32)(params, {"tokens": batch["tokens"]})
    ref_logits, _ = m.prefill(cfg, params, {"tokens": batch["tokens"]}, 32)
    assert torch.equal(logits, ref_logits)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    nxt, new_cache = make_decode_fn(cfg)(params, cache, tok)
    dec_logits, _ = m.decode_step(cfg, params, cache, tok)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], torch.argmax(dec_logits[:, -1], dim=-1).to(torch.int32))
    assert int(new_cache["pos"]) == 21
