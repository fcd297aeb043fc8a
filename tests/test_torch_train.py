"""The port's training step against the JAX package's, on the CPU.

One ``make_train_fn`` step from the same params (the reference's perturbed
PRNGKey(0) tree, ``tests/torch_parity.py``) and the same ``host_batch``: the
loss, lr and grad norm, every param and every AdamW moment after the step.
AdamW's first step moves each param by about lr times the sign of its
gradient, so the params are held to 1e-3 of lr: a wrong gradient moves an
element by 2 lr.  Then the reference's system tests of training, ported:
the loss falls over 30 steps, and a run restored from a checkpoint equals
the uninterrupted one bitwise.  With ``remat`` on, every family's step is
bitwise its ``remat=False`` step and matches the reference's ``jax.checkpoint``
step; the abstract trees equal the reference's ``eval_shape`` trees; and
``make_train_step`` on 4 gloo ranks ((2, 2) mesh) equals ``make_train_fn``'s
whole-batch step, each rank keeping only its shards (under ``baseline`` the
ssm, dense and hybrid steps are tensor parallel over the model axis;
``tests/test_torch_tp.py`` holds that path in detail).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.optim import adamw as jax_adamw
from repro.train import step as jax_step
from repro.train.step import make_train_fn as jax_make_train_fn
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.convert import STACKED, _port_leaves
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import (abstract_cache, abstract_opt_state, abstract_params, make_decode_fn,
                                    make_prefill_fn, make_train_fn)
from torch_parity import build, run_ranks

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


def _step_both(monkeypatch, name, changes=None, **kw):
    """One step of each package from the same params and batch, ``changes`` made to
    both configs.  Returns, per package, (params, opt state, metrics, the grads
    that AdamW was given)."""
    seen = {}

    def spy(key, update):
        def run(cfg, grads, state, params):
            seen[key] = grads
            return update(cfg, grads, state, params)
        return run

    monkeypatch.setattr(adamw, "update", spy("port", adamw.update))
    monkeypatch.setattr(jax_adamw, "update", spy("ref", jax_adamw.update))
    cfg, params, jcfg, jparams = build(name, **(changes or {}))
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


# ------------------------------------------------------------------- remat
@pytest.mark.parametrize("name,kw", [(n, {}) for n in sorted(ARCHS)] + [("qwen2.5-3b", {"grad_dtype": "bfloat16"})],
                         ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()) or "f32")
def test_remat_step_is_bitwise_the_plain_step_and_matches_reference(monkeypatch, name, kw):
    """remat=True (which reduced() turns off) recomputes each layer in the backward:
    the loss, the gradients AdamW sees and the updated params are bitwise those of
    remat=False, and the step matches the reference's jax.checkpoint step."""
    port, ref = _step_both(monkeypatch, name, {"remat": True}, **kw)
    _check_step(port, ref, grad_tol=GRAD_TOL_BF16 if kw else GRAD_TOL)
    plain, _ = _step_both(monkeypatch, name, {"remat": False}, **kw)
    (params, _, metrics, grads), (pparams, _, pmetrics, pgrads) = port, plain
    assert all(torch.equal(metrics[k], pmetrics[k]) for k in metrics)
    assert all(torch.equal(grads[n], pgrads[n]) for n in grads)
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), pparams.parameters()))


# -------------------------------------------------------- the abstract trees
def _ref_shapes(tree) -> dict[str, tuple]:
    """Each leaf of a reference tree of ShapeDtypeStructs as (shape, dtype name), by path."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_shapes(tree, stacked: bool) -> dict[str, tuple]:
    """The same of a port tree; with ``stacked``, per-layer leaves stacked as the reference's."""
    def flat(t, prefix=""):
        if isinstance(t, dict):
            return {p: v for k, x in t.items() for p, v in flat(x, f"{prefix}{k}/").items()}
        return {prefix[:-1]: (tuple(t.shape), str(t.dtype).removeprefix("torch."))}

    leaves = flat(tree)
    if not stacked:
        return leaves
    layers: dict[str, list[tuple]] = {}
    out: dict[str, tuple] = {}
    for name, leaf in leaves.items():
        stack, _, rest = name.partition(".")
        i, _, rest = rest.partition(".")
        if stack in STACKED and i.isdigit():
            layers.setdefault(f"{stack}/{rest.replace('.', '/')}", []).append(leaf)
        else:
            out[name.replace(".", "/")] = leaf
    for key, per_layer in layers.items():
        assert len(set(per_layer)) == 1, key
        (shape, dtype), = set(per_layer)
        out[key] = ((len(per_layer), *shape), dtype)
    return out


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_trees_equal_reference_eval_shape(name):
    """abstract_params, abstract_opt_state and abstract_cache on the meta device:
    every leaf's shape and dtype equal the reference's eval_shape trees, at full size."""
    cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
    shell = abstract_params(cfg)
    assert all(p.is_meta for p in shell.parameters())
    jshape = jax_step.abstract_params(jcfg)
    assert _port_shapes(dict(shell.named_parameters()), stacked=True) == _ref_shapes(jshape)
    opt, jopt = abstract_opt_state(shell), jax_step.abstract_opt_state(jshape)
    assert opt["step"].is_meta and _ref_shapes(jopt["step"]) == {"": ((), "int32")}
    for m in ("mu", "nu"):
        assert _port_shapes(opt[m], stacked=True) == _ref_shapes(jopt[m])
    cache = abstract_cache(cfg, 2, 64)
    assert all(t.is_meta for t in jax.tree.leaves(cache))
    assert _port_shapes(cache, stacked=False) == _ref_shapes(jax_step.abstract_cache(jcfg, 2, 64))


# ---------------------------------------------------- the sharded train step
SHARDED_CASES = [(n, layout) for n in ("mamba2-780m", "qwen2.5-3b", "zamba2-2.7b")
                 for layout in ("baseline", "pure-dp")]
SHARDED = f"""
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_step

mesh = make_host_mesh(model=2, device="cpu")
result = {{}}
for name, layout in {SHARDED_CASES!r}:
    cfg = rules.pad_config_for_mesh(ARCHS[name].reduced(), mesh, layout)
    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    hb = host_batch(cfg, DataConfig(seq_len=24, global_batch=4, seed=0), 0)
    step, _, pspecs, _, ospecs = make_train_step(cfg, mesh, adamw.AdamWConfig(**{OCFG!r}), layout=layout)
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    opt = rules.distribute(adamw.init(model), ospecs)
    out_params, out_opt, metrics = step(params, opt, {{k: torch.from_numpy(v) for k, v in hb.items()}})
    assert out_params is params and out_opt is opt
    result[(name, layout)] = {{
        "coordinate": mesh.get_coordinate(),
        "specs": {{n: s.spec for n, s in pspecs.items()}},
        "local": {{n: (tuple(p.to_local().shape), [str(pl) for pl in p.placements]) for n, p in params.items()}},
        "local_state": {{m: {{n: tuple(t.to_local().shape) for n, t in opt[m].items()}} for m in ("mu", "nu")}},
        "step": (tuple(opt["step"].to_local().shape), int(opt["step"].to_local())),
        "params": {{n: p.full_tensor() for n, p in params.items()}},
        "mu": {{n: t.full_tensor() for n, t in opt["mu"].items()}},
        "nu": {{n: t.full_tensor() for n, t in opt["nu"].items()}},
        "metrics": {{k: v.item() for k, v in metrics.items()}},
    }}
"""


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """One make_train_step of each case on a 4-rank gloo (2, 2) mesh; each rank's result."""
    return run_ranks(SHARDED, 4, tmp_path_factory.mktemp("sharded"))


@pytest.mark.parametrize("name,layout", SHARDED_CASES)
def test_sharded_train_step_matches_whole_batch_step(sharded_steps, name, layout):
    """make_train_step on a (2, 2) mesh against make_train_fn's step on the whole
    batch: the loss, lr and grad norm, every param and AdamW moment, at this file's
    bars; every rank reports the same metrics and the same gathered tree.  Under
    ``baseline`` each rank computes with its model-axis shards (tensor parallel)."""
    got = [r[(name, layout)] for r in sharded_steps]
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    cfg = rules.pad_config_for_mesh(ARCHS[name].reduced(), mesh, layout)
    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw.init(model)
    ocfg = adamw.AdamWConfig(**OCFG)
    _, _, metrics = make_train_fn(cfg, ocfg)(model, opt, _batches(cfg, global_batch=4)[0])
    for r in got:
        assert r["metrics"] == got[0]["metrics"] and r["step"] == ((), 1)
        for key in ("params", "mu", "nu"):
            assert all(torch.equal(t, got[0][key][n]) for n, t in r[key].items())
    r = got[0]
    for k, v in metrics.items():
        np.testing.assert_allclose(r["metrics"][k], float(v), rtol=TOL, atol=TOL, err_msg=k)
    clip = min(1.0, ocfg.grad_clip / (float(metrics["grad_norm"]) + 1e-9))
    noisy = []
    for n, p in model.named_parameters():
        g = (opt["mu"][n] / (1 - ocfg.b1)).numpy()  # the whole batch's clipped gradient
        miss = np.abs(r["params"][n].numpy() - p.detach().numpy()) > PARAM_TOL
        noisy += [(n, float(x)) for x in g[miss]]
        for m in ("mu", "nu"):
            np.testing.assert_allclose(r[m][n].numpy(), opt[m][n].numpy(), atol=MOMENT_TOL, rtol=0, err_msg=f"{m} {n}")
    assert all(abs(x) < 100 * ocfg.eps for _, x in noisy), [x for x in noisy if abs(x[1]) >= 100 * ocfg.eps]
    assert len(noisy) <= 1e-3 * sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name,layout", SHARDED_CASES)
def test_sharded_train_step_keeps_only_each_ranks_shards(sharded_steps, name, layout):
    """Between steps each rank holds, of each param and AdamW moment, the shard its
    placements give: each dim divided by the mesh dims that split it."""
    sizes = {"data": 2, "model": 2}
    split_somewhere = False
    for r in sharded_steps:
        got = r[(name, layout)]
        for n, spec in got["specs"].items():
            full = tuple(got["params"][n].shape)
            parts = [1] * len(full)
            for d, entry in enumerate(spec):
                for axis in entry if isinstance(entry, tuple) else (entry,) if entry else ():
                    parts[d] *= sizes[axis]
            want = tuple(f // k for f, k in zip(full, parts))
            assert got["local"][n][0] == want, (n, spec, got["local"][n])
            assert got["local_state"]["mu"][n] == got["local_state"]["nu"][n] == want
            split_somewhere |= want != full
    assert split_somewhere == (layout == "baseline")
