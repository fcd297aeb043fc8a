"""The port's spans (``repro_torch.obs.span``) on the CPU.

With no profiler recording a span is one shared no-op that formats nothing.
Under a ``torch.profiler`` session the serving engine, the model step and the
train step record their fixed span names, nested as ``PERF.md`` section 3
lists them, and the results are the same with and without the profiler.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.step import make_train_fn

NEW_TOKENS = 4


def _profiled(fn):
    """(fn's result, the spans it recorded: (start, end, name) by start) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = prof.profiler.kineto_results.events()
    names = {e.name() for e in events if e.name().split(".")[0] in ("serve", "model", "train")}
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events if e.name() in names)
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[2] == name]


def _inside(spans, outer):
    return [s for s in spans if outer[0] <= s[0] and s[1] <= outer[1] and s is not outer]


def _engine(name):
    cfg = ARCHS[name].reduced()
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu")


def _requests(cfg):
    return [Request(i, (torch.arange(8, dtype=torch.int32) * (i + 1) + 3) % cfg.vocab_size,
                    max_new_tokens=NEW_TOKENS) for i in range(2)]


# --------------------------------------------------------------- the helper
def test_a_span_with_no_profiler_is_one_shared_noop(monkeypatch):
    def never():
        raise AssertionError("args formatted with no profiler recording")

    def no_range(*a, **k):
        raise AssertionError("record_function built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert obs.span("a") is obs.span("b") is obs.span("c", never) is obs.span("d", ("layer", 3))
    with obs.span("a", never):
        with obs.span("a", never):
            pass


def test_a_span_under_a_profiler_is_a_range_with_its_args_formatted(monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, args=None: made.append((name, args)) or real(name, args))
    calls = []
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("x.a", ("layer", 3, "row", 1)):
            with obs.span("x.b", lambda: calls.append(1) or "batch=2"):
                with obs.span("x.c"):
                    pass
    assert made == [("x.a", "layer=3 row=1"), ("x.b", "batch=2"), ("x.c", None)] and calls == [1]
    assert not torch._C._autograd._profiler_enabled() and obs.span("x.a") is obs.span("x.b")


# -------------------------------------------------------------- serving
def test_a_served_batch_records_its_spans_nested():
    cfg, eng = _engine("mamba2-780m")
    _, spans = _profiled(lambda: eng.run_batch(_requests(cfg)))
    (batch,) = _named(spans, "serve.run_batch")
    assert len(_inside(spans, batch)) == len(spans) - 1
    assert len(_named(spans, "serve.admit")) == len(_named(spans, "serve.release")) == 1
    assert len(_named(spans, "model.prefill")) == 1
    steps = _named(spans, "model.decode_step")
    assert len(steps) == NEW_TOKENS - 1
    assert len(_named(spans, "serve.read_tokens")) == len(_named(spans, "serve.bookkeeping")) == NEW_TOKENS
    for step in steps:
        inner = _inside(spans, step)
        assert [len(_named(inner, n)) for n in ("model.embed", "model.mamba2", "model.new_cache", "model.head")] \
            == [1, cfg.num_layers, 1, 1]
        assert not _named(inner, "model.attention") and not _named(inner, "serve.read_tokens")
    (prefill,) = _named(spans, "model.prefill")
    assert len(_named(_inside(spans, prefill), "model.mamba2")) == cfg.num_layers


def test_a_hybrid_decode_step_records_attention_at_its_sites():
    cfg, eng = _engine("zamba2-2.7b")
    _, spans = _profiled(lambda: eng.run_batch(_requests(cfg)))
    sites = cfg.num_layers // cfg.attn_every
    assert sites >= 2
    for step in _named(spans, "model.decode_step"):
        inner = _inside(spans, step)
        assert len(_named(inner, "model.mamba2")) == cfg.num_layers
        assert len(_named(inner, "model.attention")) == sites
        assert len(_named(inner, "model.new_cache")) == 2  # the K/V copy, the state stack
        for a in _named(inner, "model.attention"):
            assert not any(m[0] <= a[0] and a[1] <= m[1] for m in _named(inner, "model.mamba2"))
    (prefill,) = _named(spans, "model.prefill")
    attn = _named(_inside(spans, prefill), "model.attention")
    assert len(attn) == sites and all(len(_named(_inside(spans, a), "model.new_cache")) == 1 for a in attn)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_family_records_its_model_step(name):
    cfg, eng = _engine(name)
    _, spans = _profiled(lambda: eng.run_batch(_requests(cfg)))
    assert len(_named(spans, "model.prefill")) == 1
    steps = _named(spans, "model.decode_step")
    assert len(steps) == NEW_TOKENS - 1
    assert all(len(_named(_inside(spans, s), "model.head")) == 1 for s in steps)


def test_served_tokens_are_the_same_under_a_profiler():
    cfg, eng = _engine("zamba2-2.7b")
    plain = [r.output for r in eng.run_batch(_requests(cfg))]
    traced, _ = _profiled(lambda: eng.run_batch(_requests(cfg)))
    assert plain == [r.output for r in traced]


# -------------------------------------------------------------- training
def _train(kw, steps=2, remat=False):
    cfg = dataclasses.replace(ARCHS["mamba2-780m"].reduced(), remat=remat)
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw.init(params)
    step_fn = make_train_fn(cfg, adamw.AdamWConfig(warmup_steps=1, total_steps=10), **kw)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    losses = []
    for _ in range(steps):
        _, _, metrics = step_fn(params, opt, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
        losses.append(float(metrics["loss"]))
    return losses, params


BRANCHES = [{}, {"accum_steps": 2}, {"grad_dtype": "bfloat16"}, {"compress": "int8"}]


@pytest.mark.parametrize("kw", BRANCHES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_a_train_step_records_its_spans_nested(kw):
    _, spans = _profiled(lambda: _train(kw, steps=1))
    (step,) = _named(spans, "train.step")
    inner = _inside(spans, step)
    assert len(_named(inner, "train.loss_and_grad")) == 1 and len(_named(inner, "train.optimizer")) == 1
    assert len(_named(inner, "train.compress")) == (kw.get("compress", "none") != "none")
    (lg,) = _named(inner, "train.loss_and_grad")
    (opt,) = _named(inner, "train.optimizer")
    assert lg[1] <= opt[0]
    layers = ARCHS["mamba2-780m"].reduced().num_layers
    assert len(_named(_inside(spans, lg), "model.mamba2")) == layers * kw.get("accum_steps", 1)


def test_the_recomputed_forward_shows_inside_the_backward():
    _, spans = _profiled(lambda: _train({}, steps=1, remat=True))
    (lg,) = _named(spans, "train.loss_and_grad")
    layers = ARCHS["mamba2-780m"].reduced().num_layers
    assert len(_named(_inside(spans, lg), "model.mamba2")) == 2 * layers  # forward, then each layer's recompute


@pytest.mark.parametrize("kw", [{}, {"grad_dtype": "bfloat16"}], ids=["plain", "grad_dtype=bfloat16"])
def test_a_train_step_is_the_same_under_a_profiler(kw):
    losses, params = _train(kw)
    (t_losses, t_params), _ = _profiled(lambda: _train(kw))
    assert losses == t_losses
    for (n, p), (_, q) in zip(params.named_parameters(), t_params.named_parameters()):
        assert torch.equal(p, q), n
