"""The port's falcon_h1 family (Falcon-H1) against the benchmark's plain reference, and the reference
against the published code, on the CPU.

A tiny falcon_h1 config: hidden 64, 3 layers, each with RoPE GQA attention (4 q heads and 2 kv heads
of 16) beside a Mamba2 Mixer whose inner width is its own (64: 4 heads of 16, not 2 x 64), 2 B/C
groups, state 16, chunk 16, then a SwiGLU MLP of 128; the published multipliers (embedding 5.657,
the Mixer's input 0.25 and [z, x, B, C, dt] [0.354, 0.25, 0.177, 0.5, 0.354], its output 0.0884,
attention's 1 and 0.0375, the MLP's 0.177 and 0.0112, the key 0.01105, the head's 1/128), RoPE at
the published theta 1e11, vocab 256, an untied head.  Weights come from
``bench/reference/falcon_h1_lm.py``'s specs, made from a seed as the benchmark makes them; every leaf
that the specs set to all zeros or all ones (norm scales, conv biases, dt_bias, D) is moved off that
value with seeded noise, so that it takes part; the head is drawn 20 times wider, so that the logits
(1/128 of the head's product) spread over ~0.16, not ~0.008, and q and k 8 times wider, so that the
scores (their product times 0.0028) spread over ~0.7, not ~0.01, where the softmax is nearly uniform:
a tolerance of 1e-4 then sees a wrong multiplier.

Tolerances are 1e-4 abs and rel, as ``test_torch_granite.py``'s: both sides compute in float32, so
they differ only in the order of their sums (chunked SSD against the recurrence, the fused against
the separate projections, K scaled before or after its product with q), about 1e-7 here.  Any one
multiplier off by 1% moves the reference's logits by 2e-4 or more (``test_each_multiplier_moves_the_logits``).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from bench.harness import program, weights as wmod
from bench.harness.env import ROOT
from bench.reference import falcon_h1_lm as ref
from repro_torch.configs import ARCHS
from repro_torch.models import get_model, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-4
KEY_MULTIPLIER = 0.011048543456039804  # published; the configuration folds it into attention_multiplier
ARCH = dict(
    name="falcon-tiny", family="falcon_h1", num_layers=3, d_model=64, vocab_size=256, num_heads=4,
    num_kv_heads=2, head_dim=16, rope_theta=1e11, d_ff=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
    ssm_conv_width=4, ssm_chunk=16, hybrid_layer_ids=[0, 1, 2], ssm_ngroups=2, ssm_dt_min=0.0, ssm_inner=64,
    embedding_multiplier=5.656854249492381, attention_multiplier=KEY_MULTIPLIER * 16 ** -0.5, logits_scaling=128.0,
    ssm_in_multiplier=0.25, ssm_multipliers=[0.3535533905932738, 0.25, 0.1767766952966369, 0.5, 0.3535533905932738],
    ssm_out_multiplier=0.08838834764831845, attention_out_multiplier=0.0375,
    mlp_multipliers=[0.1767766952966369, 0.011160714285714284], norm_eps=1e-5, param_dtype="float32",
    compute_dtype="float32", tie_embeddings=False, attention_impl="xla", remat=False,
)
CONFIG = json.loads((ROOT / "bench" / "configs" / "falcon-h1-34b-instruct.json").read_text())
PUBLISHED = CONFIG["arch"]
MULTIPLIERS = ("embedding_multiplier", "attention_multiplier", "logits_scaling", "ssm_in_multiplier",
               "ssm_multipliers", "ssm_out_multiplier", "attention_out_multiplier", "mlp_multipliers")


def _weights(arch, seed=0):
    w = wmod.make(ref.param_specs(arch), seed, "cpu", torch.float32, ref.const_value)
    rng = torch.Generator().manual_seed(seed + 1)
    for name, t in w.items():
        if bool((t == 0).all()) or bool((t == 1).all()):
            t.add_(0.1 * torch.randn(t.shape, generator=rng))
    w["embedding.unembed"].mul_(20)
    return w


def _model(arch, w):
    cfg = program.arch_config(arch)
    model = get_model(cfg).init_params(cfg, torch.Generator(), device="meta")
    wmod.attach(model, {k: v.clone() for k, v in w.items()})
    program._fill_buffers(model, cfg, "cpu")
    return cfg, model


@pytest.fixture(scope="module")
def tiny():
    """(cfg, the program's model holding the weights, the weights) on the CPU."""
    w = _weights(ARCH)
    return (*_model(ARCH, w), w)


def _tokens(b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, ARCH["vocab_size"], (b, s)))


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), want.detach().float().numpy(), atol=tol, rtol=tol)


def _transformers_model(w, monkeypatch):
    """transformers' ``FalconH1ForCausalLM`` (eager attention, the plain Mixer) built from the same
    settings, holding ``w``."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    transformers = pytest.importorskip("transformers")
    a = ARCH
    hcfg = transformers.FalconH1Config(
        vocab_size=a["vocab_size"], hidden_size=a["d_model"], intermediate_size=a["d_ff"],
        num_hidden_layers=a["num_layers"], num_attention_heads=a["num_heads"], num_key_value_heads=a["num_kv_heads"],
        head_dim=a["head_dim"], hidden_act="silu", rms_norm_eps=a["norm_eps"], tie_word_embeddings=False,
        rope_theta=a["rope_theta"], mamba_d_ssm=a["ssm_inner"], mamba_n_heads=a["ssm_inner"] // a["ssm_head_dim"],
        mamba_d_head=a["ssm_head_dim"], mamba_n_groups=a["ssm_ngroups"], mamba_d_state=a["ssm_state"],
        mamba_d_conv=a["ssm_conv_width"], mamba_expand=a["ssm_expand"], mamba_chunk_size=a["ssm_chunk"],
        mamba_conv_bias=True, mamba_proj_bias=False, mamba_norm_before_gate=False, mamba_rms_norm=True,
        projectors_bias=False, lm_head_multiplier=1 / a["logits_scaling"],
        embedding_multiplier=a["embedding_multiplier"], mlp_multipliers=a["mlp_multipliers"], key_multiplier=KEY_MULTIPLIER,
        attention_out_multiplier=a["attention_out_multiplier"], attention_in_multiplier=1.0,
        ssm_multipliers=a["ssm_multipliers"], ssm_in_multiplier=a["ssm_in_multiplier"],
        ssm_out_multiplier=a["ssm_out_multiplier"], attn_implementation="eager",
    )
    hf = transformers.FalconH1ForCausalLM(hcfg).eval()
    m, d = hf.model, a["d_model"]
    with torch.no_grad():
        m.embed_tokens.weight.copy_(w["embedding.embed"])
        hf.lm_head.weight.copy_(w["embedding.unembed"].T)
        m.final_layernorm.weight.copy_(w["final_norm.scale"])
        for i, layer in enumerate(m.layers):
            p = f"layers.{i}."
            layer.input_layernorm.weight.copy_(w[p + "norm.scale"])
            layer.pre_ff_layernorm.weight.copy_(w[p + "ln2.scale"])
            mam = layer.mamba
            mam.in_proj.weight.copy_(torch.cat([w[p + f"ssm.{n}"] for n in ("wz", "wx", "wb", "wc", "wdt")], 1).T)
            mam.conv1d.weight.copy_(torch.cat([w[p + f"ssm.conv_{n}"] for n in "xbc"], 1).T[:, None, :])
            mam.conv1d.bias.copy_(torch.cat([w[p + f"ssm.conv_b{n}"] for n in "xbc"]))
            mam.dt_bias.copy_(w[p + "ssm.dt_bias"])
            mam.A_log.copy_(w[p + "ssm.a_log"])
            mam.D.copy_(w[p + "ssm.d_skip"])
            mam.norm.weight.copy_(w[p + "ssm.norm.scale"])
            mam.out_proj.weight.copy_(w[p + "ssm.out_proj"].T)
            att = layer.self_attn
            for n in "qkv":
                getattr(att, f"{n}_proj").weight.copy_(w[p + f"attn.w{n}"].reshape(d, -1).T)
            att.o_proj.weight.copy_(w[p + "attn.wo"].reshape(-1, d).T)
            ff = layer.feed_forward
            for n in ("gate", "up", "down"):
                getattr(ff, f"{n}_proj").weight.copy_(w[p + f"mlp.{n}"].T)
    return hf


# (a) the reference against the published code, within one chunk and past it
@pytest.mark.parametrize("s", [11, 37])
def test_reference_matches_transformers_falcon_h1(monkeypatch, s):
    w = _weights(ARCH)
    hf = _transformers_model(w, monkeypatch)
    toks = _tokens(2, s, seed=s)
    with torch.no_grad():
        published = hf(toks, use_cache=False).logits
    _close(ref.next_token_logits(ARCH, w, toks, 0), published)


@pytest.mark.parametrize("key", MULTIPLIERS)
def test_each_multiplier_moves_the_logits(key):
    """A multiplier 1% off moves the reference's logits by more than twice the tolerance: the
    parity tests above and below see each one."""
    w = _weights(ARCH)
    toks = _tokens(2, 37, seed=3)
    want = ref.next_token_logits(ARCH, w, toks, 0)
    v = ARCH[key]
    off = dict(ARCH, **{key: [x * 1.01 for x in v] if isinstance(v, list) else v * 1.01})
    assert float((ref.next_token_logits(off, w, toks, 0) - want).abs().max()) > 2 * TOL


# (b) the program against the reference: forward, and prefill then decode through the cache
def test_forward_matches_reference(tiny):
    cfg, model, w = tiny
    toks = _tokens(2, 37, seed=1)
    with torch.no_grad():
        logits, aux = get_model(cfg).forward(cfg, model, {"tokens": toks})
    assert float(aux) == 0.0
    _close(logits, ref.next_token_logits(ARCH, w, toks, 0))


@pytest.mark.parametrize("s", [13, 16, 21])
def test_prefill_then_decode_match_reference(tiny, s):
    cfg, model, w = tiny
    m, steps = get_model(cfg), 6
    toks = _tokens(3, s + steps, seed=s)
    want = ref.next_token_logits(ARCH, w, toks, s - 1)  # positions s-1 .. s+steps-1
    logits, cache = m.prefill(cfg, model, {"tokens": toks[:, :s]}, max_len=s + steps + 2)
    _close(logits[:, 0], want[:, 0])
    for t in range(steps):
        logits, cache = m.decode_step(cfg, model, cache, toks[:, s + t:s + t + 1])
        _close(logits[:, 0], want[:, t + 1])
        assert int(cache["pos"]) == s + t + 1


def test_served_tokens_follow_the_reference(tiny):
    cfg, model, w = tiny
    engine = ServeEngine(cfg, model, max_len=40, batch_size=2, device="cpu")
    prompts = _tokens(2, 19, seed=7)
    out = engine.run_batch([Request(i, prompts[i], max_new_tokens=8) for i in range(2)])
    served = torch.tensor([r.output for r in out])
    logits = ref.next_token_logits(ARCH, w, torch.cat([prompts, served[:, :-1]], 1), 18)
    top2 = logits.topk(2, dim=-1).values
    # a near-tie may go either way at float32: clear is a lead of 1e-3 of the logits' spread
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3 * logits.std()
    assert clear.float().mean() > 0.9
    assert torch.equal(served[clear], logits.argmax(-1)[clear])


# (c) each layer holds one K/V row and one SSM row; the pool counts every layer's K/V
def test_cache_layout_and_the_pools_bytes(tiny):
    cfg, model, _ = tiny
    logits, cache = get_model(cfg).prefill(cfg, model, {"tokens": _tokens(3, 20)}, max_len=30)
    assert cache["k"].shape == cache["v"].shape == (3, 3, 30, 2, 16)
    assert cache["ssm"]["state"].shape == (3, 3, 4, 16, 16) and cache["ssm"]["conv"].shape == (3, 3, 3, 64 + 2 * 2 * 16)
    empty = transformer.init_cache(cfg, 3, 30, torch.float32, "cpu")
    assert {k: v.shape for k, v in empty["ssm"].items()} == {k: v.shape for k, v in cache["ssm"].items()}
    assert empty["k"].shape == cache["k"].shape
    assert transformer.layer_rows(cfg) == ((0, 0), (1, 1), (2, 2))
    engine = ServeEngine(cfg, model, max_len=40, batch_size=2, device="cpu")
    assert engine.cache_mgr.cfg.bytes_per_token == 2 * 2 * 16 * 2 * 3  # K and V in bf16 over all three layers
    full = program.arch_config(PUBLISHED)
    assert (transformer.kv_rows(full), transformer.ssm_rows(full)) == (18, 18)
    assert transformer.layer_rows(full) == tuple((i, i) for i in range(18))
    full_engine = ServeEngine(full, get_model(full).init_params(full, torch.Generator(), device="meta"),
                              max_len=1088, batch_size=32, device="meta")
    assert full_engine.cache_mgr.cfg.bytes_per_token == 18 * 2_048  # 2 x 4 kv heads x 128 x 2 B a layer
    assert transformer.decode_graphable(cfg, model) is False  # the CPU decodes eagerly; on the card, replayed


# (d) a factor of 1 launches nothing: the other families run the ops they ran before this family came
def _aten_ops(cfg, params, cache, tokens) -> int:
    """The ATen ops that run inside the step's ``model.decode_step`` span."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        get_model(cfg).decode_step(cfg, params, cache, tokens)
    step = next(e.time_range for e in prof.events() if e.name == "model.decode_step")
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and step.start <= e.time_range.start and e.time_range.end <= step.end)


@pytest.mark.parametrize("name,parent_ops",
                         [("mamba2-780m", 515), ("zamba2-7b-instruct", 3168), ("granite-4.0-h-small", 1634)])
def test_unit_multipliers_add_no_op_to_a_decode_step(name, parent_ops):
    """The ATen ops of one reduced decode step on the CPU, counted under ``torch.profiler``, equal the
    count at the commit before falcon_h1 came (written here): every multiplier of 1 and the inner
    width left to ``ssm_expand`` add nothing to a Mamba2 layer, an MLP or an attention layer."""
    if name in ARCHS:
        cfg = ARCHS[name].reduced()
    else:
        conf = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
        cfg = program.arch_config(conf["arch"]).reduced()
    params = get_model(cfg).init_params(cfg, device="cpu")
    _, cache = get_model(cfg).prefill(cfg, params, {"tokens": _tokens(2, 9)}, max_len=16)
    assert all(m == 1.0 for m in params.layers[0].ssm.mup)
    assert _aten_ops(cfg, params, cache, _tokens(2, 1)) == parent_ops


def test_falcon_multipliers_scale_the_projections(tiny):
    cfg, model, _ = tiny
    mup = model.layers[0].ssm.mup
    assert mup == tuple(0.25 * m for m in ARCH["ssm_multipliers"])
    assert model.layers[0].ssm.wx.shape == (64, 64) and cfg.ssm_num_heads == 4 and cfg.ssm_d_inner == 64


# the parameter count, the benchmark's weights and the configuration file
@pytest.mark.parametrize("arch", [ARCH, PUBLISHED], ids=["tiny", "published"])
def test_param_count_is_the_reference_specs(arch):
    specs = ref.param_specs(arch)
    assert program.arch_config(arch).param_count() == sum(math.prod(shape) for _, shape, _ in specs)


def test_published_param_count():
    # Falcon-H1-34B-Instruct: 33.6 B parameters whole (72 layers); stage 0 here (18 layers, the head) 10.42 B
    assert program.arch_config(PUBLISHED).param_count() == 10_416_034_496
    whole = dict(PUBLISHED, num_layers=72, hybrid_layer_ids=list(range(72)))
    assert program.arch_config(whole).param_count() == 33_642_516_224
    assert (33_642_516_224 - 10_416_034_496) // 54 == 430_120_032  # a layer: attention, Mamba2, MLP, two norms
    # applied to each token: every weight once but the embedding, a lookup
    assert program.applied_weights(ref, PUBLISHED) == 10_416_034_496 - 261_120 * 5_120



def test_published_scores_spread_at_the_benchmarks_scales():
    """At the published widths, one layer's q and k drawn at ``param_specs``' scales give scores
    (q.k over 1024) that spread over ~0.7, so that the benchmark's softmax is not flat and its
    comparison sees which K/V rows attention read; at fan-in scales they would spread over ~0.01."""
    a = PUBLISHED
    specs = {n: (shape, init) for n, shape, init in ref.param_specs(dict(a, num_layers=1))}
    gen = torch.Generator().manual_seed(0)
    u = torch.randn(256, a["d_model"], generator=gen)
    (qs, (_, q_std)), (ks, (_, k_std)) = specs["layers.0.attn.wq"], specs["layers.0.attn.wk"]
    q = (u @ (torch.randn(qs, generator=gen) * q_std).reshape(a["d_model"], -1)).reshape(256, a["num_heads"], -1)
    k = (u @ (torch.randn(ks, generator=gen) * k_std).reshape(a["d_model"], -1)).reshape(256, a["num_kv_heads"], -1)
    k = k.repeat_interleave(a["num_heads"] // a["num_kv_heads"], dim=1)
    spread = float(torch.einsum("qhd,khd->hqk", q, k).std()) * a["attention_multiplier"]
    assert 0.55 < spread < 0.9
    assert 0.008 < spread / ref.QK_WIDEN ** 2 < 0.015  # what fan-in scales would give

def test_bench_build_attaches_every_reference_weight():
    cfg = program.arch_config(ARCH)
    model = program.build(cfg, ref, ARCH, 3, "cpu")
    w = program.reference_weights(ref, ARCH, 3, "cpu")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(w) and all(torch.equal(got[k], w[k]) for k in w)
    assert not [n for n, b in model.named_buffers() if b.is_meta]
    assert {n.rpartition(".")[2] for n, _ in model.named_buffers()} == {"kvm"}
    assert ref.weight_uses(ARCH, "embedding.embed") == 0 and ref.weight_uses(ARCH, "embedding.unembed") == 1


def test_reduced_keeps_the_layer_kind_and_the_multipliers():
    small = program.arch_config(PUBLISHED).reduced()
    assert small.family == "falcon_h1" and small.num_layers == 2 and small.hybrid_layer_ids == (0, 1)
    assert (small.ssm_d_inner, small.ssm_num_heads, small.ssm_groups) == (64, 4, 2)
    assert all(getattr(small, k) == program.arch_config(PUBLISHED).__getattribute__(k) for k in MULTIPLIERS)
    params = get_model(small).init_params(small, device="cpu")
    logits, _ = get_model(small).forward(small, params, {"tokens": _tokens(1, 9)})
    assert logits.shape == (1, 9, small.vocab_size) and bool(torch.isfinite(logits).all())


def test_config_file_holds_the_published_config():
    a = CONFIG["arch"]
    assert CONFIG["reduced"] == ["num_hidden_layers"] and CONFIG["published"]["num_hidden_layers"] == 72
    assert (a["num_layers"], a["d_model"], a["vocab_size"], a["d_ff"], a["head_dim"]) == (
        CONFIG["num_hidden_layers"], CONFIG["hidden_size"], CONFIG["vocab_size"], CONFIG["intermediate_size"],
        CONFIG["head_dim"])
    assert (a["num_heads"], a["num_kv_heads"], a["rope_theta"]) == (
        CONFIG["num_attention_heads"], CONFIG["num_key_value_heads"], CONFIG["rope_theta"])
    mixer = ("ssm_inner", "ssm_head_dim", "ssm_state", "ssm_ngroups", "ssm_conv_width", "ssm_chunk")
    published = ("mamba_d_ssm", "mamba_d_head", "mamba_d_state", "mamba_n_groups", "mamba_d_conv", "mamba_chunk_size")
    assert [a[k] for k in mixer] == [CONFIG[k] for k in published]
    for key in ("embedding_multiplier", "ssm_in_multiplier", "ssm_multipliers", "ssm_out_multiplier",
                "attention_out_multiplier", "mlp_multipliers"):
        assert a[key] == CONFIG[key]
    assert CONFIG["attention_in_multiplier"] == 1 and "attention_in_multiplier" not in a  # attention reads u itself
    assert a["attention_multiplier"] == CONFIG["key_multiplier"] * a["head_dim"] ** -0.5 == 1 / 1024
    assert a["logits_scaling"] * CONFIG["lm_head_multiplier"] == 1
    assert a["tie_embeddings"] is CONFIG["tie_word_embeddings"] is False
    cfg = ArchConfig(**a)
    assert cfg.ssm_num_heads == CONFIG["mamba_n_heads"] and cfg.hybrid_layer_ids == tuple(range(18))
    assert cfg.ssm_dt_min == 0.0 and CONFIG["mamba_norm_before_gate"] is False and CONFIG["mamba_rms_norm"] is True
    assert ref.dims(a)["h"] == 32 and (ref.dims(a)["p"], ref.dims(a)["g"], ref.dims(a)["n"]) == (128, 2, 256)


def test_config_refuses_a_layer_without_attention_and_bad_multipliers():
    with pytest.raises(ValueError, match="every layer"):
        program.arch_config(dict(ARCH, hybrid_layer_ids=[0, 2]))
    with pytest.raises(ValueError, match="ssm_multipliers"):
        program.arch_config(dict(ARCH, ssm_multipliers=[1.0, 1.0]))


def test_training_and_sharded_steps_refuse_the_family():
    from repro_torch.train import step

    cfg = program.arch_config(ARCH)
    with pytest.raises(NotImplementedError, match="falcon_h1"):
        step.make_train_fn(cfg)
    for fn in (step.make_train_step, step.make_decode_step):
        with pytest.raises(NotImplementedError, match="falcon_h1"):
            fn(cfg, None)


def test_flash_attention_is_refused(tiny):
    cfg, model, _ = tiny
    flash = dataclasses.replace(cfg, attention_impl="flash")
    with pytest.raises(ValueError, match="attention_multiplier"):
        get_model(flash).forward(flash, model, {"tokens": _tokens(1, 8)})


def test_spans_hold_both_mixers_inside_the_parallel_mixer():
    """Under a profiler, each layer's ``model.parallel_mixer`` span (``layer=``) holds its
    ``model.mamba2`` and ``model.attention`` spans, in forward, prefill and each decode step; the MLP
    lies outside it."""
    cfg = program.arch_config(ARCH)
    model = get_model(cfg).init_params(cfg, device="cpu")
    m = get_model(cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            m.forward(cfg, model, {"tokens": _tokens(1, 8)})
        _, cache = m.prefill(cfg, model, {"tokens": _tokens(1, 8)}, max_len=12)
        m.decode_step(cfg, model, cache, _tokens(1, 1))
    events = [e for e in prof.events() if e.name.startswith("model.") or e.name == "aten::mm"]
    spans = lambda name: [(e.time_range.start, e.time_range.end) for e in events if e.name == name]  # noqa: E731
    mixers = spans("model.parallel_mixer")
    assert len(mixers) == 9 and len(spans("model.mamba2")) == 9 and len(spans("model.attention")) == 9
    inside = lambda r: any(lo <= r[0] and r[1] <= hi for lo, hi in mixers)  # noqa: E731
    assert all(inside(r) for r in spans("model.mamba2") + spans("model.attention"))
    # each layer's three MLP products (gate, up, down) run outside its parallel mixer
    assert sum(not inside(r) for r in spans("aten::mm")) >= 3 * 9
