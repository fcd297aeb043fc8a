"""The port's granitemoehybrid family (IBM Granite 4.0-H) against the benchmark's plain reference,
and the reference against the published code, on the CPU.

A tiny granitemoehybrid config: hidden 64, 4 layers with attention at layer 1 (4 q heads and 2 kv
heads of 16, no RoPE) and Mamba2 elsewhere (8 heads of 16, state 16, one B/C group, chunk 16),
each followed by a dropless MoE over 8 experts of width 32 (top 2) and a shared expert of 64, the
published multipliers (embedding 12, residual 0.22, attention 1/128, logits 1/16), vocab 256.
Weights come from ``bench/reference/granite_moe_hybrid_lm.py``'s specs, made from a seed as the
benchmark makes them; every leaf that the specs set to all zeros or all ones (norm scales, conv
biases, dt_bias, D) is moved off that value with seeded noise, so that it takes part, and the
embedding is drawn 50 times wider (std 1/12, not the benchmark's 1/600): through the tied head and
the logits' scaling of 1/16 the logits then spread over ~0.05, not ~0.001, so that a tolerance of
1e-4 sees a wrong multiplier.

Tolerances are 1e-4 abs and rel, as ``test_torch_zamba2.py``'s: both sides compute in float32,
so they differ only in the order of their sums (chunked SSD against the recurrence, fused against
unfused projections, grouped against per-expert products), about 1e-7 here.  The residual
multiplier 0.221 for 0.22, the attention multiplier doubled, top 1 for top 2 or the embedding
multiplier 12.1 move the reference's logits by 1e-3 to 5e-2.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from bench.harness import program, weights as wmod
from bench.harness.env import ROOT
from bench.reference import granite_moe_hybrid_lm as ref
from bench.reference.mamba2_lm import Numerics
from repro_torch.models import get_model, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import MoE, moe_apply, moe_dropless
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-4
ARCH = dict(
    name="granite-tiny", family="granitemoehybrid", num_layers=4, d_model=64, vocab_size=256, num_heads=4,
    num_kv_heads=2, head_dim=16, rope_theta=10000.0, num_experts=8, num_shared_experts=2, top_k=2, expert_d_ff=32,
    experts_held=0, expert_first=0, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
    ssm_conv_width=4, ssm_chunk=16, hybrid_layer_ids=[1], ssm_ngroups=1, ssm_dt_min=0.0, embedding_multiplier=12.0,
    residual_multiplier=0.22, attention_multiplier=0.0078125, logits_scaling=16.0, norm_eps=1e-5,
    param_dtype="float32", compute_dtype="float32", tie_embeddings=True, attention_impl="xla", remat=False,
)
CONFIG = json.loads((ROOT / "bench" / "configs" / "granite-4.0-h-small.json").read_text())
PUBLISHED = CONFIG["arch"]
MOE_LEAVES = ("router", "gate", "up", "down", "shared.gate", "shared.up", "shared.down")


def _weights(arch, seed=0):
    w = wmod.make(ref.param_specs(arch), seed, "cpu", torch.float32, ref.const_value)
    rng = torch.Generator().manual_seed(seed + 1)
    for name, t in w.items():
        if bool((t == 0).all()) or bool((t == 1).all()):
            t.add_(0.1 * torch.randn(t.shape, generator=rng))
    w["embedding.embed"].mul_(50)
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
    """transformers' ``GraniteMoeHybridForCausalLM`` (eager attention, the plain Mixer) built from the
    same settings, every expert held, holding ``w``."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    transformers = pytest.importorskip("transformers")
    a = ARCH
    types = ["attention" if i in a["hybrid_layer_ids"] else "mamba" for i in range(a["num_layers"])]
    hcfg = transformers.GraniteMoeHybridConfig(
        vocab_size=a["vocab_size"], hidden_size=a["d_model"], intermediate_size=a["expert_d_ff"],
        num_hidden_layers=a["num_layers"], num_attention_heads=a["num_heads"], num_key_value_heads=a["num_kv_heads"],
        hidden_act="silu", rms_norm_eps=a["norm_eps"], tie_word_embeddings=True, attention_bias=False,
        embedding_multiplier=a["embedding_multiplier"], logits_scaling=a["logits_scaling"],
        residual_multiplier=a["residual_multiplier"], attention_multiplier=a["attention_multiplier"],
        num_local_experts=a["num_experts"], num_experts_per_tok=a["top_k"],
        shared_intermediate_size=a["expert_d_ff"] * a["num_shared_experts"], position_embedding_type="nope", layer_types=types,
        mamba_n_heads=a["d_model"] * a["ssm_expand"] // a["ssm_head_dim"], mamba_n_groups=a["ssm_ngroups"],
        mamba_d_state=a["ssm_state"], mamba_d_head=a["ssm_head_dim"], mamba_d_conv=a["ssm_conv_width"],
        mamba_expand=a["ssm_expand"], mamba_chunk_size=a["ssm_chunk"], mamba_conv_bias=True, mamba_proj_bias=False,
        attn_implementation="eager",
    )
    hf = transformers.GraniteMoeHybridForCausalLM(hcfg).eval()
    m, d = hf.model, a["d_model"]
    with torch.no_grad():
        m.embed_tokens.weight.copy_(w["embedding.embed"])
        hf.lm_head.weight.copy_(w["embedding.embed"])
        m.norm.weight.copy_(w["final_norm.scale"])
        for i, layer in enumerate(m.layers):
            p = f"layers.{i}."
            layer.input_layernorm.weight.copy_(w[p + "norm.scale"])
            layer.post_attention_layernorm.weight.copy_(w[p + "ln2.scale"])
            if layer.mamba is not None:
                mam = layer.mamba
                mam.in_proj.weight.copy_(torch.cat([w[p + f"ssm.{n}"] for n in ("wz", "wx", "wb", "wc", "wdt")], 1).T)
                mam.conv1d.weight.copy_(torch.cat([w[p + f"ssm.conv_{n}"] for n in "xbc"], 1).T[:, None, :])
                mam.conv1d.bias.copy_(torch.cat([w[p + f"ssm.conv_b{n}"] for n in "xbc"]))
                mam.dt_bias.copy_(w[p + "ssm.dt_bias"])
                mam.A_log.copy_(w[p + "ssm.a_log"])
                mam.D.copy_(w[p + "ssm.d_skip"])
                mam.norm.weight.copy_(w[p + "ssm.norm.scale"])
                mam.out_proj.weight.copy_(w[p + "ssm.out_proj"].T)
            else:
                att = layer.self_attn
                for n in "qkv":
                    getattr(att, f"{n}_proj").weight.copy_(w[p + f"attn.w{n}"].reshape(d, -1).T)
                att.o_proj.weight.copy_(w[p + "attn.wo"].reshape(-1, d).T)
            moe = layer.block_sparse_moe
            moe.router.layer.weight.copy_(w[p + "moe.router"].T)
            moe.input_linear.weight.copy_(torch.cat([w[p + "moe.gate"], w[p + "moe.up"]], dim=2).transpose(1, 2))
            moe.output_linear.weight.copy_(w[p + "moe.down"].transpose(1, 2))
            layer.shared_mlp.input_linear.weight.copy_(torch.cat([w[p + "moe.shared.gate"], w[p + "moe.shared.up"]], 1).T)
            layer.shared_mlp.output_linear.weight.copy_(w[p + "moe.shared.down"].T)
    return hf


# (a) the reference against the published code, within one chunk and past it (transformers'
# Granite Mixer carries state between chunks as the recurrence does)
@pytest.mark.parametrize("s", [11, 37])
def test_reference_matches_transformers_granite(monkeypatch, s):
    w = _weights(ARCH)
    hf = _transformers_model(w, monkeypatch)
    toks = _tokens(2, s, seed=s)
    with torch.no_grad():
        published = hf(toks, use_cache=False).logits
    _close(ref.next_token_logits(ARCH, w, toks, 0), published)


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


# (c) one chip's share: the parts that four shares of 2 experts give, the shared expert counted
# once, add up to the uncut layer, in the reference and in the program (both of its paths)
def _share(arch, w, layer, first, held):
    """(the arch of the share holding experts first..first+held-1, its MoE weights under their leaf names)."""
    a = dict(arch, experts_held=held, expert_first=first)
    pre = f"layers.{layer}.moe."
    sw = {n: w[pre + n] for n in MOE_LEAVES}
    sw.update({n: w[pre + n][first:first + held] for n in ("gate", "up", "down")})
    return a, sw


def _port_moe(arch, leaves):
    cfg = program.arch_config(arch)
    p = MoE(cfg, torch.Generator(), "meta")
    wmod.attach(p, {k: v.clone() for k, v in leaves.items()})
    return cfg, p


@pytest.mark.parametrize("s", [1, 24], ids=["decode", "prefill"])
def test_four_shares_sum_to_the_uncut_layer(s):
    w = _weights(ARCH, seed=4)
    u = torch.randn(3, s, ARCH["d_model"], generator=torch.Generator().manual_seed(s))
    nm, pre = Numerics(), "layers.2.moe."
    whole_ref = ref.moe(ARCH, {pre + n: t for n, t in _share(ARCH, w, 2, 0, 8)[1].items()}, pre, u, nm)
    cfg, p = _port_moe(*_share(ARCH, w, 2, 0, 8))
    whole_port = moe_dropless(cfg, p, u)
    _close(whole_port, whole_ref)
    shares = [_share(ARCH, w, 2, first, 2) for first in (0, 2, 4, 6)]
    shared = ref.swiglu(u, w[pre + "shared.gate"], w[pre + "shared.up"], w[pre + "shared.down"], nm)
    parts_ref = [ref.moe(a, {pre + n: t for n, t in sw.items()}, pre, u, nm) for a, sw in shares]
    parts_port = [moe_dropless(*_port_moe(a, sw), u) for a, sw in shares]
    _close(sum(parts_ref) - 3 * shared, whole_ref)
    _close(sum(parts_port) - 3 * shared, whole_ref)
    # each share adds something of its own: no share is the shared expert alone
    assert all(float((part - shared).detach().abs().max()) > 1e-3 for part in parts_port)


def test_the_share_held_is_the_configurations():
    cfg = program.arch_config(PUBLISHED)
    p = MoE(cfg, torch.Generator(), "meta")
    assert (cfg.num_experts, cfg.num_experts_held, cfg.expert_first, cfg.top_k) == (72, 9, 0, 10)
    assert p.router.shape == (4096, 72) and p.gate.shape == (9, 4096, 768) and p.down.shape == (9, 768, 4096)
    assert p.shared.gate.shape == (4096, 1536)
    with pytest.raises(ValueError, match="held"):
        program.arch_config(dict(PUBLISHED, expert_first=64))


# (d) routing is dropless: every token sent to one expert is served whole, where the capacity path drops
def test_routing_is_dropless_where_the_capacity_path_drops():
    w = _weights(ARCH, seed=6)
    pre = "layers.0.moe."
    leaves = _share(ARCH, w, 0, 0, 8)[1]
    router = 0.01 * torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    router[:, 0] = 1.0  # with u >= 0 every token's largest logit is expert 0's
    leaves["router"] = router
    u = torch.rand(2, 40, 64, generator=torch.Generator().manual_seed(2))
    cfg, p = _port_moe(ARCH, leaves)
    _, expert = torch.topk(u @ router, 2, dim=-1)
    assert bool((expert[..., 0] == 0).all())
    want = ref.moe(ARCH, {pre + n: t for n, t in leaves.items()}, pre, u, Numerics())
    _close(moe_dropless(cfg, p, u), want)
    capacity = dataclasses.replace(cfg, family="moe")
    dropped, _ = moe_apply(capacity, p, u)  # 12 slots an expert for 40 tokens: 28 dropped at expert 0
    assert float((dropped - want).abs().max()) > 1e-2
    whole, _ = moe_apply(dataclasses.replace(capacity, capacity_factor=8.0), p, u)
    _close(whole, want)


# (e) the cache holds K/V for the attention layers alone and SSM state for the Mamba2 layers alone
def test_cache_layout_and_the_pools_bytes(tiny):
    cfg, model, _ = tiny
    logits, cache = get_model(cfg).prefill(cfg, model, {"tokens": _tokens(3, 20)}, max_len=30)
    assert cache["k"].shape == cache["v"].shape == (1, 3, 30, 2, 16)
    assert cache["ssm"]["state"].shape == (3, 3, 8, 16, 16) and cache["ssm"]["conv"].shape == (3, 3, 3, 128 + 2 * 16)
    empty = transformer.init_cache(cfg, 3, 30, torch.float32, "cpu")
    assert {k: v.shape for k, v in empty["ssm"].items()} == {k: v.shape for k, v in cache["ssm"].items()}
    assert empty["k"].shape == cache["k"].shape
    engine = ServeEngine(cfg, model, max_len=40, batch_size=2, device="cpu")
    assert engine.cache_mgr.cfg.bytes_per_token == 2 * 2 * 16 * 2 * 1  # K and V in bf16 over one row, not 4
    full = program.arch_config(PUBLISHED)
    assert (transformer.kv_rows(full), transformer.ssm_rows(full)) == (4, 36)
    assert [transformer.layer_rows(full)[i] for i in (0, 4, 5, 6, 16, 39)] == [
        (None, 0), (None, 4), (0, None), (None, 5), (None, 14), (None, 35)]


# the parameter count, the benchmark's weights and the configuration file
@pytest.mark.parametrize("arch", [ARCH, PUBLISHED], ids=["tiny", "published"])
def test_param_count_is_the_reference_specs(arch):
    specs = ref.param_specs(arch)
    assert program.arch_config(arch).param_count() == sum(math.prod(shape) for _, shape, _ in specs)


def test_published_param_count():
    # Granite-4.0-H-Small: 32.2 B parameters whole; this chip's share (9 of 72 experts) 8.43 B
    assert program.arch_config(PUBLISHED).param_count() == 8_425_634_304
    assert program.arch_config(dict(PUBLISHED, experts_held=0)).param_count() == 32_207_337_984
    # applied to each token: every weight once but the held experts', each at 10 / 72
    assert program.applied_weights(ref, PUBLISHED) == pytest.approx(5_500_107_264)


def test_bench_build_attaches_every_reference_weight():
    cfg = program.arch_config(ARCH)
    model = program.build(cfg, ref, ARCH, 3, "cpu")
    w = program.reference_weights(ref, ARCH, 3, "cpu")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(w) and all(torch.equal(got[k], w[k]) for k in w)
    assert not [n for n, b in model.named_buffers() if b.is_meta]
    assert {n.rpartition(".")[2] for n, _ in model.named_buffers()} == {"kvm"}
    assert ref.weight_uses(ARCH, "layers.0.moe.gate") == 2 / 8 and ref.weight_uses(ARCH, "layers.0.moe.shared.up") == 1


def test_reduced_keeps_the_layer_kinds_and_the_experts():
    small = program.arch_config(PUBLISHED).reduced()
    assert small.family == "granitemoehybrid" and small.num_layers == 4 and small.hybrid_layer_ids == (1,)
    assert (small.num_experts, small.num_experts_held, small.top_k) == (8, 8, 2)
    assert small.num_shared_experts == 2 and small.attention_multiplier == 0.0078125
    assert (small.embedding_multiplier, small.residual_multiplier, small.logits_scaling) == (12.0, 0.22, 16.0)
    params = get_model(small).init_params(small, device="cpu")
    logits, _ = get_model(small).forward(small, params, {"tokens": _tokens(1, 9)})
    assert logits.shape == (1, 9, small.vocab_size) and bool(torch.isfinite(logits).all())


def test_config_file_holds_the_published_config():
    a = CONFIG["arch"]
    assert CONFIG["reduced"] == ["num_local_experts"] and CONFIG["published"]["num_local_experts"] == 72
    assert (a["num_layers"], a["d_model"], a["vocab_size"], a["expert_d_ff"], a["expert_d_ff"] * a["num_shared_experts"]) == (
        CONFIG["num_hidden_layers"], CONFIG["hidden_size"], CONFIG["vocab_size"], CONFIG["intermediate_size"],
        CONFIG["shared_intermediate_size"])
    assert a["hybrid_layer_ids"] == [i for i, t in enumerate(CONFIG["layer_types"]) if t == "attention"]
    assert (a["num_experts"], a["experts_held"], a["top_k"]) == (72, CONFIG["num_local_experts"],
                                                                 CONFIG["num_experts_per_tok"])
    for key in ("embedding_multiplier", "residual_multiplier", "attention_multiplier", "logits_scaling"):
        assert a[key] == CONFIG[key]
    cfg = ArchConfig(**a)
    assert cfg.ssm_num_heads == CONFIG["mamba_n_heads"] and cfg.ssm_state == CONFIG["mamba_d_state"]
    assert cfg.resolved_head_dim * cfg.num_heads == CONFIG["hidden_size"] and cfg.ssm_dt_min == 0.0
    assert CONFIG["position_embedding_type"] == "nope" and CONFIG["tie_word_embeddings"] is True


def test_training_and_sharded_steps_refuse_the_family():
    from repro_torch.train import step

    cfg = program.arch_config(ARCH)
    with pytest.raises(NotImplementedError, match="granitemoehybrid"):
        step.make_train_fn(cfg)
    for fn in (step.make_train_step, step.make_decode_step):
        with pytest.raises(NotImplementedError, match="granitemoehybrid"):
            fn(cfg, None)


def test_flash_attention_is_refused(tiny):
    cfg, model, _ = tiny
    flash = dataclasses.replace(cfg, attention_impl="flash")
    with pytest.raises(ValueError, match="attention_multiplier"):
        get_model(flash).forward(flash, model, {"tokens": _tokens(1, 8)})


def test_spans_wrap_each_layer_and_its_moe():
    """Under a profiler, each layer's MoE lies in one ``model.moe`` span (``layer=``), beside the
    layer's ``model.mamba2`` or ``model.attention`` span, in prefill and in each decode step."""
    cfg = program.arch_config(ARCH)
    model = get_model(cfg).init_params(cfg, device="cpu")
    m = get_model(cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, cache = m.prefill(cfg, model, {"tokens": _tokens(1, 8)}, max_len=12)
        m.decode_step(cfg, model, cache, _tokens(1, 1))
    names = [e.name for e in prof.events()]
    assert names.count("model.moe") == 8 and names.count("model.attention") == 2 and names.count("model.mamba2") == 6
