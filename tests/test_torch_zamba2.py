"""The port's zamba2 family (the published Zamba2) against the benchmark's plain reference,
and the reference against the published code, on the CPU.

A tiny zamba2 config: hidden 64, 8 Mamba2 layers, sites after ``hybrid_layer_ids``
[1, 4, 6] (blocks 0, 1, 0), 2 shared blocks, 2 B/C groups over 8 Mamba heads of 16,
4 attention heads of 32 (2 x 64 / 4) with RoPE, LoRA rank 8, vocab 256.  Weights come
from ``bench/reference/zamba2_lm.py``'s specs, made from a seed as the benchmark makes
them; every leaf that the specs set to all zeros or all ones (norm scales, biases,
dt_bias, D) is moved off that value with seeded noise, so that it takes part.

Tolerances are 1e-4 abs and rel, as ``torch_parity``'s: both sides compute in float32
(the program's compute dtype here, the reference's always), so they differ only in the
order of their sums (chunked SSD against the recurrence, fused against unfused
projections), about 1e-6 here.  A wrong site, block, group or scale moves logits by
1e-2 or more.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from bench.harness import program, weights as wmod
from bench.harness.env import ROOT
from bench.reference import zamba2_lm as ref
from repro_torch.models import get_model, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-4
ARCH = dict(
    name="zamba2-tiny", family="zamba2", num_layers=8, d_model=64, vocab_size=256, num_heads=4, num_kv_heads=4,
    head_dim=32, rope_theta=10000.0, d_ff=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv_width=4,
    ssm_chunk=16, hybrid_layer_ids=[1, 4, 6], num_mem_blocks=2, adapter_rank=8, mem_rope=True, ssm_ngroups=2,
    ssm_dt_min=0.001, norm_eps=1e-5, param_dtype="float32", compute_dtype="float32", tie_embeddings=True,
    attention_impl="xla", remat=False,
)
PUBLISHED = json.loads((ROOT / "bench" / "configs" / "zamba2-7b-instruct.json").read_text())["arch"]


def _weights(arch, seed=0):
    w = wmod.make(ref.param_specs(arch), seed, "cpu", torch.float32, ref.const_value)
    rng = torch.Generator().manual_seed(seed + 1)
    for name, t in w.items():
        if bool((t == 0).all()) or bool((t == 1).all()):
            t.add_(0.1 * torch.randn(t.shape, generator=rng))
    return w


@pytest.fixture(scope="module")
def tiny():
    """(cfg, the program's model holding the weights, the weights) on the CPU."""
    cfg = program.arch_config(ARCH)
    w = _weights(ARCH)
    model = get_model(cfg).init_params(cfg, torch.Generator(), device="meta")
    wmod.attach(model, {k: v.clone() for k, v in w.items()})
    program._fill_buffers(model, cfg, "cpu")
    return cfg, model, w


def _tokens(b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, ARCH["vocab_size"], (b, s)))


def _close(port, want):
    np.testing.assert_allclose(port.detach().float().numpy(), want.detach().float().numpy(), atol=TOL, rtol=TOL)


def _transformers_model(w, monkeypatch):
    """transformers' ``Zamba2ForCausalLM`` (eager attention, the plain Mixer) built from the same
    settings, holding ``w``."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    transformers = pytest.importorskip("transformers")
    a = ARCH
    types = ["hybrid" if i in a["hybrid_layer_ids"] else "mamba" for i in range(a["num_layers"])]
    hcfg = transformers.Zamba2Config(
        vocab_size=a["vocab_size"], hidden_size=a["d_model"], num_hidden_layers=a["num_layers"],
        layers_block_type=types, mamba_d_state=a["ssm_state"], mamba_d_conv=a["ssm_conv_width"],
        mamba_expand=a["ssm_expand"], mamba_ngroups=a["ssm_ngroups"],
        n_mamba_heads=a["d_model"] * a["ssm_expand"] // a["ssm_head_dim"], chunk_size=a["ssm_chunk"],
        intermediate_size=a["d_ff"], num_attention_heads=a["num_heads"], num_key_value_heads=a["num_kv_heads"],
        num_mem_blocks=a["num_mem_blocks"], adapter_rank=a["adapter_rank"], use_mem_rope=a["mem_rope"],
        use_shared_attention_adapter=False, rope_theta=a["rope_theta"], rms_norm_eps=a["norm_eps"],
        time_step_min=a["ssm_dt_min"], hidden_act="gelu", tie_word_embeddings=True,
        attn_implementation="eager",
    )
    assert hcfg.attention_head_dim == a["head_dim"] and hcfg.hybrid_layer_ids == a["hybrid_layer_ids"]
    hf = transformers.Zamba2ForCausalLM(hcfg).eval()
    m, d, h, hd = hf.model, a["d_model"], a["num_heads"], a["head_dim"]
    with torch.no_grad():
        m.embed_tokens.weight.copy_(w["embedding.embed"])
        hf.lm_head.weight.copy_(w["embedding.embed"])
        m.final_layernorm.weight.copy_(w["final_norm.scale"])
        for i, layer in enumerate(m.layers):
            dec = layer.mamba_decoder if i in a["hybrid_layer_ids"] else layer
            p, mam = f"layers.{i}.", dec.mamba
            dec.input_layernorm.weight.copy_(w[p + "norm.scale"])
            mam.in_proj.weight.copy_(torch.cat([w[p + f"ssm.{n}"] for n in ("wz", "wx", "wb", "wc", "wdt")], 1).T)
            mam.conv1d.weight.copy_(torch.cat([w[p + f"ssm.conv_{n}"] for n in "xbc"], 1).T[:, None, :])
            mam.conv1d.bias.copy_(torch.cat([w[p + f"ssm.conv_b{n}"] for n in "xbc"]))
            mam.dt_bias.copy_(w[p + "ssm.dt_bias"])
            mam.A_log.copy_(w[p + "ssm.a_log"])
            mam.D.copy_(w[p + "ssm.d_skip"])
            mam.norm.weight.copy_(w[p + "ssm.norm.scale"])
            mam.out_proj.weight.copy_(w[p + "ssm.out_proj"].T)
            if i in a["hybrid_layer_ids"]:
                j = a["hybrid_layer_ids"].index(i)
                b, s, st = f"blocks.{j % a['num_mem_blocks']}.", f"sites.{j}.", layer.shared_transformer
                layer.linear.weight.copy_(w[s + "linear"].T)
                st.input_layernorm.weight.copy_(w[b + "ln1.scale"])
                for n in "qkv":
                    getattr(st.self_attn, f"{n}_proj").weight.copy_(w[b + f"attn.w{n}"].reshape(2 * d, h * hd).T)
                st.self_attn.o_proj.weight.copy_(w[b + "attn.wo"].reshape(h * hd, d).T)
                st.pre_ff_layernorm.weight.copy_(w[b + "ln2.scale"])
                st.feed_forward.gate_up_proj.weight.copy_(w[b + "gate_up"].T)
                st.feed_forward.down_proj.weight.copy_(w[b + "down"].T)
                adapter = st.feed_forward.gate_up_proj_adapter_list[j]
                adapter[0].weight.copy_(w[s + "lora_a"].T)
                adapter[1].weight.copy_(w[s + "lora_b"].T)
    return hf


# (a) the reference against the published code.  Over one chunk, transformers' full forward; past it,
# its step-by-step decode through its own cache (the exact recurrence), since its plain full-sequence
# path carries state between chunks along the wrong axis (``zamba2_lm``'s docstring)
@pytest.mark.parametrize("s", [11, 16])
def test_reference_matches_transformers_zamba2_within_a_chunk(monkeypatch, s):
    w = _weights(ARCH)
    hf = _transformers_model(w, monkeypatch)
    toks = _tokens(2, s)
    with torch.no_grad():
        published = hf(toks, use_cache=False).logits
    _close(ref.next_token_logits(ARCH, w, toks, 0), published)


def test_reference_matches_transformers_zamba2_decoding_past_a_chunk(monkeypatch):
    w = _weights(ARCH)
    hf = _transformers_model(w, monkeypatch)
    toks, first = _tokens(2, 37, seed=5), ARCH["ssm_chunk"]  # 37 tokens: three chunks, the last ragged
    want = ref.next_token_logits(ARCH, w, toks, first - 1)
    with torch.no_grad():
        out = hf(toks[:, :first], use_cache=True)
        got, cache = [out.logits[:, -1]], out.past_key_values
        for t in range(first, toks.shape[1]):
            out = hf(toks[:, t:t + 1], past_key_values=cache, use_cache=True, cache_position=torch.tensor([t]))
            got.append(out.logits[:, -1])
            cache = out.past_key_values
    _close(want, torch.stack(got, dim=1))


# (b) the program's forward against the reference
def test_forward_matches_reference(tiny):
    cfg, model, w = tiny
    toks = _tokens(2, 37, seed=1)
    with torch.no_grad():
        logits, aux = get_model(cfg).forward(cfg, model, {"tokens": toks})
    assert float(aux) == 0.0
    _close(logits, ref.next_token_logits(ARCH, w, toks, 0))


# (c) prefill, then decode through the cache, against the reference's full forward at each position
@pytest.mark.parametrize("s", [13, 16, 21])
def test_prefill_then_decode_match_reference(tiny, s):
    cfg, model, w = tiny
    m, steps = get_model(cfg), 6
    toks = _tokens(3, s + steps, seed=s)
    want = ref.next_token_logits(ARCH, w, toks, s - 1)  # positions s-1 .. s+steps-1
    logits, cache = m.prefill(cfg, model, {"tokens": toks[:, :s]}, max_len=s + steps + 2)
    assert cache["k"].shape == (3, 3, s + steps + 2, 4, 32) and cache["ssm"]["state"].shape == (8, 3, 8, 16, 16)
    assert cache["ssm"]["conv"].shape == (8, 3, 3, 128 + 2 * 2 * 16)
    _close(logits[:, 0], want[:, 0])
    for t in range(steps):
        before = {k: v.clone() for k, v in cache.items() if k in ("k", "v")}
        logits, new = m.decode_step(cfg, model, cache, toks[:, s + t:s + t + 1])
        _close(logits[:, 0], want[:, t + 1])
        assert int(new["pos"]) == s + t + 1
        assert torch.equal(cache["k"], before["k"]) and torch.equal(cache["v"], before["v"])  # the input cache kept
        cache = new


def test_served_tokens_follow_the_reference(tiny):
    cfg, model, w = tiny
    engine = ServeEngine(cfg, model, max_len=40, batch_size=2, device="cpu")
    # the pool's bytes a token: K and V in bf16 over the 3 sites, not the 8 layers
    assert engine.cache_mgr.cfg.bytes_per_token == 2 * 4 * 32 * 2 * 3 == 2 * 4 * 32 * 2 * transformer.kv_rows(cfg)
    prompts = _tokens(2, 19, seed=7)
    out = engine.run_batch([Request(i, prompts[i], max_new_tokens=8) for i in range(2)])
    served = torch.tensor([r.output for r in out])
    logits = ref.next_token_logits(ARCH, w, torch.cat([prompts, served[:, :-1]], 1), 18)
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3  # a near-tie may go either way at float32
    assert clear.float().mean() > 0.9
    assert torch.equal(served[clear], logits.argmax(-1)[clear])


# (d) the parameter count and the benchmark's weights
@pytest.mark.parametrize("arch", [ARCH, PUBLISHED], ids=["tiny", "published"])
def test_param_count_is_the_reference_specs(arch):
    specs = ref.param_specs(arch)
    assert program.arch_config(arch).param_count() == sum(math.prod(shape) for _, shape, _ in specs)


def test_published_param_count():
    # Zamba2-7B-Instruct: 7.357 B parameters (the tied head once), 11.03 B applied to each token
    assert program.arch_config(PUBLISHED).param_count() == 7_356_749_648
    assert program.applied_weights(ref, PUBLISHED) == 11_030_553_936


def test_bench_build_attaches_every_reference_weight():
    cfg = program.arch_config(ARCH)
    model = program.build(cfg, ref, ARCH, 3, "cpu")
    w = program.reference_weights(ref, ARCH, 3, "cpu")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(w) and all(torch.equal(got[k], w[k]) for k in w)
    assert not [n for n, b in model.named_buffers() if b.is_meta]
    # a block's weights are counted once at each of its sites: blocks 0 and 1 serve sites {0, 2} and {1}
    assert ref.weight_uses(ARCH, "blocks.0.gate_up") == 2 and ref.weight_uses(ARCH, "blocks.1.attn.wq") == 1


# (e) the reduced config keeps what defines the family
def test_reduced_keeps_blocks_sites_and_groups():
    full = program.arch_config(PUBLISHED)
    small = full.reduced()
    assert small.family == "zamba2" and small.num_mem_blocks == 2 and small.ssm_groups == 2
    sites = small.hybrid_layer_ids
    assert len(sites) >= 3 and max(sites) < small.num_layers
    assert {j % small.num_mem_blocks for j in range(len(sites))} == {0, 1}
    assert small.num_kv_heads == small.num_heads and small.head_dim * small.num_heads == 2 * small.d_model
    assert small.ssm_num_heads % small.ssm_groups == 0 and small.mem_rope
    # it builds and runs
    params = get_model(small).init_params(small, device="cpu")
    logits, _ = get_model(small).forward(small, params, {"tokens": _tokens(1, 9)})
    assert logits.shape == (1, 9, small.vocab_size) and bool(torch.isfinite(logits).all())


def test_config_file_holds_the_published_config():
    conf = json.loads((ROOT / "bench" / "configs" / "zamba2-7b-instruct.json").read_text())
    a = conf["arch"]
    assert conf["reduced"] == [] and a["family"] == "zamba2"
    assert (a["num_layers"], a["d_model"], a["vocab_size"], a["d_ff"]) == (
        conf["num_hidden_layers"], conf["hidden_size"], conf["vocab_size"], conf["intermediate_size"])
    assert a["hybrid_layer_ids"] == conf["hybrid_layer_ids"] and a["ssm_ngroups"] == conf["mamba_ngroups"]
    assert a["head_dim"] == conf["attention_head_dim"] and a["ssm_state"] == conf["mamba_d_state"]
    assert ArchConfig(**a).ssm_num_heads == conf["n_mamba_heads"]


def test_config_is_hashable_with_its_sites_as_a_tuple():
    cfg = program.arch_config(ARCH)
    assert cfg.hybrid_layer_ids == (1, 4, 6) and hash(cfg) == hash(dataclasses.replace(cfg))


def test_training_and_sharded_steps_refuse_the_family():
    from repro_torch.train import step

    cfg = program.arch_config(ARCH)
    with pytest.raises(NotImplementedError, match="zamba2"):
        step.make_train_fn(cfg)
    for fn in (step.make_train_step, step.make_decode_step):
        with pytest.raises(NotImplementedError, match="zamba2"):
            fn(cfg, None)
    with pytest.raises(NotImplementedError, match="zamba2"):
        step.make_prefill_step(cfg, None, 64)


def test_flash_attention_is_refused(tiny):
    cfg, model, _ = tiny
    flash = dataclasses.replace(cfg, attention_impl="flash")
    with pytest.raises(ValueError, match="head_dim / 2"):
        get_model(flash).forward(flash, model, {"tokens": _tokens(1, 8)})


def test_shared_block_span_wraps_each_site():
    """Under a profiler, each site's work lies in one ``model.shared_block`` span (site, block
    and layer in its args) with the block's ``model.attention`` inside it."""
    cfg = program.arch_config(ARCH)
    model = get_model(cfg).init_params(cfg, device="cpu")
    m = get_model(cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, cache = m.prefill(cfg, model, {"tokens": _tokens(1, 8)}, max_len=12)
        m.decode_step(cfg, model, cache, _tokens(1, 1))
    events = [e for e in prof.events() if e.name in ("model.shared_block", "model.attention")]
    blocks = [e for e in events if e.name == "model.shared_block"]
    assert len(blocks) == 6  # 3 sites, in prefill and in one decode step
    for e in events:
        if e.name == "model.attention":
            assert any(b.time_range.start <= e.time_range.start and e.time_range.end <= b.time_range.end
                       for b in blocks)
