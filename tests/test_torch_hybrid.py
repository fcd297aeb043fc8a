"""The port's hybrid (zamba2-2.7b) and vlm (internvl2-26b) families against the
JAX package's, on the CPU.

The two families that change the decoder's layer stack or its inputs: the
hybrid's Mamba2 layers with one weight-shared attention block after every
``attn_every``-th layer (reduced: 4 layers, a site after layers 1 and 3, each
with its own K/V), and the vlm's patch embeddings ahead of the tokens
(reduced: 8 patches).  Both are built by the reference from PRNGKey(0), with
constant leaves perturbed, and converted by ``load_jax_params``; the
tolerance is 1e-4 abs and rel (``torch_parity``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.convert import load_jax_params
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import (
    build,
    check_forward,
    check_loss,
    check_prefill_and_decode,
    check_prefill_equals_shorter_prefill_and_decode,
    check_serve,
    tokens,
)

ARCHS = ["zamba2-2.7b", "internvl2-26b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return build(request.param)


@pytest.fixture(scope="module")
def hybrid():
    return build("zamba2-2.7b")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match(pair, impl):
    assert float(check_forward(pair, impl)) == 0.0


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_fn_matches(pair, impl):
    check_loss(pair, impl)


@pytest.mark.parametrize("s", [17, 40])  # 17 is padded to the reduced hybrid's 16-token chunk
def test_prefill_and_decode_match(pair, s):
    cache = check_prefill_and_decode(pair, s)
    cfg = pair[0]
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.attn_every
        assert cache["k"].shape == (sites, 2, 64, cfg.num_kv_heads, cfg.resolved_head_dim)
        assert cache["ssm"]["state"].shape[0] == cfg.num_layers
    else:  # the patch prefix extends the cached sequence: max_len grows by it
        assert cache["k"].shape[2] == 64 + cfg.num_patches
    assert int(cache["pos"]) == s + (cfg.num_patches if cfg.family == "vlm" else 0) + 3


def test_prefill_equals_shorter_prefill_and_decode(pair):
    check_prefill_equals_shorter_prefill_and_decode(pair)


def test_serve_engine_same_tokens_and_cache_stats(pair):
    check_serve(pair)


def test_hybrid_tree_loads_with_nothing_missing_or_left_over(hybrid):
    """``shared_block/...`` maps by its path; one leaf too few or too many is refused."""
    cfg, params, jcfg, jparams = hybrid
    tree = jax.tree.map(np.asarray, jparams)
    assert sorted(tree["shared_block"]) == ["attn", "ln1", "ln2", "mlp"]
    np.testing.assert_array_equal(params.shared_block.attn.wq.detach().numpy(), tree["shared_block"]["attn"]["wq"])
    np.testing.assert_array_equal(params.layers[3].ssm.wz.detach().numpy(), tree["layers"]["ssm"]["wz"][3])
    assert not hasattr(params.layers[0], "attn")  # the attention lives in the shared block only
    fresh = get_model(cfg).init_params(cfg, device="cpu")
    missing = {**tree, "shared_block": {k: v for k, v in tree["shared_block"].items() if k != "ln2"}}
    with pytest.raises(ValueError, match=r"missing \['shared_block.ln2.scale'\]"):
        load_jax_params(fresh, missing)
    extra = {**tree, "shared_block": {**tree["shared_block"], "ln3": {"scale": tree["final_norm"]["scale"]}}}
    with pytest.raises(ValueError, match=r"left over \['shared_block.ln3.scale'\]"):
        load_jax_params(fresh, extra)


def test_hybrid_sites_share_weights_not_caches(hybrid):
    """Both sites run the one shared block, each against its own K/V rows."""
    cfg, params, _, _ = hybrid
    batch = {"tokens": torch.from_numpy(tokens(2, 12, cfg.vocab_size, seed=9))}
    _, cache = get_model(cfg).prefill(cfg, params, batch, 16)
    assert cache["k"].shape[0] == 2
    assert not torch.allclose(cache["k"][0, :, :12], cache["k"][1, :, :12])
    assert torch.all(cache["k"][:, :, 12:] == 0)


def test_vlm_patch_prefix_is_sliced_off_the_logits():
    """forward returns logits over the token positions only, and they depend on the patches."""
    cfg, params, _, _ = build("internvl2-26b")
    m = get_model(cfg)
    toks = torch.from_numpy(tokens(2, 10, cfg.vocab_size, seed=2))
    patches = torch.from_numpy(np.random.default_rng(2).standard_normal((2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    with_patches, _ = m.forward(cfg, params, {"tokens": toks, "patch_embeds": patches})
    without, _ = m.forward(cfg, params, {"tokens": toks})
    assert with_patches.shape == without.shape == (2, 10, cfg.vocab_size)
    assert not torch.allclose(with_patches, without)


def test_serve_engine_refuses_past_max_len_but_not_for_the_patch_prefix():
    """The hybrid keeps a positional K/V cache, so a request needing max_len + 1
    positions is refused before admission; the vlm's 8 patches do not count,
    as prefill grows its cache by them: 40 + 25 - 1 = 64 positions is served
    with the reference's tokens."""
    cfg, params, _, _ = build("zamba2-2.7b")
    prompts = tokens(2, 40, cfg.vocab_size, seed=13)
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu")
    over = [Request(i, torch.from_numpy(p), max_new_tokens=26) for i, p in enumerate(prompts)]
    with pytest.raises(ValueError, match="needs 65 cache positions.*max_len=64"):
        eng.run_batch(over)
    assert eng.cache_mgr.stats()["active"] == 0

    vcfg, vparams, jcfg, jparams = build("internvl2-26b")
    done = ServeEngine(vcfg, vparams, max_len=64, batch_size=2, device="cpu").run_batch(
        [Request(i, torch.from_numpy(p), max_new_tokens=25) for i, p in enumerate(prompts)])
    jdone = JaxServeEngine(jcfg, jparams, max_len=64, batch_size=2).run_batch(
        [JaxRequest(i, jnp.asarray(p), max_new_tokens=25) for i, p in enumerate(prompts)])
    assert [r.output for r in done] == [r.output for r in jdone]
    assert all(len(r.output) == 25 for r in done)


def test_hybrid_flash_sites_count_kernel_calls(hybrid, monkeypatch):
    """forward with flash reaches the flash entry point once per site, never in prefill or decode."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg, params, _, _ = hybrid
    calls = []
    real = fa_ops.flash_attention
    monkeypatch.setattr(fa_ops, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    fcfg = dataclasses.replace(cfg, attention_impl="flash")
    m = get_model(fcfg)
    batch = {"tokens": torch.from_numpy(tokens(2, 20, cfg.vocab_size, seed=4))}
    m.forward(fcfg, params, batch)
    assert len(calls) == cfg.num_layers // cfg.attn_every
    _, cache = m.prefill(fcfg, params, batch, 32)
    m.decode_step(fcfg, params, cache, batch["tokens"][:, -1:])
    assert len(calls) == cfg.num_layers // cfg.attn_every


def test_perturbation_reaches_the_shared_block(hybrid):
    cfg, params, _, _ = hybrid
    sb = params.shared_block
    for t in (sb.ln1.scale, sb.ln2.scale, params.layers[0].ssm.dt_bias, params.layers[0].ssm.d_skip):
        assert not (torch.all(t == 0) or torch.all(t == 1))
