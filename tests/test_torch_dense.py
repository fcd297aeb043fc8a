"""The port's dense family against the JAX package's, on the CPU.

Each reduced dense config (2 layers, d 64, 4 q heads over 2 kv heads of dim
16, float32) is built by the reference from PRNGKey(0).  Every leaf that the
reference initialises to all zeros or all ones (the qkv biases, the norm
scales) is then moved off that value with seeded noise, so that the biases of
qwen2.5-3b and the q/k norms of qwen3-8b take part.  Both packages get that
same numpy tree and see the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS
from repro_torch.convert import load_jax_params
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-4
DENSE = ["qwen2.5-3b", "qwen3-8b", "phi3-medium-14b", "yi-34b"]


def _perturbed_tree(jparams, seed=0):
    """The reference's params as numpy, with constant-initialised leaves perturbed."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if np.all(a == 0) or np.all(a == 1):
            a = a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(move, jparams)


def _build(name, **changes):
    cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), **changes)
    tree = _perturbed_tree(jax_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    params = get_model(cfg).init_params(cfg, device="cpu")
    load_jax_params(params, tree)
    return cfg, params, jcfg, jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return _build(request.param)


def _tokens(batch, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, s)).astype(np.int32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_perturbation_reaches_bias_and_norm_leaves(pair):
    cfg, params, _, _ = pair
    lp = params.layers[0]
    moved = [lp.ln1.scale, lp.ln2.scale, params.final_norm.scale]
    if cfg.qkv_bias:
        moved += [lp.attn.bq, lp.attn.bk, lp.attn.bv]
    if cfg.qk_norm:
        moved += [lp.attn.q_norm.scale, lp.attn.k_norm.scale]
    for t in moved:
        assert not (torch.all(t == 0) or torch.all(t == 1))
    assert (params.embedding.unembed is None) == cfg.tie_embeddings


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match(pair, impl):
    cfg, params, jcfg, jparams = pair
    cfg, jcfg = (dataclasses.replace(c, attention_impl=impl) for c in (cfg, jcfg))
    tokens = _tokens(2, 40, cfg.vocab_size)
    logits, aux = get_model(cfg).forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jlogits, jaux = jax_get_model(jcfg).forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    assert logits.shape == (2, 40, cfg.vocab_size) and float(aux) == float(jaux) == 0.0
    _close(logits, jlogits)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_fn_matches(pair, impl):
    cfg, params, jcfg, jparams = pair
    cfg, jcfg = (dataclasses.replace(c, attention_impl=impl) for c in (cfg, jcfg))
    tokens = _tokens(2, 33, cfg.vocab_size, seed=3)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    loss = get_model(cfg).loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    jloss = jax_get_model(jcfg).loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    assert loss.shape == () and np.isfinite(float(loss))
    _close(loss, jloss)


@pytest.mark.parametrize("s", [17, 40])
def test_prefill_and_decode_match(pair, s):
    cfg, params, jcfg, jparams = pair
    m, jm = get_model(cfg), jax_get_model(jcfg)
    tokens = _tokens(2, s, cfg.vocab_size, seed=s)
    logits, cache = m.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, 64)
    jlogits, jcache = jm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, 64)
    _close(logits, jlogits)
    assert cache["k"].shape == (cfg.num_layers, 2, 64, cfg.num_kv_heads, cfg.resolved_head_dim)
    for key in ("k", "v"):
        assert cache[key].dtype == torch.float32  # the reduced config computes in f32
        _close(cache[key], jcache[key])
    assert int(cache["pos"]) == int(jcache["pos"]) == s
    for step in range(3):
        tok = np.argmax(np.asarray(jlogits[:, -1]), axis=-1).astype(np.int32)[:, None]
        logits, cache = m.decode_step(cfg, params, cache, torch.from_numpy(tok))
        jlogits, jcache = jm.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        _close(logits, jlogits)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])
        assert int(cache["pos"]) == int(jcache["pos"]) == s + step + 1


def test_prefill_equals_shorter_prefill_and_decode(pair):
    cfg, params, _, _ = pair
    m = get_model(cfg)
    tokens = torch.from_numpy(_tokens(2, 24, cfg.vocab_size, seed=5))
    full, cache_full = m.prefill(cfg, params, {"tokens": tokens}, 32)
    _, cache = m.prefill(cfg, params, {"tokens": tokens[:, :-1]}, 32)
    before = cache["k"].clone()
    dec, cache_dec = m.decode_step(cfg, params, cache, tokens[:, -1:])
    torch.testing.assert_close(dec, full, atol=TOL, rtol=TOL)
    torch.testing.assert_close(cache_dec["k"], cache_full["k"], atol=TOL, rtol=TOL)
    torch.testing.assert_close(cache_dec["v"], cache_full["v"], atol=TOL, rtol=TOL)
    assert torch.equal(cache["k"], before)  # decode_step leaves its input cache as it was


def test_serve_engine_same_tokens_and_cache_stats(pair):
    cfg, params, jcfg, jparams = pair
    prompts = _tokens(2, 40, cfg.vocab_size, seed=7)
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu")
    jeng = JaxServeEngine(jcfg, jparams, max_len=64, batch_size=2)
    for round_ in range(2):  # the second round reuses the released cache slots
        done = eng.run_batch(
            [Request(10 * round_ + i, torch.from_numpy(p), max_new_tokens=6) for i, p in enumerate(prompts)]
        )
        jdone = jeng.run_batch(
            [JaxRequest(10 * round_ + i, jnp.asarray(p), max_new_tokens=6) for i, p in enumerate(prompts)]
        )
        assert [r.output for r in done] == [r.output for r in jdone]
        assert all(len(r.output) == 6 for r in done)
        assert eng.cache_mgr.stats() == jeng.cache_mgr.stats()
        assert eng.cache_mgr.stats()["active"] == 0


@pytest.mark.parametrize(
    "changes",
    [{"sliding_window": 8}, {"num_heads": 6, "orig_num_heads": 4}],
    ids=["sliding_window", "padded_heads"],
)
def test_window_and_padded_heads_match(changes):
    """The plain path honours the window and kv_head_map under padded q heads."""
    cfg, params, jcfg, jparams = _build("qwen2.5-3b", **changes)
    m, jm = get_model(cfg), jax_get_model(jcfg)
    tokens = _tokens(2, 24, cfg.vocab_size, seed=11)
    logits, _ = m.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jlogits, _ = jm.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits)
    if "sliding_window" in changes:
        flash = dataclasses.replace(cfg, attention_impl="flash")
        _close(m.forward(flash, params, {"tokens": torch.from_numpy(tokens)})[0], jlogits)
    logits, cache = m.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, 32)
    jlogits, jcache = jm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, 32)
    for _ in range(2):
        tok = np.argmax(np.asarray(jlogits[:, -1]), axis=-1).astype(np.int32)[:, None]
        logits, cache = m.decode_step(cfg, params, cache, torch.from_numpy(tok))
        jlogits, jcache = jm.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        _close(logits, jlogits)


@pytest.mark.parametrize(
    "h,kh,orig",
    [(16, 2, 0), (4, 2, 0), (64, 8, 56), (48, 10, 40), (6, 2, 4), (7, 7, 0)],
    ids=["qwen2.5-3b", "reduced", "yi-34b-padded", "phi3-padded", "reduced-padded", "mha"],
)
def test_kv_head_map_matches_reference(h, kh, orig):
    from repro.models.layers import kv_head_map as jax_kv_head_map
    from repro_torch.models.layers import kv_head_map

    np.testing.assert_array_equal(kv_head_map(h, kh, orig).numpy(), np.asarray(jax_kv_head_map(h, kh, orig)))


@pytest.mark.parametrize("changes", [{}, {"num_heads": 6, "orig_num_heads": 4}], ids=["plain", "padded_heads"])
def test_attention_keeps_its_kv_head_map(changes):
    """Each Attention holds kv_head_map as a buffer built once, outside the reference's leaves."""
    from repro_torch.models.layers import kv_head_map

    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"].reduced(), **changes)
    params = get_model(cfg).init_params(cfg, device="cpu")
    want = kv_head_map(cfg.num_heads, cfg.num_kv_heads, cfg.orig_num_heads)
    for lp in params.layers:
        assert torch.equal(lp.attn.kvm, want)
    assert not any(name.endswith("kvm") for name in params.state_dict())
    twin = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    twin.load_state_dict(params.state_dict())  # strict: the buffer needs no entry
    assert torch.equal(twin.layers[0].attn.kvm, want)


def test_serve_engine_refuses_requests_past_max_len():
    """A dense request that needs max_len + 1 cache positions is refused before
    any admission; one that needs exactly max_len is served as before, with the
    reference's tokens and the same tokens as with room to spare."""
    cfg, params, jcfg, jparams = _build("qwen2.5-3b")
    prompts = _tokens(2, 40, cfg.vocab_size, seed=13)
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu")
    over = [Request(0, torch.from_numpy(prompts[0]), max_new_tokens=24),
            Request(1, torch.from_numpy(prompts[1]), max_new_tokens=26)]  # 40 + 26 - 1 = 64 + 1
    with pytest.raises(ValueError, match="needs 65 cache positions.*max_len=64"):
        eng.run_batch(over)
    assert eng.cache_mgr.stats()["active"] == 0
    assert all(r.output == [] for r in over)

    def fits(engine, request_cls, to_tensor):  # 40 + 25 - 1 = 64 positions
        return [r.output for r in engine.run_batch(
            [request_cls(2 + i, to_tensor(p), max_new_tokens=25) for i, p in enumerate(prompts)])]

    at_limit = fits(ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu"), Request, torch.from_numpy)
    roomy = fits(ServeEngine(cfg, params, max_len=128, batch_size=2, device="cpu"), Request, torch.from_numpy)
    jax_tokens = fits(JaxServeEngine(jcfg, jparams, max_len=64, batch_size=2), JaxRequest, jnp.asarray)
    assert at_limit == roomy == jax_tokens
    assert all(len(out) == 25 for out in at_limit)
    assert fits(eng, Request, torch.from_numpy) == at_limit  # the refusal left the engine usable
    assert eng.cache_mgr.stats()["active"] == 0
