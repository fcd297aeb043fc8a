"""The port's mamba2 serving path against the JAX package's, on the CPU.

The reduced mamba2-780m (2 layers, d 64, N 16, chunk 16, float32) is built
by the reference from PRNGKey(0) and carried into the port through
``convert.load_jax_params``; both then see the same prompts.
"""
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


@pytest.fixture(scope="module")
def pair():
    cfg = ARCHS["mamba2-780m"].reduced()
    jcfg = JAX_ARCHS["mamba2-780m"].reduced()
    jparams = jax_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    params = get_model(cfg).init_params(cfg, device="cpu")
    load_jax_params(params, jax.tree.map(np.asarray, jparams))
    return cfg, params, jcfg, jparams


def _prompts(batch, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, s)).astype(np.int32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [40, 48])  # 40 is padded to the 16-token chunk
def test_forward_logits_match(pair, s):
    cfg, params, jcfg, jparams = pair
    tokens = _prompts(2, s, cfg.vocab_size)
    logits, aux = get_model(cfg).forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jlogits, _ = jax_get_model(jcfg).forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    assert logits.shape == (2, s, cfg.vocab_size) and float(aux) == 0.0
    _close(logits, jlogits)


@pytest.mark.parametrize("s", [40, 48])
def test_prefill_and_decode_match(pair, s):
    cfg, params, jcfg, jparams = pair
    m, jm = get_model(cfg), jax_get_model(jcfg)
    tokens = _prompts(2, s, cfg.vocab_size, seed=s)
    logits, cache = m.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, 64)
    jlogits, jcache = jm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, 64)
    _close(logits, jlogits)
    for key in ("state", "conv"):
        assert cache["ssm"][key].dtype == torch.float32  # the reduced config computes in f32
        _close(cache["ssm"][key], jcache["ssm"][key])
    assert int(cache["pos"]) == int(jcache["pos"]) == s
    for step in range(3):
        tok = np.argmax(np.asarray(jlogits[:, -1]), axis=-1).astype(np.int32)[:, None]
        logits, cache = m.decode_step(cfg, params, cache, torch.from_numpy(tok))
        jlogits, jcache = jm.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        _close(logits, jlogits)
        _close(cache["ssm"]["state"], jcache["ssm"]["state"])
        _close(cache["ssm"]["conv"], jcache["ssm"]["conv"])
        assert int(cache["pos"]) == int(jcache["pos"]) == s + step + 1


def test_serve_engine_same_tokens_and_cache_stats(pair):
    cfg, params, jcfg, jparams = pair
    prompts = _prompts(2, 40, cfg.vocab_size, seed=7)
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


def test_load_jax_params_rejects_missing_and_misshapen_leaves(pair):
    cfg, params, _, jparams = pair
    tree = jax.tree.map(np.asarray, jparams)
    fresh = get_model(cfg).init_params(cfg, device="cpu")
    broken = {**tree, "final_norm": {}}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(fresh, broken)
    extra = {**tree, "shared_block": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="left over"):
        load_jax_params(fresh, extra)
    bad = {**tree, "final_norm": {"scale": np.ones(cfg.d_model + 1, np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(fresh, bad)
