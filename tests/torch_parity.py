"""Helpers for the tests that hold the port's models to the JAX package's on the CPU.

Each reduced config is built by the reference from PRNGKey(0).  Every leaf
that the reference initialises to all zeros or all ones (biases, norm
scales) is then moved off that value with seeded noise, so that those
leaves take part.  Both packages get that same numpy tree, and the same
tokens and stub-frontend inputs (the vlm's patch embeddings, the encdec's
frame embeddings), made with numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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


def perturbed_tree(jparams, seed=0):
    """The reference's params as numpy, with constant-initialised leaves perturbed."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if np.all(a == 0) or np.all(a == 1):
            a = a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(move, jparams)


def build(name, **changes):
    """(cfg, params, jcfg, jparams): the port's module loaded from the reference's perturbed tree."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), **changes)
    tree = perturbed_tree(jax_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    params = get_model(cfg).init_params(cfg, device="cpu")
    load_jax_params(params, tree)
    return cfg, params, jcfg, jax.tree.map(jnp.asarray, tree)


def tokens(batch, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, s)).astype(np.int32)


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def close_tree(port, ref):
    """Every leaf of a cache: the same keys, shapes and values."""
    assert isinstance(port, dict) and sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    for key, val in port.items():
        if isinstance(val, dict):
            close_tree(val, ref[key])
        else:
            assert tuple(val.shape) == tuple(ref[key].shape), key
            close(val, ref[key])


def batches(cfg, toks, seed=0):
    """The same batch for both packages: tokens, plus the stub frontend's embeddings."""
    extra = {}
    r = np.random.default_rng(seed + 1000)
    if cfg.family == "vlm":
        extra["patch_embeds"] = r.standard_normal((toks.shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frame_embeds"] = r.standard_normal((toks.shape[0], cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    port = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in extra.items()}}
    ref = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    return port, ref


def check_forward(pair, impl, s=40, seed=0):
    """forward's logits and aux loss equal the reference's; returns the port's aux."""
    cfg, params, jcfg, jparams = pair
    cfg, jcfg = (dataclasses.replace(c, attention_impl=impl) for c in (cfg, jcfg))
    batch, jbatch = batches(cfg, tokens(2, s, cfg.vocab_size, seed), seed)
    logits, aux = get_model(cfg).forward(cfg, params, batch)
    jlogits, jaux = jax_get_model(jcfg).forward(jcfg, jparams, jbatch)
    assert logits.shape == (2, s, cfg.vocab_size) and aux.shape == () and aux.dtype == torch.float32
    close(logits, jlogits)
    close(aux, jaux)
    return aux


def check_loss(pair, impl, s=33, seed=3):
    cfg, params, jcfg, jparams = pair
    cfg, jcfg = (dataclasses.replace(c, attention_impl=impl) for c in (cfg, jcfg))
    toks = tokens(2, s, cfg.vocab_size, seed)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    batch, jbatch = batches(cfg, toks, seed)
    batch["labels"], jbatch["labels"] = torch.from_numpy(labels), jnp.asarray(labels)
    loss = get_model(cfg).loss_fn(cfg, params, batch)
    jloss = jax_get_model(jcfg).loss_fn(jcfg, jparams, jbatch)
    assert loss.shape == () and np.isfinite(float(loss.detach()))
    close(loss, jloss)


def check_prefill_and_decode(pair, s, max_len=64, steps=3):
    """prefill, then ``steps`` greedy decode steps: logits and every cache leaf equal."""
    cfg, params, jcfg, jparams = pair
    m, jm = get_model(cfg), jax_get_model(jcfg)
    batch, jbatch = batches(cfg, tokens(2, s, cfg.vocab_size, seed=s), seed=s)
    logits, cache = m.prefill(cfg, params, batch, max_len)
    jlogits, jcache = jm.prefill(jcfg, jparams, jbatch, max_len)
    close(logits, jlogits)
    close_tree(cache, jcache)
    for step in range(steps):
        tok = np.argmax(np.asarray(jlogits[:, -1]), axis=-1).astype(np.int32)[:, None]
        logits, cache = m.decode_step(cfg, params, cache, torch.from_numpy(tok))
        jlogits, jcache = jm.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        close(logits, jlogits)
        close_tree(cache, jcache)
    return cache


def check_prefill_equals_shorter_prefill_and_decode(pair, s=24, max_len=32):
    """prefill(S) against prefill(S-1) + decode_step, in the port alone; the
    input cache of decode_step is left as it was."""
    cfg, params, _, _ = pair
    m = get_model(cfg)
    batch, _ = batches(cfg, tokens(2, s, cfg.vocab_size, seed=5), seed=5)
    full, cache_full = m.prefill(cfg, params, batch, max_len)
    _, cache = m.prefill(cfg, params, {**batch, "tokens": batch["tokens"][:, :-1]}, max_len)
    before = {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}
    dec, cache_dec = m.decode_step(cfg, params, cache, batch["tokens"][:, -1:])
    torch.testing.assert_close(dec, full, atol=TOL, rtol=TOL)
    for key in ("k", "v", "cross_k", "cross_v"):
        if key in cache_full:
            torch.testing.assert_close(cache_dec[key], cache_full[key], atol=TOL, rtol=TOL)
    if "ssm" in cache_full:
        for key in ("state", "conv"):
            torch.testing.assert_close(cache_dec["ssm"][key], cache_full["ssm"][key], atol=TOL, rtol=TOL)
    assert all(torch.equal(cache[k], v) for k, v in before.items())


def check_serve(pair, max_len=64, new_tokens=6):
    """Two rounds through both engines: the same greedy tokens and cache stats."""
    cfg, params, jcfg, jparams = pair
    prompts = tokens(2, 40, cfg.vocab_size, seed=7)
    eng = ServeEngine(cfg, params, max_len=max_len, batch_size=2, device="cpu")
    jeng = JaxServeEngine(jcfg, jparams, max_len=max_len, batch_size=2)
    for round_ in range(2):  # the second round reuses the released cache slots
        done = eng.run_batch(
            [Request(10 * round_ + i, torch.from_numpy(p), max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
        )
        jdone = jeng.run_batch(
            [JaxRequest(10 * round_ + i, jnp.asarray(p), max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
        )
        assert [r.output for r in done] == [r.output for r in jdone]
        assert all(len(r.output) == new_tokens for r in done)
        assert eng.cache_mgr.stats() == jeng.cache_mgr.stats()
        assert eng.cache_mgr.stats()["active"] == 0


RANK_PREAMBLE = """
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=sys.argv[4], rank=rank, world_size=world)
"""
RANK_EPILOGUE = """
torch.save(result, f"{out}/rank{rank}.pt")
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, tmp_path, timeout: float = 300) -> list:
    """Run ``code`` in ``world`` processes of one gloo group, which meet through a
    file in ``tmp_path`` (no port).  ``code`` sees ``rank``, ``world`` and ``dist``
    and sets ``result``; returns each rank's ``result``.  Each process runs one
    thread: the CPU's threaded reductions are not bitwise reproducible from one
    process to the next."""
    import os
    import subprocess
    import sys
    import textwrap
    import time
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src), "OMP_NUM_THREADS": "1"}
    script = RANK_PREAMBLE + textwrap.dedent(code) + RANK_EPILOGUE
    init = f"file://{tmp_path}/rendezvous"
    logs = [open(f"{tmp_path}/rank{r}.err", "w") for r in range(world)]  # a pipe could fill and block a rank
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(tmp_path), init],
                              stdout=subprocess.DEVNULL, stderr=log, env=env)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:  # a failed rank leaves the others waiting in a collective: stop them all
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    errs = [Path(f"{tmp_path}/rank{r}.err").read_text() for r in range(world)]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-2000:] for e in errs)
    return [torch.load(f"{tmp_path}/rank{r}.pt", weights_only=False) for r in range(world)]
