"""The port's MoE family (deepseek-moe-16b, qwen3-moe-30b-a3b) against the JAX
package's, on the CPU.

Reduced configs: 2 layers, d 64, 8 experts of width 32 (deepseek: and one
shared expert), top-2 routing; qwen3-moe keeps its q/k norms.  Built by the
reference from PRNGKey(0), constant leaves perturbed, converted by
``load_jax_params``; 1e-4 abs and rel (``torch_parity``).  The aux loss
(Switch-style load balancing, summed over layers) is held to the
reference's, and so are the capacity drop and the slot order it depends on.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.models import moe
from torch_parity import (
    build,
    check_forward,
    check_loss,
    check_prefill_and_decode,
    check_prefill_equals_shorter_prefill_and_decode,
    check_serve,
    close,
)

ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return build(request.param)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_and_aux_match(pair, impl):
    aux = check_forward(pair, impl)
    assert float(aux.detach()) > 0.0  # both layers' load-balancing losses, summed


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_fn_matches(pair, impl):
    check_loss(pair, impl)


@pytest.mark.parametrize("s", [17, 40])
def test_prefill_and_decode_match(pair, s):
    check_prefill_and_decode(pair, s)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_equals_shorter_prefill_and_decode(name):
    """Only where no pair is dropped: capacity is set per dispatch group (a
    prompt's row in prefill, one token in decode), so with drops the two
    routes differ in the reference too.  capacity_factor = E / K gives every
    expert room for all S tokens."""
    cfg = PORT_ARCHS[name].reduced()
    check_prefill_equals_shorter_prefill_and_decode(build(name, capacity_factor=cfg.num_experts / cfg.top_k))


def test_serve_engine_same_tokens_and_cache_stats(pair):
    check_serve(pair)


def _routing_drops(cfg, x, router):
    """(B, S*K) pairs past their expert's capacity, from the routing alone."""
    probs = torch.softmax(x @ router, dim=-1)
    topi = torch.topk(probs, cfg.top_k, dim=-1).indices.reshape(x.shape[0], -1)
    load = torch.stack([torch.bincount(row, minlength=cfg.num_experts) for row in topi])
    return int((load - moe.capacity(cfg, x.shape[1])).clamp(min=0).sum())


@pytest.mark.parametrize("capacity_factor", [1.25, 100.0], ids=["drops", "no_drop"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_with_and_without_capacity_drops(name, capacity_factor):
    """At S=40 the default capacity (12 slots of 80 (token, k) pairs over 8
    experts) drops pairs; at capacity_factor=100 none is dropped."""
    cfg, params, jcfg, jparams = build(name, capacity_factor=capacity_factor)
    x = np.random.default_rng(5).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    p, jp = params.layers[0].moe, jparams["layers"]["moe"]
    jp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()}) for k, v in jp.items()}
    out, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
    jout, jaux = jax_moe.moe_apply(jcfg, jp, jnp.asarray(x))
    assert moe.capacity(cfg, 40) == jax_moe.capacity(jcfg, 40)
    drops = _routing_drops(cfg, torch.from_numpy(x), p.router)
    assert (drops > 0) == (capacity_factor == 1.25), drops
    close(out, jout)
    close(aux, jaux)


def test_capacity_matches_reference():
    cfg, _, jcfg, _ = build("deepseek-moe-16b")
    for s in (1, 7, 16, 40, 1024):
        for cf in (0.5, 1.25, 2.0):
            c, jc = (dataclasses.replace(x, capacity_factor=cf) for x in (cfg, jcfg))
            assert moe.capacity(c, s) == jax_moe.capacity(jc, s)
