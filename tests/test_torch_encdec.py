"""The port's encoder-decoder family (whisper-medium) against the JAX package's, on the CPU.

Reduced config: 2 encoder and 2 decoder layers, d 64, 4 q heads over 2 kv
heads of dim 16, 32 encoder frames, the reference's 65,536 learned decoder
positions.  Built by the reference from PRNGKey(0), constant leaves (the
LayerNorm biases and scales, the GELU MLPs' ``bi``/``bo``) perturbed,
converted by ``load_jax_params``; 1e-4 abs and rel (``torch_parity``).  The
frame embeddings are seeded numpy, the same for both packages.  The family
never calls the flash kernel, in either package, so only the plain path is held.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch.models import encdec, layers
from torch_parity import (
    build,
    check_forward,
    check_loss,
    check_prefill_and_decode,
    check_prefill_equals_shorter_prefill_and_decode,
    check_serve,
    close,
)


@pytest.fixture(scope="module")
def pair():
    return build("whisper-medium")


def test_tree_maps_encoder_and_decoder_stacks(pair):
    cfg, params, _, jparams = pair
    assert len(params.enc_layers) == cfg.encoder_layers and len(params.dec_layers) == cfg.num_layers
    assert params.dec_pos.shape == (encdec.MAX_DECODER_POS, cfg.d_model) == tuple(jparams["dec_pos"].shape)
    np.testing.assert_array_equal(params.dec_layers[1].cross_attn.wk.detach().numpy(),
                                  np.asarray(jparams["dec_layers"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(params.enc_layers[0].mlp.bi.detach().numpy(), np.asarray(jparams["enc_layers"]["mlp"]["bi"][0]))
    for t in (params.enc_layers[0].ln1.bias, params.dec_layers[0].mlp.bo, params.dec_norm.scale):
        assert not (torch.all(t == 0) or torch.all(t == 1))  # the perturbation reached them


def test_forward_logits_match(pair):
    assert float(check_forward(pair, "xla")) == 0.0


def test_loss_fn_matches(pair):
    check_loss(pair, "xla")


@pytest.mark.parametrize("s", [17, 40])
def test_prefill_and_decode_match(pair, s):
    cache = check_prefill_and_decode(pair, s)
    cfg = pair[0]
    assert cache["cross_k"].shape == (cfg.num_layers, 2, cfg.encoder_frames, cfg.num_kv_heads, cfg.resolved_head_dim)


def test_prefill_equals_shorter_prefill_and_decode(pair):
    check_prefill_equals_shorter_prefill_and_decode(pair)


def test_serve_engine_same_tokens_and_cache_stats(pair):
    check_serve(pair)


def test_encode_matches(pair):
    cfg, params, jcfg, jparams = pair
    frames = np.random.default_rng(3).standard_normal((2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    close(encdec.encode(cfg, params, torch.from_numpy(frames)), jax_encdec.encode(jcfg, jparams, jnp.asarray(frames)))


# ------------------------------------------------------------ the new layers
def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_layernorm_matches():
    x = _x((2, 5, 48)) * 3 + 1
    p = layers.layernorm_init(48, torch.float32, "cpu")
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(_x(48, 1)))
        p.bias.copy_(torch.from_numpy(_x(48, 2)))
    jp = {"scale": jnp.asarray(p.scale.detach().numpy()), "bias": jnp.asarray(p.bias.detach().numpy())}
    close(layers.layernorm(p, torch.from_numpy(x), 1e-5), jax_layers.layernorm(jp, jnp.asarray(x), 1e-5))


def test_gelu_mlp_uses_the_tanh_gelu_of_the_reference():
    """jax.nn.gelu defaults to the tanh approximation; torch's F.gelu to erf."""
    p = layers.gelu_mlp_init(16, 40, torch.float32, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        p.bi.copy_(torch.from_numpy(_x(40, 3)))
        p.bo.copy_(torch.from_numpy(_x(16, 4)))
    jp = {k: jnp.asarray(getattr(p, k).detach().numpy()) for k in ("wi", "bi", "wo", "bo")}
    x = _x((2, 7, 16), 5) * 2
    out = layers.gelu_mlp(p, torch.from_numpy(x), "float32")
    close(out, jax_layers.gelu_mlp(jp, jnp.asarray(x), "float32"))
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ p.wi + p.bi) @ p.wo + p.bo
    assert not torch.allclose(out, erf, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("length,dim", [(32, 64), (1500, 1024)])
def test_sinusoid_positions_match(length, dim):
    """At whisper's 1,500 frames the angles reach ~1,500 rad, where one float32
    ulp is 2^-13: the two libraries' exp and sin may differ in the last bit of
    an angle, so the bar is 2 ulps of the largest angle, or 1e-4 if larger."""
    atol = max(1e-4, 2 * float(np.spacing(np.float32(length))))
    np.testing.assert_allclose(layers.sinusoid_positions(length, dim, "cpu").numpy(),
                               np.asarray(jax_layers.sinusoid_positions(length, dim)), atol=atol, rtol=1e-4)


def test_cross_attention_matches(pair):
    cfg, params, jcfg, jparams = pair
    p = params.dec_layers[0].cross_attn
    jp = {k: jnp.asarray(getattr(p, k).detach().numpy()) for k in ("wq", "wk", "wv", "wo")}
    x = _x((2, 9, cfg.d_model), 6)
    k = _x((2, cfg.encoder_frames, cfg.num_kv_heads, cfg.resolved_head_dim), 7)
    v = _x((2, cfg.encoder_frames, cfg.num_kv_heads, cfg.resolved_head_dim), 8)
    out = layers.cross_attention(cfg, p, torch.from_numpy(x), (torch.from_numpy(k), torch.from_numpy(v)))
    close(out, jax_layers.cross_attention(jcfg, jp, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v))))
