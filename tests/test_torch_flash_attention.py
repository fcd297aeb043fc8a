"""The port's flash-attention plain version against the JAX package's kernel, on the CPU.

The same inputs, made with numpy from a seed, go through the port's
``ref.py``, the Pallas kernel in interpret mode and the reference's oracle,
at the bars of the reference's own kernel tests: 2e-5 in float32, 2e-2 in
bfloat16 (abs and rel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, s, h, kh, d, seed, dtype="float32"):
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
    jx = [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref, tol):
    np.testing.assert_allclose(_f32(port), _f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "b,s,h,kh,d,bq,bk",
    [
        (1, 128, 4, 2, 32, 64, 64),
        (2, 256, 8, 2, 64, 128, 128),
        (1, 256, 4, 4, 32, 64, 128),   # MHA
        (1, 512, 2, 1, 64, 128, 256),  # MQA, rectangular blocks
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_and_jax_ref(b, s, h, kh, d, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, s, h, kh, d, b * s + h, dtype)
    out = flash_attention_ref(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, interpret=True), TOL[dtype])
    _close(out, jax_ref(jq, jk, jv), TOL[dtype])


@pytest.mark.parametrize("window", [32, 1, 200])
def test_ref_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 128, 4, 2, 32, 0)
    out = flash_attention_ref(q, k, v, window=window)
    _close(out, flash_attention_pallas(jq, jk, jv, block_q=64, block_k=64, window=window, interpret=True), 2e-5)
    _close(out, jax_ref(jq, jk, jv, window=window), 2e-5)


def test_ref_is_causal():
    """Future tokens must not affect earlier outputs: perturb the tail, check the head."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 128, 2, 2, 32, 1)
    out1 = flash_attention_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = flash_attention_ref(q, k2, v2)
    np.testing.assert_allclose(out1[:, :100].numpy(), out2[:, :100].numpy(), atol=1e-6)
    pallas2 = flash_attention_pallas(jq, jnp.asarray(k2.numpy()), jnp.asarray(v2.numpy()),
                                     block_q=64, block_k=64, interpret=True)
    _close(out2, pallas2, 2e-5)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_ref_ragged_sequence(s):
    """The card kernel takes any S; its plain version does too (the Pallas kernel does not)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, s, 4, 2, 16, s)
    _close(flash_attention_ref(q, k, v), jax_ref(jq, jk, jv), 2e-5)


def test_ops_on_cpu_runs_the_plain_version():
    _, (q, k, v) = _inputs(1, 64, 4, 2, 32, 3)
    before = ops.LAUNCHES
    assert torch.equal(ops.flash_attention(q, k, v, window=16), flash_attention_ref(q, k, v, window=16))
    assert ops.LAUNCHES == before  # no kernel launched


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(1, 64, 4, 2, 32, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v)
