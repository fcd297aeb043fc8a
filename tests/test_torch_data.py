"""The port's data pipeline against the JAX package's: ``host_batch`` gives
byte-identical numpy arrays for every arch (the vlm's patch and the encdec's
frame stubs included), and ``batch_struct`` meta tensors of the reference's
shapes and dtypes."""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import batch_struct as jax_batch_struct
from repro.data.pipeline import host_batch as jax_host_batch
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, batch_struct, host_batch

DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("step,host_id,num_hosts", [(0, 0, 1), (7, 1, 2), (3, 3, 4)])
def test_host_batch_byte_identical(name, step, host_id, num_hosts):
    cfg, jcfg = ARCHS[name].reduced(), JAX_ARCHS[name].reduced()
    got = host_batch(cfg, DataConfig(seq_len=20, global_batch=8, seed=5), step, host_id, num_hosts)
    ref = jax_host_batch(jcfg, JaxDataConfig(seq_len=20, global_batch=8, seed=5), step, host_id, num_hosts)
    assert list(got) == list(ref)
    for key, arr in got.items():
        assert isinstance(arr, np.ndarray) and arr.dtype == ref[key].dtype and arr.shape == ref[key].shape
        assert arr.tobytes() == ref[key].tobytes(), key
    assert got["tokens"].shape == (8 // num_hosts, 20)
    assert ("patch_embeds" in got) == (cfg.family == "vlm") and ("frame_embeds" in got) == (cfg.family == "encdec")


def test_host_batch_is_deterministic_and_differs_by_step_and_host():
    cfg = ARCHS["qwen2.5-3b"].reduced()
    d = DataConfig(seq_len=16, global_batch=4, seed=0)
    assert host_batch(cfg, d, 3)["tokens"].tobytes() == host_batch(cfg, d, 3)["tokens"].tobytes()
    assert host_batch(cfg, d, 3)["tokens"].tobytes() != host_batch(cfg, d, 4)["tokens"].tobytes()
    assert host_batch(cfg, d, 3, 0, 2)["tokens"].tobytes() != host_batch(cfg, d, 3, 1, 2)["tokens"].tobytes()
    b = host_batch(cfg, d, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("name", ["qwen2.5-3b", "internvl2-26b", "whisper-medium"])  # plain, vlm, encdec
def test_batch_struct_matches_reference(name):
    got = batch_struct(ARCHS[name], 4096, 256)
    ref = jax_batch_struct(JAX_ARCHS[name], 4096, 256)
    assert list(got) == list(ref)
    for key, t in got.items():
        assert t.is_meta and tuple(t.shape) == ref[key].shape and t.dtype == DTYPES[np.dtype(ref[key].dtype)], key
