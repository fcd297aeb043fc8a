"""The plain reference computes what the port computes, on the port's reduced configs (CPU, float32)."""
import dataclasses

import pytest
import torch

from bench.harness import program
from bench.harness import weights as wmod
from bench.reference import mamba2_lm as ref
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_fn

CPU = torch.device("cpu")
ARCH_NAMES = ["mamba2-780m"]


def reduced(name):
    cfg = ARCHS[name].reduced()
    return cfg, dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_logits_match_the_port(name):
    cfg, arch = reduced(name)
    params = program.build(cfg, ref, arch, seed=5, device=CPU)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = get_model(cfg).forward(cfg, params, {"tokens": tokens})
    want = ref.next_token_logits(arch, program.reference_weights(ref, arch, 5, CPU), tokens, 0)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_the_full_sequence(name):
    cfg, arch = reduced(name)
    params = program.build(cfg, ref, arch, seed=6, device=CPU)
    m = get_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    logits, cache = m.prefill(cfg, params, {"tokens": tokens[:, :20]}, 32)
    got = [logits[:, -1]]
    for t in range(20, 23):
        logits, cache = m.decode_step(cfg, params, cache, tokens[:, t:t + 1])
        got.append(logits[:, -1])
    want = ref.next_token_logits(arch, program.reference_weights(ref, arch, 6, CPU), tokens[:, :23], 19)
    torch.testing.assert_close(torch.stack(got, dim=1), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_steps_match_the_port(name):
    cfg, arch = reduced(name)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    params = program.build(cfg, ref, arch, seed=7, device=CPU)
    opt = adamw.init(params)
    step = make_train_fn(cfg, ocfg)
    w = program.reference_weights(ref, arch, 7, CPU)
    for t in w.values():
        t.requires_grad_(True)
    state = {}
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        rows = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        _, _, metrics = step(params, opt, batch)
        loss = ref.loss(arch, w, batch["tokens"], batch["labels"], row_block=16)
        grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
        ref.adamw_step(dataclasses.asdict(ocfg), w, grads, state)
        torch.testing.assert_close(metrics["loss"], loss.detach(), atol=1e-5, rtol=1e-5)
    for n, p in params.named_parameters():
        torch.testing.assert_close(p.detach(), w[n].detach(), atol=1e-5, rtol=1e-5)


def test_weights_follow_the_seed_and_the_layout():
    cfg, arch = reduced("mamba2-780m")
    specs = ref.param_specs(arch)
    a = wmod.make(specs, 2**33 + 1, CPU, torch.float32, ref.const_value)
    b = wmod.make(specs, 2**33 + 1, CPU, torch.float32, ref.const_value)
    c = wmod.make(specs, 2**33 + 2, CPU, torch.float32, ref.const_value)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.0.ssm.wz"], c["layers.0.ssm.wz"])
    for name, shape, init in specs:
        t = a[name]
        assert tuple(t.shape) == shape
        if init[0] == "normal" and t.numel() > 1000:
            assert abs(t.std().item() / init[1] - 1) < 0.1
    built = get_model(cfg).init_params(cfg, torch.Generator(), device="meta")
    assert {n: tuple(p.shape) for n, p in built.named_parameters()} == {n: s for n, s, _ in specs}
