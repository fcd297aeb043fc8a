"""The falcon-h1-34b-instruct configuration holds the port to its plain reference (CPU, float32): the
reduced model serves as the reference computes, and the published specs attach to the port."""
import dataclasses
import json

import torch

from bench.harness import program
from bench.harness import weights as wmod
from bench.harness.env import BENCH
from bench.reference import falcon_h1_lm as ref
from repro_torch.models import get_model

CPU = torch.device("cpu")


def _configured():
    return program.arch_config(json.loads((BENCH / "configs" / "falcon-h1-34b-instruct.json").read_text())["arch"])


def _reduced():
    cfg = _configured().reduced()
    return cfg, dataclasses.asdict(cfg)


def test_logits_match_the_port():
    cfg, arch = _reduced()
    params = program.build(cfg, ref, arch, seed=5, device=CPU)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = get_model(cfg).forward(cfg, params, {"tokens": tokens})
    want = ref.next_token_logits(arch, program.reference_weights(ref, arch, 5, CPU), tokens, 0)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_match_the_full_sequence():
    cfg, arch = _reduced()
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


def test_the_published_specs_attach_to_the_port():
    """At full width and stage 0's depth, on the ``meta`` device: every name, shape and dtype of the
    reference's ``param_specs`` is a parameter of the program's model, and no other."""
    cfg = _configured()
    specs = ref.param_specs(dataclasses.asdict(cfg))
    model = get_model(cfg).init_params(cfg, torch.Generator(), device="meta")
    wmod.attach(model, {n: torch.empty(shape, dtype=torch.bfloat16, device="meta") for n, shape, _ in specs})
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == 10_416_034_496
