"""A run's ``correct`` on the CPU at a test size: true for the program as it is, false for the
control (the reference in float8) and for each fault a cell can have, planted under the timed
path.  The look for a card is skipped; the rest of a run is driven as ``bench/run.py`` drives it.
No cell runs across chips, so the fault of a left-out exchange between chips has no case."""
import time

import torch

import repro_torch.models.transformer as transformer
import repro_torch.train.step as step_mod
from bench import run as bench_run
from bench.harness import program, serve, train, traffic
from bench.tests import tiny

CPU = torch.device("cpu")


def _line(cell, run):
    return bench_run.result(cell, run, False, {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})


def _serve(cell, seed=11):
    run = serve.run(cell, seed, 0.0, False, "cpu", time.time())
    return run, _line(cell, run)


def _train(cell, seed=12):
    run = train.run(cell, seed, 0.0, False, "cpu", time.time())
    return run, _line(cell, run)


def test_a_sound_serving_run_is_correct():
    run, line = _serve(tiny.serve_cell())
    assert line["correct"] is True and line["failed"] == 0 and list(line["checks"]) == ["logit_gap"]
    served = sum(len(tokens) for _, tokens in run.served)
    assert run.info["checked"]["positions"] >= min(served, serve.MIN_CHECKED_TOKENS)
    assert set(line["metrics"]) == {"setup_s"} and list(line)[-1] == "checks"


def test_a_sound_training_run_is_correct():
    _, line = _train(tiny.train_cell())
    assert line["correct"] is True and set(line["checks"]) == {"grad_gap", "change_gap"}


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    real = transformer.decode_step

    def altered(cfg, params, cache, tokens):
        logits, new = real(cfg, params, cache, tokens)
        logits = logits.clone()
        top = logits.argmax(dim=-1, keepdim=True)
        logits.scatter_(-1, (top + 1) % logits.shape[-1], float(logits.amax()) + 1.0)
        return logits, new

    monkeypatch.setattr(transformer, "decode_step", altered)
    _, line = _serve(tiny.serve_cell())
    assert line["correct"] is False and line["checks"]["logit_gap"]["value"] > 5 * tiny.SERVE_LIMITS["logit_gap"]


def test_a_decode_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    real = transformer.decode_step
    monkeypatch.setattr(transformer, "decode_step", lambda cfg, params, cache, tokens:
                        (real(cfg, params, cache, tokens)[0], cache))
    _, line = _serve(tiny.serve_cell())
    assert line["correct"] is False


def test_a_train_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    def make(cfg, ocfg=None, **kw):
        def step(params, opt, batch):
            with torch.no_grad():
                loss = transformer.loss_fn(cfg, params, batch)
            return params, opt, {"loss": loss}
        return step

    monkeypatch.setattr(step_mod, "make_train_fn", make)
    _, line = _train(tiny.train_cell())
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from bench import calibrate

    monkeypatch.setattr(step_mod, "make_train_fn", calibrate.half_batch(step_mod.make_train_fn))
    _, line = _train(tiny.train_cell())
    assert line["correct"] is False


def test_the_control_fails_where_the_program_passes():
    """The float8 control at a test size: serving and training readings against the limits."""
    cell = tiny.serve_cell()
    run = serve.run(cell, 13, 0.0, False, "cpu", time.time())
    ref = cell.reference()
    w = program.reference_weights(ref, cell.arch, 13, CPU)
    gap, _ = serve.gaps(ref, cell.arch, w, run.served, run.checked, CPU, precision="fp8")
    assert run.correct and gap > cell.limits["logit_gap"], gap
    cell = tiny.train_cell()
    run = train.run(cell, 14, 0.0, False, "cpu", time.time())
    tr = traffic.TrainTraffic(cell.mix, cell.arch["vocab_size"], 14)
    got = train.reference_readings(cell, cell.reference(), 14, CPU, tr, train.optimizer_config(cell.mix),
                                   precision="fp8")
    held = train.Run(spans=run.spans)
    train.compare(got, run.reference, cell.limits, held)
    assert run.correct and not held.correct, held.checks
