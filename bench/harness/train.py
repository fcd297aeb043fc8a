"""A training cell: AdamW steps of ``make_train_fn``'s step, a new batch each step.

Set-up builds the one step function, the model and its optimizer state, and
drives them from the seed through their first ``FIRST_STEPS`` steps through the
window's own call and feed; the window then continues the same objects.  What
the reference is held to is read in set-up, before step 4 changes it: each
step's loss, each weight's gradient as the optimizer took it in step 1 (from
the first moment, ``mu / (1 - b1)``), and each weight's change over the first
steps.
"""
from __future__ import annotations

import gc
import time

import torch

from . import program, trace as tracemod, traffic as trafficmod
from .run_state import Run
from .spans import Spans

FIRST_STEPS = 3


def _batch(traffic, step: int, dev) -> dict:
    tokens, labels = traffic.batch(step)
    return {"tokens": torch.from_numpy(tokens).to(dev, non_blocking=True),
            "labels": torch.from_numpy(labels).to(dev, non_blocking=True)}


def _leaf_norms(tensors: dict) -> dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def optimizer_config(mix: dict):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(**mix["optimizer"])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_fn

    dev = torch.device(device)
    t_enter = time.time()
    ref = cell.reference()
    cfg = program.arch_config(cell.arch)
    traffic = trafficmod.TrainTraffic(cell.mix, cfg.vocab_size, seed)
    ocfg = optimizer_config(cell.mix)
    params = program.build(cfg, ref, cell.arch, seed, dev)
    opt = adamw.init(params)
    spans = Spans(sync=trace, device_type=dev.type)
    step_fn = make_train_fn(cfg, ocfg)
    t_built = time.time()

    def step(k: int) -> float:
        with spans.timed("step"):
            _, _, metrics = step_fn(params, opt, _batch(traffic, k, dev))
            loss = float(metrics["loss"])  # reads the step's end back, as a training loop logs it
        return loss

    losses, grad1 = [], {}
    for k in range(FIRST_STEPS):
        losses.append(step(k))
        if k == 0:
            grad1 = {n: v / (1 - ocfg.b1) for n, v in _leaf_norms(opt["mu"]).items()}
    w0 = program.reference_weights(ref, cell.arch, seed, dev)
    change = _leaf_norms({n: p.detach().float() - w0[n] for n, p in params.named_parameters()})
    del w0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = Run(spans=spans)
    out.setup_s = time.time() - t_start
    setup = {"start_s": t_enter - t_start, "weights_s": t_built - t_enter, "first_steps_s": out.setup_s - (t_built - t_start)}
    spans.reset()

    k = FIRST_STEPS
    window_losses = []
    t0 = time.perf_counter()
    while True:
        window_losses.append(step(k))
        k += 1
        end = time.perf_counter()
        if end - t0 >= seconds:
            break
    out.window_s = end - t0
    out.attempted = k - FIRST_STEPS
    out.failed = sum(1 for x in window_losses if not torch.isfinite(torch.tensor(x)))
    tokens_per_step = cell.mix["batch"] * cell.mix["seq_len"]
    out.end_to_end = {"train_tok_per_s": out.attempted * tokens_per_step / out.window_s}
    out.info = {"train_flops_per_step": 6 * program.applied_weights(ref, cell.arch) * tokens_per_step,
                "steps": out.attempted, "setup": setup}
    out.spans = spans.snapshot()  # the window's, without the profiled step
    if trace:
        holder = {}
        with tracemod.profiled(holder):
            step(k)
        out.trace = holder["trace"]
        out.info["profiled"] = {"batch": cell.mix["batch"], "seq_len": cell.mix["seq_len"],
                                "kernels": holder["kernels"]}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        out.memory_peak = torch.cuda.max_memory_allocated(dev)
    del params, opt, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    out.reference = reference_readings(cell, ref, seed, dev, traffic, ocfg)
    out.info["reference_s"] = time.perf_counter() - t_check
    compare({"loss": losses, "grad1": grad1, "change": change}, out.reference, cell.limits, out)
    return out


def reference_readings(cell, ref, seed: int, dev, traffic, ocfg, precision: str = "f32") -> dict:
    """The reference's first steps from the same weights and batches: the same three readings."""
    import dataclasses

    o = dataclasses.asdict(ocfg)
    w = program.reference_weights(ref, cell.arch, seed, dev)
    w0 = {n: t.clone() for n, t in w.items()}
    for t in w.values():
        t.requires_grad_(True)
    state: dict = {}
    losses, grad1 = [], {}
    for k in range(FIRST_STEPS):
        b = _batch(traffic, k, dev)
        loss = ref.loss(cell.arch, w, b["tokens"], b["labels"], precision=precision)
        grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
        losses.append(float(loss.detach()))
        clipped = ref.adamw_step(o, w, grads, state)
        if k == 0:
            grad1 = _leaf_norms(clipped)
        del grads, clipped, loss
    change = _leaf_norms({n: w[n].detach() - w0[n] for n in w})
    return {"loss": losses, "grad1": grad1, "change": change}


def _leaf_gaps(got: dict, want: dict, names) -> dict[str, float]:
    """Each leaf's gap between the two norms, over the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    median = float(torch.tensor([want[n] for n in names]).median())
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in names}


def _worst(gaps: dict[str, float]) -> tuple[float, str]:
    """The widest gap and its leaf (a NaN counts as the widest)."""
    worst, at = 0.0, ""
    for n, gap in gaps.items():
        if gap > worst or not gap == gap:
            worst, at = gap, n
    return worst, at


def _median(gaps: dict[str, float]) -> float:
    return float(torch.tensor(list(gaps.values())).median())


def compare(got: dict, want: dict, limits: dict, out: Run) -> dict:
    """The numbers compared.

    - ``grad_gap``: the first gradient's norm, by the median leaf's gap.  The widest leaf's
      gap is always a per-head vector or a conv bias (``d_skip``, ``a_log``, ``dt_bias``,
      ``conv_bc``), whose few elements carry the bf16 noise; it is read, not compared.
    - ``change_gap``: the change's norm over the first steps, by the widest leaf's gap.
    Each step's loss gap is read, not compared: the float8 control reads it under three
    times the bf16 program's, so no limit would separate them.
    """
    names = sorted(want["grad1"])
    grad = _leaf_gaps(got["grad1"], want["grad1"], names)
    change = _leaf_gaps(got["change"], want["change"], names)
    grad_worst, grad_at = _worst(grad)
    change_worst, change_at = _worst(change)
    out.info["compared"] = {"grad_worst_leaf_gap": grad_worst, "grad_worst_leaf": grad_at,
                            "change_median_leaf_gap": _median(change), "change_worst_leaf": change_at,
                            "loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])],
                            "leaves": len(names),
                            "loss": got["loss"], "loss_reference": want["loss"]}
    out.checks["grad_gap"] = (_median(grad), limits["grad_gap"])
    out.checks["change_gap"] = (change_worst, limits["change_gap"])
    return out.checks
