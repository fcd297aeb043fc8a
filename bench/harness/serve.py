"""A serving cell: a closed loop of uniform batches through ``ServeEngine.run_batch``.

The engine takes one batch at a time and has no queue, so the client hands it
the next batch when the last one returns.  A request's time to first token runs
from the hand-off of its batch to the moment its first token is on the host:
the engine reads each step's tokens back before it calls the next decode step,
so that moment is the start of the batch's first decode call (or the batch's
return, for one new token).  Its last token is on the host when ``run_batch``
returns.  The window runs whole cycles of the mix's lengths and closes at the
end of the first cycle that ends after ``--seconds``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import program, trace as tracemod, traffic as trafficmod
from .run_state import Run
from .spans import Spans


def _percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _requests(Request, traffic, i: int, first_id: int, new_tokens: int):
    s, prompts = traffic.batch(i)
    return s, [Request(first_id + r, torch.from_numpy(prompts[r]), max_new_tokens=new_tokens)
               for r in range(prompts.shape[0])]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device(device)
    t_enter = time.time()
    ref = cell.reference()
    cfg = program.arch_config(cell.arch)
    mix = cell.mix
    traffic = trafficmod.ServeTraffic(mix, cfg.vocab_size, seed)
    params = program.build(cfg, ref, cell.arch, seed, dev)
    engine = ServeEngine(cfg, params, max_len=mix["max_len"], batch_size=mix["batch"], device=dev)
    spans = Spans(sync=trace, device_type=dev.type)
    engine.model.prefill = spans.wrap("prefill", engine.model.prefill)
    engine._decode = spans.wrap("decode", engine._decode)
    run_batch = spans.wrap("run_batch", engine.run_batch)
    new_tokens = mix["new_tokens"]
    t_built = time.time()

    # warm-up: every prompt length of the cycle, through prefill and one decode step
    for s in traffic.distinct_lengths():
        prompts = trafficmod.rng(seed, 9, s).integers(0, cfg.vocab_size, (mix["batch"], s), dtype=np.int64)
        run_batch([Request(-1 - r, torch.from_numpy(prompts[r]), max_new_tokens=2) for r in range(mix["batch"])])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = Run(spans=spans)
    out.setup_s = time.time() - t_start
    setup = {"start_s": t_enter - t_start, "weights_s": t_built - t_enter, "warmup_s": out.setup_s - (t_built - t_start)}
    spans.reset()

    cycle = len(traffic.lengths)
    done, ttft, tpot, batch_s = [], [], [], []
    prefill_tokens = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        s, reqs = _requests(Request, traffic, i, i * mix["batch"], new_tokens)
        n_decode = len(spans.starts.get("decode", ()))
        hand = time.perf_counter()
        served = run_batch(reqs)
        end = time.perf_counter()
        starts = spans.starts.get("decode", ())
        first = starts[n_decode] if len(starts) > n_decode else end
        for r in served:
            ttft.append(first - hand)
            if len(r.output) > 1:
                tpot.append((end - first) / (len(r.output) - 1))
            done.append((r.prompt, list(r.output)))
        prefill_tokens += s * len(reqs)
        batch_s.append([s, end - hand])
        i += 1
        if i % cycle == 0 and end - t0 >= seconds:
            break
    out.window_s = end - t0
    out.attempted = len(done)
    out.failed = sum(1 for _, o in done if len(o) != new_tokens or not all(0 <= t < cfg.vocab_size for t in o))
    tokens = sum(len(o) for _, o in done)
    out.end_to_end = {"ttft_p95_ms": _percentile(ttft, 95) * 1e3, "tpot_p95_ms": _percentile(tpot, 95) * 1e3,
                      "serve_tok_per_s": tokens / out.window_s}
    weights_applied = program.applied_weights(ref, cell.arch)
    head = program.head_weights(cell.arch)
    # a prefill multiplies each prompt token by every applied weight but the head, which scores the last only
    out.info = {"prefill_flops": 2 * (weights_applied - head) * prefill_tokens + 2 * head * mix["batch"] * i,
                "batches": i, "tokens": tokens, "requests": len(done), "setup": setup,
                "batch_s": batch_s}
    out.spans = spans.snapshot()  # the window's, without the profiled batch
    if trace:
        out.trace, out.info["profiled"] = _profile(cell, run_batch, traffic, Request, i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        out.memory_peak = torch.cuda.max_memory_allocated(dev)
    del engine, params, run_batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check(cell, ref, seed, dev, done, out)
    out.info["reference_s"] = time.perf_counter() - t_check
    return out


def _profile(cell, run_batch, traffic, Request, i: int):
    """Profile one more batch after the window (``i`` batches, whole cycles): the next cycle's
    longest prompt, so that every seed profiles the same work.  Returns its trace, and its
    shape with what each of the program's kernels counted in it."""
    j = next(k for k in range(i, i + len(traffic.lengths)) if traffic.length(k) == max(traffic.lengths))
    s, reqs = _requests(Request, traffic, j, 10**9, cell.mix["new_tokens"])
    holder = {}
    with tracemod.profiled(holder):
        run_batch(reqs)
    return holder["trace"], {"batch": len(reqs), "seq_len": s, "kernels": holder["kernels"]}


# ------------------------------------------------------------------ check
def sample(done: list, seed: int, min_tokens: int) -> list[int]:
    """Indices of finished requests to check: the longest prompt first, then others drawn
    from the seed until they hold ``min_tokens`` served tokens."""
    longest = max(range(len(done)), key=lambda k: len(done[k][0]))
    order = [k for k in trafficmod.rng(seed, 4).permutation(len(done)).tolist() if k != longest]
    picked, tokens = [longest], len(done[longest][1])
    for k in order:
        if tokens >= min_tokens:
            break
        picked.append(k)
        tokens += len(done[k][1])
    return picked


@torch.no_grad()
def gaps(ref, arch: dict, w: dict, done: list, picked: list[int], dev, precision: str = "f32",
         rows: int = 4) -> tuple[float, int]:
    """(the widest gap by which a served token's reference logit lies below the reference's
    best at its position, the positions read).  With ``precision`` other than f32, the token
    read at each position is the one that precision puts first, not the served one."""
    by_len: dict[int, list[int]] = {}
    for k in picked:
        by_len.setdefault(len(done[k][0]), []).append(k)
    widest, positions = 0.0, 0
    for plen, ks in sorted(by_len.items()):
        for lo in range(0, len(ks), rows):
            group = ks[lo:lo + rows]
            served = torch.tensor([done[k][1] for k in group], dtype=torch.int64, device=dev)
            prompts = torch.stack([done[k][0] for k in group]).to(dev)
            seq = torch.cat([prompts, served[:, :-1]], dim=1)
            logits = ref.next_token_logits(arch, w, seq, plen - 1)
            if precision != "f32":
                served = ref.next_token_logits(arch, w, seq, plen - 1, precision=precision).argmax(dim=-1)
            gap = logits.amax(dim=-1) - logits.gather(-1, served[..., None])[..., 0]
            widest = max(widest, float(gap.max()))
            positions += gap.numel()
            del logits
    return widest, positions


MIN_CHECKED_TOKENS = 256


def check(cell, ref, seed: int, dev, done: list, out: Run) -> None:
    """Hold a sample of the served tokens to the float32 reference over the same weights."""
    if out.failed:
        out.notes.append(f"{out.failed} of {out.attempted} requests came back short or out of the vocabulary")
    w = program.reference_weights(ref, cell.arch, seed, dev)
    picked = sample(done, seed, MIN_CHECKED_TOKENS)
    widest, positions = gaps(ref, cell.arch, w, done, picked, dev)
    out.served, out.checked = done, picked
    out.info["checked"] = {"requests": len(picked), "positions": positions}
    out.checks["logit_gap"] = (widest, cell.limits["logit_gap"])
