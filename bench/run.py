#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process finds.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights made on the card from the seed, the kernels built or loaded
from ``build/kernels/``, every shape of the cell's traffic warmed up) is timed
from the process's start.  Then the window measures for ``--seconds`` (whole
cycles of the traffic), and the served tokens or the first training steps are
held to the plain reference.  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from
synchronised spans over the window and from a profile of the stretch after it.

The last line of standard output is the result, one JSON object.  The last
lines of standard error are each number compared, beside its limit.  Exits
non-zero with no result where there is no card, too few cards, or where the
process holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import env  # noqa: E402

T_START = env.process_start()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def metrics_of(cell, run, trace: bool) -> dict:
    from bench.harness import cell as cellmod

    if not trace:
        out = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] in run.end_to_end:
                out[m["name"]] = {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
        return out
    out = {}
    for m in cell.per_layer:
        value = cellmod.reader(m["name"])(run, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell, run, trace: bool, device: dict) -> dict:
    from bench.harness.trace import top_kernels

    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics_of(cell, run, trace), "device": device}
    if trace and run.trace is not None:
        line["device"] = {**device, "busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        line["breakdown"] = {"device_ops": top_kernels(run.trace), "idle_gaps": run.trace.idle_gaps}
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return line


def main(argv=None) -> None:
    args = parse(argv)
    env.prepare()
    from bench.harness import cell as cellmod

    cell = cellmod.load(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: this benchmark measures the port on the card and has no CPU fallback", 2)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, this machine has {torch.cuda.device_count()}", 2)

    from bench.harness import serve, train

    runner = serve if cell.mix["kind"] == "serve" else train
    run = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)

    banned = env.banned_loaded()
    if banned:
        fail(f"the process holds {banned} after the window: nothing here may load JAX or the JAX package", 3)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run.memory_peak, "card": env.card_line()}
    line = result(cell, run, bool(args.trace), device)
    print(json.dumps({"info": run.info, "notes": run.notes}, default=str), flush=True)
    for note in run.notes:
        print(f"bench: not correct: {note}", file=sys.stderr)
    for name, (v, lim) in run.checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
