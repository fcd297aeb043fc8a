#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from (not part of a benchmark run).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

For each of ``--seeds`` it runs the cell as ``bench/run.py`` does, with a short
window (one cycle of the traffic, or the first training steps alone), and prints
the numbers compared: the program's lower readings.  For each of
``--control-seeds`` it also reads the control: the plain reference put in the
program's place and computed in float8 (e4m3, one scale a tensor), the precision
below the configuration's bfloat16.  A serving cell's control reads, at each
checked position, the float32 reference's gap of the token that float8 puts
first.  A training cell's control is the reference's first steps in float8
against the float32 reference's.  For a training cell, each of
``--fault-seeds`` also runs the program with half of each batch left out and the
mean taken over the rest.  One JSON line per reading; the limits are set by hand
from them (``bench/limits/<cell>.json``), as ``PERF.md`` records.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import env  # noqa: E402


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def half_batch(make_train_fn):
    """A step that leaves out the second half of each batch (the loss is the mean over the rest)."""
    def make(*args, **kwargs):
        step = make_train_fn(*args, **kwargs)

        def broken(params, opt, batch):
            return step(params, opt, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return broken
    return make


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    env.prepare()
    import torch

    from bench.harness import cell as cellmod, program, serve, train, traffic as trafficmod

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    cell = cellmod.load(args.workload)
    ref = cell.reference()
    dev = torch.device("cuda")
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        torch.cuda.reset_peak_memory_stats()
        runner = serve if cell.mix["kind"] == "serve" else train
        run = runner.run(cell, seed, args.seconds, False, "cuda", time.time())
        row = {"seed": seed, "program": {k: v for k, (v, _) in run.checks.items()}, "info": run.info,
               "memory_peak": run.memory_peak}
        if seed in args.control_seeds:
            if cell.mix["kind"] == "serve":
                w = program.reference_weights(ref, cell.arch, seed, dev)
                gap, positions = serve.gaps(ref, cell.arch, w, run.served, run.checked, dev, precision="fp8")
                row["control"] = {"logit_gap": gap, "positions": positions}
                del w
            else:
                tr = trafficmod.TrainTraffic(cell.mix, cell.arch["vocab_size"], seed)
                got = train.reference_readings(cell, ref, seed, dev, tr, train.optimizer_config(cell.mix),
                                               precision="fp8")
                held = train.Run(spans=run.spans)
                train.compare(got, run.reference, cell.limits, held)
                row["control"] = {k: v for k, (v, _) in held.checks.items()}
                row["control_info"] = held.info["compared"]
        emit(**row)
        del run
        torch.cuda.empty_cache()
    if args.fault_seeds and cell.mix["kind"] == "train":
        import repro_torch.train.step as step_mod

        original = step_mod.make_train_fn
        step_mod.make_train_fn = half_batch(original)
        try:
            for seed in args.fault_seeds:
                run = train.run(cell, seed, args.seconds, False, "cuda", time.time())
                emit(seed=seed, fault="half_batch", readings={k: v for k, (v, _) in run.checks.items()},
                     info=run.info["compared"])
                del run
                torch.cuda.empty_cache()
        finally:
            step_mod.make_train_fn = original
    banned = env.banned_loaded()
    if banned:
        sys.exit(f"calibrate: the process holds {banned}")


if __name__ == "__main__":
    main()
