"""Roofline table from the recorded dry-run artifacts (results/*.json).

Prints one row per (arch, shape): the three terms, the bottleneck, and
MODEL_FLOPS/HLO_FLOPs (useful-compute ratio).  This is §Roofline's source."""
from __future__ import annotations

import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")


def main(emit) -> None:
    path = os.path.join(RESULTS, "dryrun_single.json")
    if not os.path.exists(path):
        emit("roofline/missing,0,run `python -m repro_torch.launch.dryrun --all --mesh single --out src/repro_torch/results/dryrun_single.json` first")
        return
    rows = json.load(open(path))
    worst = None
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok":
            emit(f"roofline:{r['arch']}:{r['shape']},0,status={r['status']}")
            continue
        rl = r["roofline"]
        dom = rl["bottleneck"]
        dom_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        frac = rl["compute_s"] / max(dom_s, 1e-12)  # compute roofline fraction
        emit(
            f"roofline:{r['arch']}:{r['shape']},{dom_s*1e6:.0f},"
            f"bottleneck={dom};compute_s={rl['compute_s']:.4f};memory_s={rl['memory_s']:.4f};"
            f"collective_s={rl['collective_s']:.4f};useful_ratio={rl['useful_ratio']:.3f};"
            f"roofline_frac={frac:.3f}"
        )
        if r["shape"] == "train_4k" and (worst is None or frac < worst[1]):
            worst = (r["arch"], frac)
    if worst:
        emit(f"roofline/worst_train_cell,0,arch={worst[0]};compute_fraction={worst[1]:.3f}")
