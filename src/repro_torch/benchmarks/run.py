"""Benchmark harness through the port: one module per paper table/figure.

Each benchmark emits ``name,us_per_call,derived`` CSV rows and asserts the
paper's qualitative claims (orderings/ratios) on the scaled workloads —
failures here mean the reproduction no longer matches the paper.

    PYTHONPATH=src python -m repro_torch.benchmarks.run             # everything
    PYTHONPATH=src python -m repro_torch.benchmarks.run fig1 merge  # substring filter
    PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke     # CI: tiny shard+ycsb
    PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke --json OUT.json
                                                                    # + machine-readable rows
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu
                                                                    # no card: plain versions

``--json`` writes every emitted row as ``{"name", "us_per_call", "derived"}``
(plus the failure list); ``scripts/check_bench.py`` diffs such a file against
the checked-in ``BENCH_BASELINE.json`` — that pair is the CI bench-regression
gate (.github/workflows/ci.yml).  A substring filter that matches nothing is
an error (exit 2, listing valid names): CI must not green-light a typo'd
bench job by silently running zero benchmarks.

The benches and their rows are the reference's (``benchmarks/run.py``).
``--device`` (``cuda``, the default, or ``cpu``) is where the tensor benches
run: ``model_fig2`` (``core/model.py``'s float32 tensors) and ``kernels``
(the CUDA kernels on the card, their plain versions on the CPU).  The store
runs on the host either way, as in the reference.  Without a card,
``--device cuda`` raises; the CPU is used only when asked for.
"""
from __future__ import annotations

import json
import sys
import time
import traceback

import torch

from . import (
    bench_ablation,
    bench_analysis,
    bench_thresholds,
    bench_checkpoint,
    bench_elastic,
    bench_fig1,
    bench_kernels,
    bench_lifetime,
    bench_loadrun,
    bench_merge,
    bench_model,
    bench_range,
    bench_roofline,
    bench_shard,
    bench_ycsb,
)

BENCHES = [
    ("model_fig2", bench_model.main),
    ("fig1_small_kv_gc", bench_fig1.main),
    ("fig5_ycsb", bench_ycsb.main),
    ("shard_batch_frontend", bench_shard.main),
    ("range_vs_hash_sharding", bench_range.main),
    ("fig6_loadrun", bench_loadrun.main),
    ("fig7_medium_ablation", bench_ablation.main),
    ("thresholds_beyond_paper", bench_thresholds.main),
    ("fig8_merge_level", bench_merge.main),
    ("kernels", bench_kernels.main),
    ("checkpoint_substrate", bench_checkpoint.main),
    ("roofline", bench_roofline.main),
    ("analysis_overhead", bench_analysis.main),
    ("lifetime_placement", bench_lifetime.main),
    ("elastic_rescale", bench_elastic.main),
]


# the benches that take the runner's --device
ON_DEVICE = {"model_fig2", "kernels"}


# --smoke: a seconds-long CI job — the YCSB suite plus both sharded
# front-ends (hash + range) at tiny num_keys/num_ops (claims that need scale
# are skipped); any registered bench raising fails the job (exit 1)
SMOKE_BENCHES = [
    ("fig5_ycsb", lambda emit: bench_ycsb.main(emit, smoke=True)),
    ("shard_batch_frontend", lambda emit: bench_shard.main(emit, smoke=True)),
    ("range_vs_hash_sharding", lambda emit: bench_range.main(emit, smoke=True)),
    ("analysis_overhead", lambda emit: bench_analysis.main(emit, smoke=True)),
    ("checkpoint_substrate", lambda emit: bench_checkpoint.main(emit, smoke=True)),
    ("lifetime_placement", lambda emit: bench_lifetime.main(emit, smoke=True)),
    ("elastic_rescale", lambda emit: bench_elastic.main(emit, smoke=True)),
]


def _option(argv: list[str], flag: str, what: str) -> str | None:
    """Remove ``flag VALUE`` from argv and return VALUE (exit 2 without one)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv) or argv[i + 1].startswith("-"):
        print(f"error: {flag} needs {what}", file=sys.stderr)
        sys.exit(2)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    json_out = _option(argv, "--json", "an output path")
    device = _option(argv, "--device", "cuda or cpu") or "cuda"
    if device not in ("cuda", "cpu"):
        print(f"error: --device must be cuda or cpu, got {device!r}", file=sys.stderr)
        sys.exit(2)
    smoke = "--smoke" in argv
    unknown = [a for a in argv if a.startswith("-") and a != "--smoke"]
    if unknown:
        # same failure class as the zero-match filter: a typo'd flag silently
        # running the wrong bench set must not green-light a CI job
        print(f"error: unknown flag(s) {unknown!r}; valid flags: --smoke, --json OUT.json, "
              "--device cuda|cpu", file=sys.stderr)
        sys.exit(2)
    filters = [a for a in argv if not a.startswith("-")]
    benches = SMOKE_BENCHES if smoke else BENCHES
    selected = [(name, fn) for name, fn in benches
                if not filters or any(f in name for f in filters)]
    if filters and not selected:
        valid = ", ".join(name for name, _ in benches)
        print(f"error: filter(s) {filters!r} matched no benchmarks; "
              f"valid names ({'smoke' if smoke else 'full'} set): {valid}",
              file=sys.stderr)
        sys.exit(2)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass --device cpu to run on the CPU explicitly")

    rows: list[str] = []

    def emit(row: str) -> None:
        print(row, flush=True)
        rows.append(row)

    print("name,us_per_call,derived")
    failures = []
    for name, fn in selected:
        t0 = time.time()
        try:
            if name in ON_DEVICE:
                fn(emit, device=device)
            else:
                fn(emit)
            emit(f"bench:{name}/total,{(time.time()-t0)*1e6:.0f},ok")
        except AssertionError as e:
            failures.append((name, e))
            emit(f"bench:{name}/total,{(time.time()-t0)*1e6:.0f},CLAIM-FAILED:{e}")
        except Exception as e:  # noqa: BLE001
            failures.append((name, e))
            traceback.print_exc()
            emit(f"bench:{name}/total,{(time.time()-t0)*1e6:.0f},ERROR:{type(e).__name__}")
    if json_out:
        def row_dict(row: str) -> dict:
            d = dict(zip(("name", "us_per_call", "derived"), row.split(",", 2)))
            # PR 5: per-engine rows carry the engine-config tag after '@' in
            # their id (EngineConfig.tag(), e.g. "hash4+serial"); surface it
            # as its own field so baseline diffs can key on configuration
            # without parsing row names.  Gate rows append ':gate' after the
            # tag ('<prefix>@<tag>:gate') — tags never contain ':', so the
            # suffix is split back off here.
            name = d["name"]
            d["engine"] = name.split("@", 1)[1].split(":", 1)[0] if "@" in name else ""
            return d

        payload = {
            "smoke": smoke,
            "rows": [row_dict(row) for row in rows],
            "failures": [name for name, _ in failures],
        }
        with open(json_out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
