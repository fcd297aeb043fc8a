"""The port's dry-run (``repro_torch.launch.dryrun``) and its serving steps
(``train.step.make_prefill_step`` / ``make_decode_step``), on the CPU.

A process group is global to its process, so each group runs in a
subprocess of its own, both started together:

- a ``"fake"`` group of 8 ranks: the census of one ``full_tensor`` and one
  ``redistribute`` from ``Partial`` against hand-computed collectives, the
  memory tracker on a hand-made sequence of allocations and frees, then the
  reference's 4 mini dry-run cells and one cell of every family and step
  kind, on reduced archs at the mini shapes (batch at most 8, so long_500k
  keeps its batch of 1; at most 256 tokens),
  each over a (2, 4) and an (8, 1) mesh (and ``pure-dp`` for the train
  cells), then ``main`` end to end on the (16, 16) production mesh into a
  temporary directory that ``bench_roofline`` reads;
- a one-rank ``gloo`` group: the serving steps against the unsharded
  functions of every family, bitwise, and ZeRO-1's train step against the
  plain one.

The mini archs take a vocabulary of 512 (a multiple of 128 x 4), so that
the (2, 4) and (8, 1) meshes pad it alike and their FLOPs differ only by
what each rank computes.  These cells are held to the port's own bar, not
to the reference's mini dry-run, which is red (ROADMAP fault (a)).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, SHAPES

ROOT = Path(__file__).resolve().parents[1]
# the reference's 4 mini cells, then one of every family and step kind
CELLS = [("qwen2.5-3b", "train_4k"), ("mamba2-780m", "long_500k"), ("deepseek-moe-16b", "decode_32k"),
         ("whisper-medium", "prefill_32k"), ("zamba2-2.7b", "prefill_32k"), ("internvl2-26b", "train_4k"),
         ("mamba2-780m", "train_4k"), ("qwen2.5-3b", "decode_32k"), ("zamba2-2.7b", "long_500k"),
         ("deepseek-moe-16b", "train_4k"), ("whisper-medium", "decode_32k")]
MAIN_CELLS = [("mamba2-780m", "decode_32k"), ("qwen2.5-3b", "prefill_32k")]

FAKE = """
import dataclasses, json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
import repro_torch.configs.registry as reg
import repro_torch.launch.dryrun as dr
from repro_torch.benchmarks import bench_roofline

out = {{}}
dr.fake_group(8)
meshes = {{m: DeviceMesh("cpu", torch.arange(8).reshape(*m), mesh_dim_names=("data", "model")) for m in ((2, 4), (8, 1))}}

with torch._subclasses.FakeTensorMode():
    mesh = meshes[(2, 4)]
    whole = distribute_tensor(torch.empty(16, 8), mesh, [Shard(0), Shard(1)])
    partial = DTensor.from_local(torch.empty(4, 8), mesh, [Partial(), Replicate()])
    for name, fn in (("full_tensor", whole.full_tensor),
                     ("reduce_scatter", lambda: partial.redistribute(mesh, [Shard(1), Replicate()]))):
        with dr.Census() as c:
            fn()
        out[name] = [[dataclasses.asdict(x) for x in c.trace.collectives], c.trace.collective_stats().wire_bytes]
    a = torch.empty(1000)
    with dr.Census([a]) as c:
        x = torch.empty(1000)
        y = torch.empty(2000)
        view = y[:10]
        y.add_(1.0)
        del x
        z = torch.empty(500)
        del y, view, z
    out["memory"] = [c.peak, c.live]

for s, spec in list(reg.SHAPES.items()):
    reg.SHAPES[s] = dataclasses.replace(spec, seq_len=min(spec.seq_len, 256), global_batch=min(spec.global_batch, 8))
for a in list(reg.ARCHS):
    reg.ARCHS[a] = dataclasses.replace(reg.ARCHS[a].reduced(), vocab_size=512)
production = dr.make_production_mesh
for arch, shape in {cells!r}:
    runs = [((2, 4), "baseline", False), ((8, 1), "baseline", False)]
    if reg.SHAPES[shape].step == "train":
        runs += [((2, 4), "pure-dp", False), ((2, 4), "replicated-weights", True)]
    for m, layout, zero1 in runs:
        dr.make_production_mesh = lambda multi_pod=False, device=None, m=m: meshes[m]
        row = dr.run_cell(arch, shape, "single", layout=layout, zero1=zero1)
        out["|".join([arch, shape, str(m), layout, str(zero1)])] = row
dr.make_production_mesh = production
tmp = sys.argv[1]
for arch, shape in {main_cells!r}:
    dr.main(["--arch", arch, "--shape", shape, "--mesh", "single", "--out", tmp + "/dryrun_single.json"])
out["written"] = json.load(open(tmp + "/dryrun_single.json"))
bench_roofline.RESULTS = tmp
lines = []
bench_roofline.main(lines.append)
out["bench"] = lines
print(json.dumps(out))
"""

GLOO = """
import json
import torch
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import (make_decode_fn, make_decode_step, make_prefill_fn, make_prefill_step,
                                    make_train_step)

mesh = make_host_mesh(device="cpu")
out = {}


def leaves(tree, prefix=""):
    return {k: v for key, val in tree.items()
            for k, v in (leaves(val, prefix + key + "/").items() if isinstance(val, dict) else [(prefix + key, val)])}


for name in sorted(ARCHS):
    cfg = rules.pad_config_for_mesh(ARCHS[name].reduced(), mesh)
    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=g, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((2, cfg.num_patches, cfg.d_model), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1), generator=g, dtype=torch.int32)
    want_logits, want_cache = make_prefill_fn(cfg, 32)(model, batch)
    want_next, want_new = make_decode_fn(cfg)(model, want_cache, tokens)
    prefill, _, pspecs = make_prefill_step(cfg, mesh, 32)
    decode, _, _ = make_decode_step(cfg, mesh)
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    logits, cache = prefill(params, batch)
    next_tok, new = decode(params, cache, tokens)
    got = {"logits": logits, "next": next_tok,
           **{"cache/" + k: v for k, v in leaves(cache).items()}, **{"new/" + k: v for k, v in leaves(new).items()}}
    want = {"logits": want_logits, "next": want_next,
            **{"cache/" + k: v for k, v in leaves(want_cache).items()},
            **{"new/" + k: v for k, v in leaves(want_new).items()}}
    out[name] = {"keys": [sorted(got), sorted(want)],
                 "differ": [k for k in want if k in got and not torch.equal(got[k].full_tensor(), want[k])]}

layout = "replicated-weights"
cfg = rules.pad_config_for_mesh(ARCHS["qwen2.5-3b"].reduced(), mesh, layout)
step, params_shape, pspecs, _, ospecs = make_train_step(cfg, mesh, adamw.AdamWConfig(lr=1e-2, warmup_steps=0),
                                                        layout=layout)
zshard = rules.param_shardings(cfg, mesh, params_shape, "dp-only")
batch = {k: torch.from_numpy(v) for k, v in host_batch(cfg, DataConfig(seq_len=24, global_batch=4, seed=0), 0).items()}
runs = {}
for zero1 in (False, True):
    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    opt = rules.distribute(adamw.init(model), {"mu": zshard, "nu": zshard, "step": ospecs["step"]} if zero1 else ospecs)
    _, _, metrics = step(params, opt, batch)
    runs[zero1] = ({n: p.full_tensor() for n, p in params.items()}, {k: v.item() for k, v in metrics.items()},
                   sorted(str(p.placements) for p in opt["mu"].values()) != sorted(str(p.placements) for p in params.values()))
out["zero1"] = {"params_differ": [n for n, p in runs[False][0].items() if not torch.equal(p, runs[True][0][n])],
                "metrics": [runs[False][1], runs[True][1]], "state_placed_apart": runs[True][2]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the fake group's results, the gloo group's results, the results directory)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for code in (FAKE.format(cells=CELLS, main_cells=MAIN_CELLS), GLOO)]
    results = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    return results[0], results[1], tmp


def test_census_prices_a_full_tensor_and_a_reduce_scatter(runs):
    """A (16, 8) f32 tensor split (Shard(0), Shard(1)) over the (2, 4) mesh comes
    whole through one all-gather over each mesh dim: 448 wire bytes, whichever
    goes first.  A (4, 8) f32 ``Partial`` over the data dim scattered into
    Shard(1): one reduce-scatter of its 128-byte operand over 2 ranks, 64 wire
    bytes (the reference's formula, on the 64-byte result, would say 32)."""
    fake, _, _ = runs
    gathers, wire = fake["full_tensor"]
    assert sorted((c["op"], c["group_size"]) for c in gathers) == [("all-gather", 2), ("all-gather", 4)]
    assert wire == 448
    (rs,), wire = fake["reduce_scatter"]
    assert rs == {"op": "reduce-scatter", "operand_bytes": 128, "result_bytes": 64, "group_size": 2}
    assert wire == 64


def test_census_tracks_the_peak_of_live_storages(runs):
    """Arguments 4,000 B; +4,000 and +8,000 (the peak, 16,000); a view and an
    in-place op allocate nothing; -4,000, +2,000, then everything new freed."""
    fake, _, _ = runs
    assert fake["memory"] == [16_000, 4_000]


def _cell_rows(fake, arch, shape):
    return {key.split("|", 2)[2]: row for key, row in fake.items() if key.startswith(f"{arch}|{shape}|")}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_mini_dryrun_cell(runs, arch, shape):
    """Every run of the cell: status ok, finite terms, a named bottleneck, and a
    peak at least its arguments, which hold bytes."""
    fake, _, _ = runs
    rows = _cell_rows(fake, arch, shape)
    assert len(rows) == (4 if SHAPES[shape].step == "train" else 2)
    for run, row in rows.items():
        assert row["status"] == "ok", (run, row.get("traceback"))
        rl = row["roofline"]
        assert all(math.isfinite(v) for v in rl.values() if isinstance(v, float)), (run, rl)
        assert rl["bottleneck"] in ("compute", "memory", "collective")
        assert row["memory"]["peak_bytes"] >= row["memory"]["argument_bytes"] > 0, (run, row["memory"])
        assert rl["traced_flops_per_device"] > 0 and rl["traced_wire_bytes_per_device"] > 0


def _decode_attention_flops(arch: str, shape: str, shards: int) -> float:
    """The FLOPs of one decode step's attention over a mini cell's cache (batch 1)
    cut into ``shards`` sequence shards, on one shard: 4 H hd S / shards a layer
    with attention (``launch/roofline.py``'s decode term)."""
    cfg = ARCHS[arch].reduced()
    if not cfg.num_heads:
        return 0.0
    layers = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers
    return layers * 4.0 * cfg.num_heads * cfg.resolved_head_dim * min(SHAPES[shape].seq_len, 256) / shards


@pytest.mark.parametrize("arch,shape", CELLS)
def test_mini_dryrun_flops_split_the_model_axis(runs, arch, shape):
    """What each rank computes under ``baseline`` on the (2, 4) mesh against the
    (8, 1) mesh, where no model axis exists.  Every family's steps are tensor
    parallel (ROADMAP P5, P5b and P5c, repaired): a rank of a model group
    computes a quarter of the heads, hidden and expert hidden columns and
    vocabulary of 4 rows where a rank of the (8, 1) mesh computes all of 1 row,
    so the traced FLOPs a rank are within 0.7-1.4x of it (what stays
    replicated: norms, the SSM's B and C, a MoE's router, qwen2.5-3b's
    replicated kv heads at tp = 4; in decode, each rank's attention over its
    sequence shard takes every q head).

    long_500k's batch of 1 cannot split over the data axes, so ``cache_specs``
    splits its sequence over every axis: ``("data", "model")`` on (2, 4), and
    ``"data"`` on (8, 1), 8 shards on both.  A rank of either mesh attends with
    every head over one shard: the same attention FLOPs ``A``
    (``_decode_attention_flops``).  The rest, ``R`` on an (8, 1) rank (the SSM,
    the MLP, the embedding, every rank repeating the one row), a (2, 4) rank
    computes over ``"model"`` only: a quarter of it, or at most 0.35 R with what
    stays replicated (mamba2-780m's cell, which has no attention, is held to
    0.35 so).  So the ratio is at most (A + 0.35 R) / (A + R).

    ``pure-dp`` (the batch over every axis) in a train cell computes what the
    (8, 1) mesh does, within 10%; it cannot place a serving cache (``rules.cache_specs``
    names the model axis twice, in the reference too).  Where no rank repeats
    another's work, the traced FLOPs lie within 0.5-2x of the analytic term; a
    MoE decode above it, since every expert computes its minimum capacity of 4
    slots (``models/moe.py::capacity``) where the term counts the top-k."""
    fake, _, _ = runs
    rows = _cell_rows(fake, arch, shape)
    flops = {run: row["roofline"]["traced_flops_per_device"] for run, row in rows.items()}
    ratio = flops["(2, 4)|baseline|False"] / flops["(8, 1)|baseline|False"]
    if SHAPES[shape].global_batch == 1:
        a = _decode_attention_flops(arch, shape, 8)
        r = flops["(8, 1)|baseline|False"] - a
        assert ratio <= (a + 0.35 * r) / (a + r), ratio
    else:
        assert 0.7 <= ratio <= 1.4, ratio
    if SHAPES[shape].step == "train":
        assert flops["(2, 4)|pure-dp|False"] / flops["(8, 1)|baseline|False"] == pytest.approx(1, rel=0.1)
    for run in ("(8, 1)|baseline|False", "(2, 4)|pure-dp|False", "(2, 4)|baseline|False"):
        if run not in rows or SHAPES[shape].global_batch == 1:
            continue
        ratio = flops[run] / rows[run]["roofline"]["flops_per_device"]
        if ARCHS[arch].family == "moe" and SHAPES[shape].step == "decode":
            assert ratio > 2, ratio
        else:
            assert 0.5 <= ratio <= 2, (run, ratio)


def test_zero1_places_the_state_over_the_data_axes(runs):
    """``--zero1`` (AdamW state in ``dp-only``'s placements, params replicated):
    the step runs, and scatters its gradients into the state's placements."""
    fake, _, _ = runs
    row = fake["qwen2.5-3b|train_4k|(2, 4)|replicated-weights|True"]
    assert row["status"] == "ok", row.get("traceback")
    assert row["zero1"] and row["roofline"]["collectives"]["reduce-scatter"] > 0


def test_main_writes_rows_that_bench_roofline_prints(runs):
    """``main`` on two cells, one run each into one file (merged by key), over the
    (16, 16) production mesh of a 256-rank fake group; ``bench_roofline``,
    pointed at that directory, prints one row a cell."""
    fake, _, tmp = runs
    rows = fake["written"]
    assert [(r["arch"], r["shape"], r["mesh"], r["devices"], r["status"]) for r in rows] == [
        (a, s, "single", 256, "ok") for a, s in MAIN_CELLS]
    assert (Path(tmp) / "dryrun_single.json").is_file()
    for r in rows:
        assert set(r) >= {"lower_s", "trace_s", "memory", "roofline"} and "compile_s" not in r
    printed = [ln.split(",")[0] for ln in fake["bench"]]
    assert printed == sorted(f"roofline:{a}:{s}" for a, s in MAIN_CELLS)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serving_steps_on_one_rank_are_bitwise_the_unsharded_functions(runs, name):
    """``make_prefill_step`` then ``make_decode_step`` on a one-rank gloo mesh:
    the logits, the next tokens and every leaf of both caches equal
    ``make_prefill_fn`` and ``make_decode_fn``'s, bitwise."""
    _, gloo, _ = runs
    got, want = gloo[name]["keys"]
    assert got == want and gloo[name]["differ"] == []


def test_zero1_train_step_on_one_rank_is_bitwise_the_plain_step(runs):
    """The AdamW state in other placements than the params (ZeRO-1) changes no
    number of the step."""
    _, gloo, _ = runs
    z = gloo["zero1"]
    assert z["state_placed_apart"] and z["params_differ"] == [] and z["metrics"][0] == z["metrics"][1]


def test_production_dryrun_results_complete():
    """Validate the recorded 512/256-rank dry-run rows (all 40 cells), where a full
    run has written them into the port's results directory."""
    for fname, mesh in [("dryrun_single.json", "single"), ("dryrun_multi.json", "multi")]:
        path = ROOT / "src" / "repro_torch" / "results" / fname
        if not path.exists():
            pytest.skip(f"{fname} not generated yet (run repro_torch.launch.dryrun --all)")
        rows = json.loads(path.read_text())
        cells = {(r["arch"], r["shape"]): r for r in rows if r["mesh"] == mesh}
        assert len(cells) == 40, f"{fname}: expected 40 cells, got {len(cells)}"
        fails = [(k, v.get("error", "")) for k, v in cells.items() if v["status"] == "FAIL"]
        assert not fails, fails
        ok = [v for v in cells.values() if v["status"] == "ok"]
        skipped = [v for v in cells.values() if v["status"] == "skipped"]
        assert len(ok) == 32 and len(skipped) == 8  # long_500k skips for 8 archs
        for v in ok:
            assert v["roofline"]["bottleneck"] in ("compute", "memory", "collective")
