"""``make_train_step``'s hooks, gradient accumulation and compression, on the CPU.

Two groups of 4 gloo ranks (``torch_parity.run_ranks``), one over a (2, 2)
mesh and one over a (1, 4) mesh ("data", "model"), both started together.
On each rank, with inputs made from a numpy seed:

- (a) ``train/step.py::_compress_shards`` on whole stacked tensors placed as
  DTensors (``Shard`` over both mesh dims, ``Replicate``, the two mixed, and
  each tensor its own), against ``compress_grads`` of the whole tensors,
  bitwise, for int8 and top-k: ties at every magnitude, a tensor of 7
  elements (k = 1, uneven shards), an all-zero tensor; under the dry-run's
  census, nothing but all-reduces of one number a tensor crosses the wire;
- (b) ``make_train_step`` with ``accum_steps`` in {2, 3} and ``compress`` in
  {"none", "int8", "topk"}, for reduced mamba2-780m, qwen2.5-3b and
  deepseek-moe-16b (``capacity_factor`` E / K: no token drops, so a
  microbatch routes alike whole and split) under ``baseline`` and qwen2.5-3b
  under ``pure-dp``, against ``make_train_fn`` with the same keywords on the
  whole batch (a batch of 4, 8 under ``pure-dp``, which splits it over all
  4 ranks; ``accum_steps=3`` drops rows, as the reference does).  Where the
  batch splits over a data axis, a MoE's aux loss is the mean of the data
  ranks' own, as ``make_train_step`` takes it, so the reference's
  ``loss_fn`` is taken so too;
- (c) ``grad_dtype="bfloat16"`` on the (2, 2) mesh for the same three archs,
  against ``make_train_fn``'s bf16 step, and bitwise the same step with
  ``compress`` and ``accum_steps`` set;
- the collectives of one step under the census (``launch/dryrun.py``): an
  accumulated step runs exactly those of a plain one, so each leaf is
  gathered and reduce-scattered once a step; compression adds only
  all-reduces of one number a tensor.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import _layer_groups, make_train_step
from torch_parity import run_ranks

MESHES = {"2x2": 2, "1x4": 4}  # mesh name -> model axis size, over 4 ranks
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=50)
PARAM_TOL = 1e-3 * OCFG["lr"]  # test_torch_train.py's bars
MOMENT_TOL = 1e-4
GRAD_TOL = 1e-4
GRAD_TOL_BF16 = 2**-8
# A sharded bf16 step rounds each rank's partial gradient to bf16 and sums the parts in bf16 (the reduction
# on the wire is bf16, as the reference's make_train_fn says of it), where the whole-batch step rounds the
# sum once; the parts may each exceed the sum.  On the (2, 2) mesh that measured up to 0.0081 of a leaf's
# largest (mamba2-780m's d_skip; 0.0075 for qwen2.5-3b) against make_train_fn's bf16 step, whose own
# gradients meet GRAD_TOL_BF16 against the reference's: four bf16 unit roundoffs of the leaf's largest
GRAD_TOL_BF16_SHARDED = 4 * GRAD_TOL_BF16
TOL = 1e-4
FLIPS = 1e-3  # of the elements, where a compressed gradient may sit across a rounding or threshold boundary
ARCH_LAYOUTS = (("mamba2-780m", "baseline"), ("qwen2.5-3b", "baseline"), ("deepseek-moe-16b", "baseline"),
                ("qwen2.5-3b", "pure-dp"))
HOOKS = [(a, c) for a in (2, 3) for c in ("none", "int8", "topk")]
CASES = [(n, lay, a, c) for n, lay in ARCH_LAYOUTS for a, c in HOOKS]
BF16_NAMES = ("mamba2-780m", "qwen2.5-3b", "deepseek-moe-16b")
BF16_HOOKS = dict(compress="int8", accum_steps=2)
CENSUS = (("mamba2-780m", "baseline"), ("qwen2.5-3b", "dp-only"))
CENSUS_HOOKS = ((1, "none"), (2, "none"), (2, "int8"), (2, "topk"))
# (a): each stacked tensor's name, whole shape (layers first) and draw; ties draws multiples of 1/8 in [-3/4, 3/4]
TENSORS = (("layers.mlp.gate", (3, 8, 12), "normal"), ("layers.attn.wq", (2, 12, 8), "ties"),
           ("final_norm.scale", (7,), "ties"), ("layers.ssm.d_skip", (3, 4), "zeros"),
           ("embedding.embed", (16, 12), "normal"))
PLACEMENTS = ("sharded", "replicated", "replicate_shard", "shard_replicate", "each_its_own")

RANK = """
import dataclasses
import numpy as np
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import ARCHS
from repro_torch.convert import STACKED
from repro_torch.data.pipeline import DataConfig, host_batch
import repro_torch.launch.dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.compress import compress_grads
import repro_torch.train.step as S

MODEL = {model}
OCFG = {ocfg!r}
TENSORS, PLACEMENTS = {tensors!r}, {placements!r}
CASES, BF16_NAMES, BF16_HOOKS = {cases!r}, {bf16_names!r}, {bf16_hooks!r}
CENSUS, CENSUS_HOOKS = {census!r}, {census_hooks!r}
mesh = make_host_mesh(model=MODEL, device="cpu")
data = rules.mesh_axes(mesh)["data"]
result = {{"coordinate": mesh.get_coordinate()}}


# ---- (a) the sharded compression alone, on identical gradients
rng = np.random.default_rng(0)  # the same draws on every rank
draws = {{"normal": lambda s: rng.standard_normal(s), "ties": lambda s: rng.integers(-6, 7, s) / 8,
          "zeros": lambda s: np.zeros(s)}}
whole = {{name: torch.from_numpy(draws[kind](shape).astype(np.float32)) for name, shape, kind in TENSORS}}
PATTERNS = [lambda nd: [Shard(0), Shard(nd - 1)], lambda nd: [Replicate(), Replicate()],
            lambda nd: [Replicate(), Shard(0)], lambda nd: [Shard(nd - 1), Replicate()]]


def per_layer(stacked):
    out = {{}}
    for key, a in stacked.items():
        stack, _, leaf = key.partition(".")
        out.update({{f"{{stack}}.{{i}}.{{leaf}}": a[i] for i in range(a.shape[0])}} if stack in STACKED else {{key: a}})
    return out


leaves = per_layer(whole)
compressed = {{}}
for method in ("int8", "topk"):
    want = compress_grads(whole, method=method)
    for case in PLACEMENTS:
        placed = {{}}
        for j, (key, names) in enumerate(S._layer_groups(leaves).items()):
            pattern = PATTERNS[j % 4 if case == "each_its_own" else PLACEMENTS.index(case)]
            for n in names:
                placed[n] = distribute_tensor(leaves[n], mesh, pattern(leaves[n].ndim), src_data_rank=None)
        with torch.no_grad(), dr.Census() as census:  # as the step runs it
            local = S._compress_shards(method, placed)
        got = S._stack_layers({{n: DTensor.from_local(local[n], mesh, placed[n].placements, shape=placed[n].shape,
                                                     stride=placed[n].stride()).full_tensor() for n in placed}})
        compressed[method, case] = {{
            "equal": {{k: torch.equal(got[k], want[k]) for k in want}},
            "local_numel": {{n: (placed[n].to_local().numel(), placed[n].numel()) for n in placed}},
            "collectives": [(c.op, c.operand_bytes) for c in census.trace.collectives],
            "kept": {{k: int((want[k] != 0).sum()) for k in want}}}}
result["compress"] = compressed


# ---- (b), (c): the sharded step with its hooks, against make_train_fn on the whole batch
def build(name, layout):
    cfg = ARCHS[name].reduced()
    if cfg.family == "moe":  # no token drops: a microbatch routes alike, whole or split over the data ranks
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    return rules.pad_config_for_mesh(cfg, mesh, layout)


def init(cfg):
    return get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def batch_of(cfg, layout):
    hb = host_batch(cfg, DataConfig(seq_len=24, global_batch=8 if layout in ("dp-only", "pure-dp") else 4, seed=0), 0)
    return {{k: torch.from_numpy(v) for k, v in hb.items()}}


seen = []
update = adamw.update


def spy(c, grads, state, p, **kw):
    seen.append(grads)
    return update(c, grads, state, p, **kw)


adamw.update = spy


def sharded(name, layout, trees, **kw):
    cfg = build(name, layout)
    model = init(cfg)
    step, _, pspecs, _, ospecs = S.make_train_step(cfg, mesh, adamw.AdamWConfig(**OCFG), layout=layout, **kw)
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    opt = rules.distribute(adamw.init(model), ospecs)
    seen.clear()
    _, _, metrics = step(params, opt, batch_of(cfg, layout))
    (grads,) = seen
    mu = opt["mu"]
    gathered = dict(params={{n: p.full_tensor() for n, p in params.items()}},  # a collective: on every rank
                    mu={{n: t.full_tensor() for n, t in mu.items()}},
                    nu={{n: t.full_tensor() for n, t in opt["nu"].items()}},
                    grads={{n: DTensor.from_local(grads[n], mesh, mu[n].placements, shape=mu[n].shape,
                                                 stride=mu[n].stride()).full_tensor() for n in params}})
    return {{"metrics": {{k: v.item() for k, v in metrics.items()}}, "step": int(opt["step"].to_local()),
             **(gathered if trees else {{}})}}


def data_mean_aux(cfg, model, batch):
    \"\"\"loss_fn with a MoE's aux loss the mean of the data ranks' own where the batch's
    rows split over the data axis, as make_train_step takes it.\"\"\"
    rows = batch["tokens"].shape[0]
    parts = data if rows % data == 0 else 1
    n, count = rows // parts, (batch["labels"] >= 0).to(torch.float32).sum().clamp(min=1.0)
    loss = 0.0
    for i in range(parts):
        part = {{k: v[i * n:(i + 1) * n] for k, v in batch.items()}}
        logits, aux = T.forward(cfg, model, part)
        loss = loss + T.nll_sum(logits, part["labels"])[0] / count + 0.01 * aux / parts
    return loss


def whole_batch(name, layout, **kw):
    cfg = build(name, layout)
    model, loss_fn = init(cfg), T.loss_fn
    T.loss_fn = data_mean_aux if cfg.family == "moe" and layout == "baseline" and data > 1 else loss_fn
    try:
        fn = S.make_train_fn(cfg, adamw.AdamWConfig(**OCFG), **kw)
    finally:
        T.loss_fn = loss_fn
    opt = adamw.init(model)
    seen.clear()
    _, _, metrics = fn(model, opt, batch_of(cfg, layout))
    (grads,) = seen
    return {{"metrics": {{k: v.item() for k, v in metrics.items()}},
             "params": {{n: p.detach() for n, p in model.named_parameters()}},
             "mu": opt["mu"], "nu": opt["nu"], "grads": grads}}


steps, refs = {{}}, {{}}
jobs = [(case, dict(accum_steps=case[2], compress=case[3])) for case in CASES]
if MODEL == 2:
    for name in BF16_NAMES:
        jobs.append(((name, "baseline", "bfloat16"), dict(grad_dtype="bfloat16")))
        jobs.append(((name, "baseline", "bfloat16", "hooks"), dict(grad_dtype="bfloat16", **BF16_HOOKS)))
for i, (key, kw) in enumerate(jobs):
    steps[key] = sharded(key[0], key[1], rank == 0, **kw)
    if i % world == rank and key[-1] != "hooks":  # the ranks share the whole-batch steps
        refs[key] = whole_batch(key[0], key[1], **kw)
result["steps"], result["refs"] = steps, refs


# ---- the collectives of one step, by hooks: the step's own, and those inside the model's forwards and backwards
census, marks = {{}}, []
loss_and_grad = S._loss_and_grad


def spy_loss_and_grad(*args):
    start = len(counted.trace.collectives)
    out = loss_and_grad(*args)
    marks.append((start, len(counted.trace.collectives)))
    return out


S._loss_and_grad = spy_loss_and_grad
for name, layout in CENSUS:
    cfg = build(name, layout)
    for a, c in CENSUS_HOOKS:
        model = init(cfg)
        step, _, pspecs, _, ospecs = S.make_train_step(cfg, mesh, adamw.AdamWConfig(**OCFG), layout=layout,
                                                       accum_steps=a, compress=c)
        params = rules.distribute(dict(model.named_parameters()), pspecs)
        opt = rules.distribute(adamw.init(model), ospecs)
        marks.clear()
        with dr.Census() as counted:
            step(params, opt, batch_of(cfg, layout))
        every = [(x.op, x.operand_bytes, x.result_bytes, x.group_size) for x in counted.trace.collectives]
        inside = {{i for start, end in marks for i in range(start, end)}}
        model = {{}}
        for i in sorted(inside):
            count, nbytes = model.get(every[i][0], (0, 0))
            model[every[i][0]] = (count + 1, nbytes + every[i][1])
        model_dim = mesh.mesh_dim_names.index("model")
        replicated = sum(4 * p.numel() for p in params.values() if not isinstance(p.placements[model_dim], Shard))
        census[name, layout, a, c] = {{"step": [x for i, x in enumerate(every) if i not in inside], "model": model,
                                       "forwards": len(marks), "leaves": len(params), "replicated_bytes": replicated,
                                       "tensors": len(S._layer_groups(params))}}
result["census"] = census
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's 4 ranks' results, both groups run at once."""
    import concurrent.futures

    dirs = {mesh: tmp_path_factory.mktemp(f"hooks{mesh}") for mesh in MESHES}  # not from two threads at once

    def one(mesh):
        code = RANK.format(model=MESHES[mesh], ocfg=OCFG, tensors=TENSORS, placements=PLACEMENTS, cases=CASES,
                           bf16_names=BF16_NAMES, bf16_hooks=BF16_HOOKS, census=CENSUS, census_hooks=CENSUS_HOOKS)
        return run_ranks(code, 4, dirs[mesh])

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(one, MESHES)))


def _ref(ranks, key):
    (ref,) = [r["refs"][key] for r in ranks if key in r["refs"]]
    return ref


# ------------------------------------------------------------ (a) compression
@pytest.mark.parametrize("placements", PLACEMENTS)
@pytest.mark.parametrize("method", ("int8", "topk"))
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_compression_is_bitwise_compress_grads(ranks, mesh, method, placements):
    """Each stacked tensor compressed on its shards, gathered, equals compress_grads of
    the whole tensor bitwise on every rank: ties at the threshold kept (top-k keeps
    more than k of the tied tensors), k = 1 for the 7-element tensor, an all-zero
    tensor kept whole.  Only all-reduces cross the wire, each of one number a
    stacked tensor (int8: one f32 max; top-k: 31 rounds of int64 counts), an
    axis of the mesh wider than 1; where a placement shards, no rank holds more
    than its shard."""
    tensors = len(TENSORS)
    axes = 2 if mesh == "2x2" else 1
    for r in ranks[mesh]:
        got = r["compress"][method, placements]
        assert all(got["equal"].values()), got["equal"]
        per = 4 if method == "int8" else 8
        assert got["collectives"] == [("all-reduce", per * tensors)] * (axes * (1 if method == "int8" else 31))
        if placements == "sharded":  # each rank holds at most about half of every leaf
            assert all(local <= numel // 2 + 1 for local, numel in got["local_numel"].values()), got["local_numel"]
    kept = ranks[mesh][0]["compress"]["topk", "sharded"]["kept"]
    assert kept["final_norm.scale"] >= 1 and kept["layers.ssm.d_skip"] == 0
    assert kept["layers.attn.wq"] > max(1, int(2 * 12 * 8 * 0.01))  # ties at the threshold all kept


# --------------------------------------------------- (b), (c) the step itself
def _flips(port, ref, names, method):
    """The elements of each leaf where the two compressed gradients differ by more than
    GRAD_TOL of the leaf's largest, each checked to sit on a boundary: an int8
    element within one quantum of the reference's (its stacked tensor's max over
    127), a top-k element within 1e-3 rel. of the reference's threshold (its
    stacked tensor's least kept |g|)."""
    out = {}
    for key, members in _layer_groups(names).items():
        rg = torch.stack([ref[n].to(torch.float32) for n in members])
        nonzero = rg.abs()[rg != 0]
        quantum = rg.abs().max() / 127
        thresh = nonzero.min() if nonzero.numel() else torch.tensor(0.0)
        for n in members:
            g, want = port[n].to(torch.float32), ref[n].to(torch.float32)
            miss = (g - want).abs() > GRAD_TOL * want.abs().max()
            if method == "int8":
                assert ((g - want).abs()[miss] <= quantum * (1 + 1e-5)).all(), (n, "past one quantum")
            elif method == "topk":
                near = torch.maximum(g.abs(), want.abs())[miss]
                assert ((near - thresh).abs() <= 1e-3 * thresh).all(), (n, "away from the threshold", thresh)
            out[n] = miss
    return out


def _check(got, ref, grad_tol, method):
    """Loss, lr, grad norm, the gradients AdamW was given, the params and moments after
    the step, at test_torch_train.py's bars.  With compression, at most FLIPS of the
    elements may differ past the gradient bar, each on a rounding or threshold
    boundary (``_flips``); those elements are left out of the param and moment bars.
    A param may miss PARAM_TOL only where its clipped gradient's sign is not settled
    at the gradient's bar (AdamW's first step moves it by about lr times that sign):
    within 100 eps of zero, as test_torch_train.py has it (and at most 1e-3 of the
    elements), or, in bf16, within ``grad_tol`` of the leaf's largest."""
    ocfg = adamw.AdamWConfig(**OCFG)
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=TOL, atol=TOL, err_msg=k)
    assert got["step"] == 1
    names = list(ref["params"])
    assert sorted(got["params"]) == sorted(names)
    flips = _flips(got["grads"], ref["grads"], names, method) if method != "none" else {}
    clip = min(1.0, ocfg.grad_clip / (ref["metrics"]["grad_norm"] + 1e-9))
    bf16 = ref["grads"][names[0]].dtype == torch.bfloat16
    noisy = []
    for n in names:
        g, want = got["grads"][n].to(torch.float32), ref["grads"][n].to(torch.float32)
        skip = flips.get(n, torch.zeros(g.shape, dtype=torch.bool))
        ok = (g - want).abs() <= grad_tol * want.abs().max() + TOL * want.abs()
        assert bool((ok | skip).all()), f"grad {n}"
        miss = ((got["params"][n] - ref["params"][n]).abs() > PARAM_TOL) & ~skip
        unsettled = grad_tol * float(want.abs().max()) * clip if bf16 else 100 * ocfg.eps
        noisy += [(n, float(x), unsettled) for x in (want * clip)[miss]]
        for m in ("mu", "nu"):
            far = ((got[m][n] - ref[m][n]).abs() > MOMENT_TOL) & ~skip
            assert not bool(far.any()), f"{m} {n}"
    elements = sum(t.numel() for t in ref["params"].values())
    assert sum(int(f.sum()) for f in flips.values()) <= FLIPS * elements
    assert all(abs(x) <= bar for _, x, bar in noisy), [x for x in noisy if abs(x[1]) > x[2]]
    if not bf16:  # bf16 leaves many small gradients (an embedding's rare tokens) below its bar
        assert len(noisy) <= 1e-3 * elements, len(noisy)


@pytest.mark.parametrize("accum_steps,compress", HOOKS)
@pytest.mark.parametrize("name,layout", ARCH_LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_hooked_step_matches_whole_batch_step(ranks, mesh, name, layout, accum_steps, compress):
    """make_train_step with accum_steps and compress against make_train_fn with the same
    keywords on the whole batch: every rank reports the same metrics, and rank 0's
    gathered params, moments and compressed gradients meet the bars of ``_check``."""
    key = (name, layout, accum_steps, compress)
    got = [r["steps"][key] for r in ranks[mesh]]
    assert all(g["metrics"] == got[0]["metrics"] for g in got)
    _check(got[0], _ref(ranks[mesh], key), GRAD_TOL, compress)


@pytest.mark.parametrize("name", BF16_NAMES)
def test_bf16_step_matches_whole_batch_step_and_ignores_the_hooks(ranks, name):
    """grad_dtype="bfloat16" on the (2, 2) mesh against make_train_fn's bf16 step, its
    gradients at GRAD_TOL_BF16_SHARDED; with compress and accum_steps set it neither
    accumulates nor compresses, as the reference: bitwise the same step."""
    key = (name, "baseline", "bfloat16")
    plain, hooked = ranks["2x2"][0]["steps"][key], ranks["2x2"][0]["steps"][(*key, "hooks")]
    assert plain["metrics"] == hooked["metrics"]
    for tree in ("params", "mu", "nu", "grads"):
        assert all(torch.equal(t, hooked[tree][n]) for n, t in plain[tree].items()), tree
    assert all(r["steps"][key]["metrics"] == plain["metrics"] for r in ranks["2x2"])
    _check(plain, _ref(ranks["2x2"], key), GRAD_TOL_BF16_SHARDED, "none")


@pytest.mark.parametrize("name,layout", CENSUS)
@pytest.mark.parametrize("mesh", MESHES)
def test_accumulated_step_runs_the_collectives_of_a_plain_step(ranks, mesh, name, layout):
    """Under the census, the collectives of one step, split into the step's own and
    those inside the model's forwards and backwards (the TP region ops).  With
    accum_steps=2 the step's own are exactly the plain step's, in order and bytes:
    each leaf gathered once, and its gradient reduce-scattered (all-reduced where
    its placements replicate it over the batch's axes) once, one loss all-reduce.
    Inside, the model runs twice on half the rows: twice the region ops, moving
    the activations' bytes once in all, and the gradient of each leaf replicated
    over the model axis that a region reads through ``tp.copy`` (an SSM's B/C
    projections and convs) once a microbatch, at most the replicated leaves'
    bytes more.  With compression, the step's own gain one block after the
    gradient reduction: all-reduces of one number a stacked tensor (an f32 max
    for int8; 31 rounds of int64 counts for top-k), one an axis of the mesh
    wider than 1."""
    axes = [2, 2] if mesh == "2x2" else [4]
    for r in ranks[mesh]:
        census = {k[2:]: v for k, v in r["census"].items() if k[:2] == (name, layout)}
        plain, accum = census[1, "none"], census[2, "none"]
        ops = [c[0] for c in plain["step"]]
        # the leaves split over a data axis (all but the (1, 4) mesh's TP step, which keeps each in model shards)
        split = not (mesh == "1x4" and layout == "baseline")
        assert (ops.count("all-gather") > 0) == split and (ops.count("reduce-scatter") > 0) == split
        assert (plain["forwards"], accum["forwards"]) == (1, 2)
        assert accum["step"] == plain["step"]
        assert bool(plain["model"]) == (layout == "baseline")  # tensor parallel: region ops inside the model
        for op, (n, nbytes) in plain["model"].items():
            extra = accum["model"][op][1] - nbytes
            assert accum["model"][op][0] == 2 * n and 0 <= extra <= plain["replicated_bytes"], (op, extra)
        tensors = plain["tensors"]
        assert tensors < plain["leaves"]
        for c, rounds, width in (("int8", 1, 4), ("topk", 31, 8)):
            got, want = census[2, c]["step"], plain["step"]
            block = [("all-reduce", width * tensors, width * tensors, size) for _ in range(rounds) for size in axes]
            assert any(got == want[:i] + block + want[i:] for i in range(len(want) + 1)), (c, got)
            assert census[2, c]["model"] == accum["model"]


def test_unknown_keyword_is_refused():
    """make_train_step takes make_train_fn's keywords and refuses any other, as a
    Python signature does."""
    with pytest.raises(TypeError):
        make_train_step(ARCHS["mamba2-780m"].reduced(), None, error_feedback=True)


def test_layer_groups_follow_the_reference_stacking():
    """_layer_groups: each layer leaf's names under its stacked name, in layer order
    (10 after 9), every other name alone; the specs of one stacked tensor's layers
    agree, so that its shards share one placement."""
    names = [f"layers.{i}.mlp.gate" for i in (10, 2, 9)] + ["embedding.embed", "dec_layers.0.attn.wq"]
    assert _layer_groups(names) == {"layers.mlp.gate": ["layers.2.mlp.gate", "layers.9.mlp.gate",
                                                        "layers.10.mlp.gate"],
                                    "embedding.embed": ["embedding.embed"],
                                    "dec_layers.attn.wq": ["dec_layers.0.attn.wq"]}
    from types import SimpleNamespace

    from repro_torch.models import get_model
    cfg = ARCHS["mamba2-780m"].reduced()
    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    specs = rules.param_specs(cfg, SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2)), model)
    for names in _layer_groups(specs).values():
        assert len({specs[n] for n in names}) == 1, names
