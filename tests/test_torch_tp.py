"""Tensor parallelism over the model axis (``repro_torch.sharding.tp`` and the
sharded steps of ``train/step.py``), on the CPU.

Two groups of 4 gloo ranks (``torch_parity.run_ranks``), one over a (2, 2)
mesh and one over a (1, 4) mesh ("data", "model"), each in its own
processes, both started together.  On each rank, with inputs made from a
numpy seed:

- each region op (``copy`` into a column- then row-parallel product closed by
  ``reduce``, ``all_reduce`` inside the split gated norm, ``gather``) and the
  vocab-parallel embedding and ``nll_sum``, against the plain op on the whole
  tensor, forward and backward;
- the Mamba2 mixer, an attention layer (kv heads split at tp = 2, replicated
  at tp = 4; with padded q heads; through the flash entry point), an MLP, a
  MoE layer (and its routing), whisper's GELU MLP (``wo`` row-parallel) and
  its cross-attention with their leaves sharded, against the unsharded
  module: output, input gradient and each leaf's gradient; the decode's
  cross-attention over frames split over the model axis, and whole;
- ``tp.all_to_all`` under ``launch/dryrun.py``'s census: the values and the
  price of the collective;
- ``make_train_step`` of every family (mamba2-780m, qwen2.5-3b, zamba2-2.7b,
  internvl2-26b, deepseek-moe-16b and whisper-medium, reduced) under
  ``baseline``, against ``make_train_fn``'s step on the whole batch (a MoE's
  aux loss the mean of the data ranks' own, as ``make_train_step`` takes it),
  at ``test_torch_train.py``'s bars, with each leaf as the model saw it and
  the heads the scan and the attention were given;
- ``tp.softmax_combine`` over 4 shards of a masked sequence, against
  ``torch.softmax`` over the whole of it;
- ``make_prefill_step`` of the same four, then 6 greedy ``make_decode_step``
  calls from its cache, against the unsharded functions: a batch of 4 whose
  decode crosses a boundary between two ranks' sequence shards, a batch of 1
  (its sequence split over every axis on the 2x2 mesh), and a sequence that
  divides no model axis (head-parallel attention over the whole of it), and
  for whisper encoder frames that divide no model axis;
- the sharded decode of qwen2.5-3b, internvl2-26b, deepseek-moe-16b and
  whisper-medium, from the reference's perturbed params, against the JAX
  package's ``prefill`` and ``decode_step``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from torch_parity import run_ranks

MESHES = {"2x2": 2, "1x4": 4}  # mesh name -> model axis size, over 4 ranks
ARCH_NAMES = ("mamba2-780m", "qwen2.5-3b", "zamba2-2.7b", "internvl2-26b", "deepseek-moe-16b", "whisper-medium")
KV_NAMES = ARCH_NAMES[1:]  # the families with a K/V cache
REF_NAMES = ("qwen2.5-3b", "internvl2-26b", "deepseek-moe-16b", "whisper-medium")  # against the reference's decode
REF_STEPS = 6
OPS = ("copy_reduce", "all_reduce", "gather", "embed_lookup", "nll_sum")
LAYERS = ("mamba2_mixer", "attention", "attention_padded_heads", "mlp", "moe", "gelu_mlp", "cross_attention")
FRAMES = {"divided": 32, "undivided": 31}  # encoder frames: 32 divide both model axes, 31 neither
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=50)
PARAM_TOL = 1e-3 * OCFG["lr"]  # test_torch_train.py's bars
MOMENT_TOL = 1e-4
TOL = 1e-4

RANK = """
import dataclasses
from types import SimpleNamespace
import numpy as np
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, layers
from repro_torch.models import encdec as E
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
import repro_torch.launch.dryrun as dr
from repro_torch.sharding import rules, tp
import repro_torch.train.step as S

MODEL = {model}
ARCH_NAMES = {arch_names!r}
OCFG = {ocfg!r}
TOL = {tol!r}
REF_NAMES, REF_DIR = {ref_names!r}, {ref_dir!r}
FRAMES = {frames!r}
mesh = make_host_mesh(model=MODEL, device="cpu")
g = tp.Group(mesh.get_group("model"), mesh.get_local_rank("model"), MODEL)
rng = np.random.default_rng(0)  # the same draws on every rank
result = {{"coordinate": mesh.get_coordinate()}}


def t(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def mine(x, dim):
    n = x.shape[dim] // MODEL
    return x.narrow(dim, g.rank * n, n)


def value_and_grads(fn, *xs, weight):
    \"\"\"fn(*xs), and the gradients of sum(fn(*xs) * weight) with respect to xs.\"\"\"
    xs = [x.detach().clone().requires_grad_() for x in xs]
    y = fn(*xs)
    return y.detach(), [d.detach() for d in torch.autograd.grad((y * weight).sum(), xs)]


def err(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def compare(sharded, plain, picks):
    \"\"\"Relative max errors of the sharded output and gradients against the plain
    ones, each plain one first cut by ``picks`` (this rank's part, or whole): the
    output's pick first, then one per input.\"\"\"
    (ys, gs), (yp, gp) = sharded, plain
    return [err(a, pick(b)) for a, b, pick in zip([ys, *gs], [yp, *gp], picks)]


def whole(x):
    return x


# ---- the region ops, against plain ops on whole tensors
ops = {{}}
x, w1, w2, r = t(6, 8), t(8, 16), t(16, 8), t(6, 8)
ops["copy_reduce"] = compare(
    value_and_grads(lambda x, a, b: tp.reduce(torch.nn.functional.silu(tp.copy(x, g) @ a) @ b, g),
                    x, mine(w1, 1), mine(w2, 0), weight=r),
    value_and_grads(lambda x, a, b: torch.nn.functional.silu(x @ a) @ b, x, w1, w2, weight=r),
    [whole, whole, lambda d: mine(d, 1), lambda d: mine(d, 0)])
x, scale, r = t(3, 5, 16), t(16), t(3, 5, 16)
ops["all_reduce"] = compare(  # each rank's loss term is its part's; their sum is the plain loss
    value_and_grads(lambda x, s: layers.rmsnorm_split(SimpleNamespace(scale=s), x, 1e-5, g), mine(x, -1), scale,
                    weight=mine(r, -1)),
    value_and_grads(lambda x, s: layers._rms(x, s, 1e-5), x, scale, weight=r),
    [lambda d: mine(d, -1), lambda d: mine(d, -1), whole])
x, r = t(3, 4, 12), t(3, 4, 12)
ops["gather"] = compare(value_and_grads(lambda x: tp.gather(x, -1, g), mine(x, -1), weight=r),
                        value_and_grads(lambda x: x * 1.0, x, weight=r), [whole, lambda d: mine(d, -1)])
table, tokens, r = t(32, 8), torch.from_numpy(rng.integers(0, 32, (3, 7))), t(3, 7, 8)
ops["embed_lookup"] = compare(
    value_and_grads(lambda tb: tp.embed_lookup(tb, tokens, torch.float32, g), mine(table, 0), weight=r),
    value_and_grads(lambda tb: tb[tokens], table, weight=r), [whole, lambda d: mine(d, 0)])
logits = 3 * t(3, 7, 32)
labels = torch.from_numpy(rng.integers(-1, 32, (3, 7)))  # -1: ignored
one = torch.ones(())
ops["nll_sum"] = compare(value_and_grads(lambda lg: tp.nll_sum(lg, labels, g)[0], mine(logits, -1), weight=one),
                         value_and_grads(lambda lg: T.nll_sum(lg, labels)[0], logits, weight=one),
                         [whole, lambda d: mine(d, -1)])
ops["nll_sum_count"] = [float(tp.nll_sum(mine(logits, -1), labels, g)[1]), float(T.nll_sum(logits, labels)[1])]
result["ops"] = ops


# ---- layers with their leaves sharded, against the unsharded module
def build(name, **changes):
    cfg = rules.pad_config_for_mesh(dataclasses.replace(ARCHS[name].reduced(), **changes), mesh)
    return cfg, get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def layer_check(cfg, model, prefix, fn, x, out_shape=None):
    \"\"\"fn(module, x) (of ``out_shape``, else x's) on the unsharded layer and on a TP
    shell's layer holding this rank's shards: [output, input gradient, each leaf's
    gradient] relative errors, and the local leaf shapes.\"\"\"
    specs = rules.param_specs(cfg, mesh, model)
    plain_mod = model.get_submodule(prefix)
    names = [n for n, _ in plain_mod.named_parameters()]
    full = [p.detach() for _, p in plain_mod.named_parameters()]
    shards = [rules.model_shard(rules.tp_spec(n, specs[f"{{prefix}}.{{n}}"]), tuple(p.shape), mesh)
              for n, p in zip(names, full)]
    shell = S._shell(cfg, "cpu", g).get_submodule(prefix)
    r = t(*(out_shape or x.shape))

    def run(module, x, *leaves):
        leaves = {{f"model.{{n}}": p for n, p in zip(names, leaves)}}
        return torch.func.functional_call(S._Apply(module, fn), leaves, (x,))

    local = [p if s is None else p.narrow(*s) for p, s in zip(full, shards)]
    got = value_and_grads(lambda x, *ls: run(shell, x, *ls), x, *local, weight=r)
    want = value_and_grads(lambda x, *ls: run(plain_mod, x, *ls), x, *full, weight=r)
    picks = [whole, whole] + [whole if s is None else (lambda d, s=s: d.narrow(*s)) for s in shards]
    return {{"errs": dict(zip(["out", "x"] + names, compare(got, want, picks))),
             "local": {{n: tuple(p.shape) for n, p in zip(names, local)}},
             "split": [n for n, s in zip(names, shards) if s is not None]}}


lay = {{}}
heads = []
ssd_scan, flash = ssd_ops.ssd_scan, fa_ops.flash_attention


def spy_ssd(x, dt, a, b, c, chunk):
    heads.append(("ssd_scan", x.shape[2]))
    return ssd_scan(x, dt, a, b, c, chunk=chunk)


def spy_flash(q, k, v, window=0):
    heads.append(("flash_attention", q.shape[2], k.shape[2]))
    return flash(q, k, v, window=window)


ssd_ops.ssd_scan, fa_ops.flash_attention = spy_ssd, spy_flash
cfg, model = build("mamba2-780m")
x = t(2, 24, cfg.d_model)
lay["mamba2_mixer"] = layer_check(cfg, model, "layers.0.ssm", lambda m, x: m(x), x)
lay["mamba2_mixer"]["heads"] = heads[:]
pos = torch.arange(24)[None].expand(2, 24)
for key, changes in (("attention", {{"attention_impl": "flash"}}), ("attention_padded_heads", {{"num_heads": 6}})):
    cfg, model = build("qwen2.5-3b", **changes)
    heads.clear()
    lay[key] = layer_check(cfg, model, "layers.0.attn", lambda m, x, cfg=cfg: layers.attention(cfg, m, x, pos), x)
    lay[key]["heads"] = heads[:]
    lay[key]["padded"] = [cfg.num_heads, cfg.orig_num_heads, cfg.num_kv_heads]
cfg, model = build("qwen2.5-3b")
lay["mlp"] = layer_check(cfg, model, "layers.0.mlp", lambda m, x: layers.mlp(m, x, cfg.compute_dtype), x)

# the MoE layer, its output plus its aux loss (so that the router's gradient takes both paths); a
# shared direction in x crowds the router onto a few experts, past their capacity
routes, route = [], M.route


def spy_route(cfg, p, xt):
    out = route(cfg, p, xt)
    routes.append({{"topi": out[2].clone(), "slot": out[3].clone()}})
    return out


M.route = spy_route
cfg, model = build("deepseek-moe-16b")
x_moe = t(2, 24, cfg.d_model) + 2 * t(1, 1, cfg.d_model)
lay["moe"] = layer_check(cfg, model, "layers.0.moe", lambda m, x: (lambda o, a: o + a)(*M.moe_apply(cfg, m, x)), x_moe)
M.route = route
result["routing"] = {{"sharded": routes[0], "plain": routes[1], "capacity": M.capacity(cfg, 24)}}


def perturb(model):
    \"\"\"Every vector leaf (biases, norm scales) moved off its constant init, so that a bias
    added on every rank would show.\"\"\"
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(0.1 * t(*p.shape))
    return model


cfg, model = build("whisper-medium")
perturb(model)
lay["gelu_mlp"] = layer_check(cfg, model, "dec_layers.0.mlp", lambda m, x: layers.gelu_mlp(m, x, cfg.compute_dtype), x)
xc = t(2, 12 + cfg.encoder_frames, cfg.d_model)  # 12 query rows, then the encoder's frames
lay["cross_attention"] = layer_check(
    cfg, model, "dec_layers.0.cross_attn",
    lambda m, x: layers.cross_attention(cfg, m, x[:, :12], layers.cross_kv(cfg, m, x[:, 12:])), xc,
    (2, 12, cfg.d_model))
result["layers"] = lay


def cross_decode(frames):
    \"\"\"The decode's cross-attention of one token over ``frames`` encoder frames (every kv
    head), on this rank's shards against the unsharded layer: where the frames divide
    the model axis the rank holds its part of them (``seq_split``), else all.\"\"\"
    prefix = "dec_layers.0.cross_attn"
    plain = model.get_submodule(prefix)
    specs = rules.param_specs(cfg, mesh, model)
    shell = S._shell(cfg, "cpu", g).get_submodule(prefix)
    leaves = {{}}
    for n, p in plain.named_parameters():
        s = rules.model_shard(specs[f"{{prefix}}.{{n}}"], tuple(p.shape), mesh)
        leaves[f"model.{{n}}"] = p.detach() if s is None else p.detach().narrow(*s)
    hd = (cfg.num_kv_heads, cfg.resolved_head_dim)
    x, k, v = t(3, 1, cfg.d_model), t(3, frames, *hd), t(3, frames, *hd)
    fn = lambda m, x, k, v: layers.cross_attention_decode(cfg, m, x, (k, v))
    kl, vl = k, v
    if frames % MODEL == 0:
        n = frames // MODEL
        kvm = layers.kv_head_map(cfg.num_heads, cfg.num_kv_heads, cfg.orig_num_heads)
        shell.seq_split = tp.SeqSplit(g.rank * n, (g,), kvm)
        kl, vl = k[:, g.rank * n:(g.rank + 1) * n], v[:, g.rank * n:(g.rank + 1) * n]
    with torch.no_grad():
        got = torch.func.functional_call(S._Apply(shell, fn), leaves, (x, kl, vl))
        want = fn(plain, x, k, v)
    return {{"err": err(got, want), "split": shell.seq_split is not None, "frames_seen": kl.shape[1]}}


result["cross_decode"] = {{case: cross_decode(f) for case, f in FRAMES.items()}}

# tp.all_to_all under the census: a (8, 6 tp) tensor split over its columns, moved to a split over its rows
whole = t(8, 6 * MODEL)
with dr.Census() as census:
    rows = tp.all_to_all(mine(whole, 1), 0, 1, g)
back = tp.all_to_all(rows, 1, 0, g)
result["all_to_all"] = {{"rows": torch.equal(rows, mine(whole, 0)), "back": torch.equal(back, mine(whole, 1)),
                         "collectives": [dataclasses.asdict(c) for c in census.trace.collectives],
                         "wire": census.trace.collective_stats().wire_bytes}}


# ---- the sharded steps, against the unsharded functions
seen = {{}}
leaves = S._leaves


def spy_leaves(params, keep):
    out = leaves(params, keep)
    seen.setdefault("leaves", []).append({{n: t.clone() for n, t in out.items()}})
    return out


S._leaves = spy_leaves
steps = {{}}


def data_mean_aux_step(cfg, ocfg, model, opt, hb, parts):
    \"\"\"make_train_fn's step on the whole batch, but with a MoE's aux loss the mean of the
    ``parts`` data ranks' own over their rows, as make_train_step takes it.\"\"\"
    named = dict(model.named_parameters())
    count = (hb["labels"] >= 0).to(torch.float32).sum()
    n = hb["tokens"].shape[0] // parts
    loss = 0.0
    for i in range(parts):
        rows = {{k: v[i * n:(i + 1) * n] for k, v in hb.items()}}
        logits, aux = T.forward(cfg, model, rows)
        loss = loss + T.nll_sum(logits, rows["labels"])[0] / count + 0.01 * aux / parts
    grads = torch.autograd.grad(loss, list(named.values()))
    metrics = adamw.update(ocfg, dict(zip(named, grads)), opt, model)
    metrics["loss"] = loss.detach()
    return metrics
for name in ARCH_NAMES:
    cfg, model = build(name, **({{"attention_impl": "flash"}} if name != "mamba2-780m" else {{}}))
    init = {{n: p.detach().clone() for n, p in model.named_parameters()}}
    specs = rules.param_specs(cfg, mesh, model)
    hb = host_batch(cfg, DataConfig(seq_len=24, global_batch=4, seed=0), 0)
    hb = {{k: torch.from_numpy(v) for k, v in hb.items()}}
    ocfg = adamw.AdamWConfig(**OCFG)
    step, _, pspecs, _, ospecs = S.make_train_step(cfg, mesh, ocfg)
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    opt = rules.distribute(adamw.init(model), ospecs)
    seen.clear()
    heads.clear()
    _, _, metrics = step(params, opt, hb)
    (used,) = seen["leaves"]
    shard_of = {{n: (init[n] if (s := rules.model_shard(rules.tp_spec(n, specs[n]), tuple(init[n].shape), mesh))
                    is None else init[n].narrow(*s)) for n in init}}
    row = {{"metrics": {{k: v.item() for k, v in metrics.items()}}, "heads": heads[:],
            "used": {{n: (tuple(u.shape), tuple(shard_of[n].shape), torch.equal(u, shard_of[n]))
                     for n, u in used.items()}},
            "params": {{n: p.full_tensor() for n, p in params.items()}},
            "mu": {{n: v.full_tensor() for n, v in opt["mu"].items()}},
            "nu": {{n: v.full_tensor() for n, v in opt["nu"].items()}},
            "tp": S.model_group(cfg, mesh, "baseline") is not None}}
    if rank == 0:
        plain = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        popt = adamw.init(plain)
        data = rules.mesh_axes(mesh)["data"]
        if cfg.family == "moe" and data > 1:
            pm = data_mean_aux_step(cfg, ocfg, plain, popt, hb, data)
        else:
            _, _, pm = S.make_train_fn(cfg, ocfg)(plain, popt, hb)
        row["want"] = {{"metrics": {{k: v.item() for k, v in pm.items()}},
                       "params": {{n: p.detach() for n, p in plain.named_parameters()}},
                       "mu": popt["mu"], "nu": popt["nu"], "eps": ocfg.eps, "b1": ocfg.b1}}
    steps[name] = row

result["steps"] = steps


# ---- softmax_combine: 4 shards of a sequence, over the data then the model axis
groups = tuple(tp.Group(mesh.get_group(a), mesh.get_local_rank(a), rules.mesh_axes(mesh)[a]) for a in ("data", "model"))
index = mesh.get_local_rank("data") * MODEL + g.rank
logits, v = 3 * t(2, 3, 1, 32), t(2, 32, 3, 8)
kpos = torch.arange(32)
valid = (kpos <= 21) & (kpos > 21 - 12)  # pos 21, a window of 12: shards 0 and 3 wholly masked
logits = torch.where(valid, logits, -1e30)
want = torch.einsum("bhqs,bshd->bqhd", torch.softmax(logits, dim=-1), v)
mine_l, mine_v = logits[..., index * 8:(index + 1) * 8], v[:, index * 8:(index + 1) * 8]
top = mine_l.amax(dim=-1)
e = torch.exp(mine_l - top[..., None])
got = tp.softmax_combine(top, e.sum(dim=-1), torch.einsum("bhqs,bshd->bqhd", e, mine_v), groups)
result["softmax_combine"] = {{"err": (got - want).abs().max().item(),
                              "masked": not valid[index * 8:(index + 1) * 8].any().item()}}


# ---- the serving steps: a prefill, then greedy decode steps, against the unsharded functions
decoded, crossed, step_logits = [], [], []
attention_decode, cross_attention_decode = layers.attention_decode, layers.cross_attention_decode
decode_steps = {{T: T.decode_step, E: E.decode_step}}


def spy_attention_decode(cfg, p, x, cache, pos, **kw):
    decoded.append((tuple(cache["k"].shape), None if p.seq_split is None else p.seq_split.offset))
    return attention_decode(cfg, p, x, cache, pos, **kw)


def spy_cross_attention_decode(cfg, p, x, kv):
    crossed.append((tuple(kv[0].shape), None if p.seq_split is None else p.seq_split.offset))
    return cross_attention_decode(cfg, p, x, kv)


def spy_decode_step(mod):
    def spy(cfg, params, cache, tokens):
        logits, new = decode_steps[mod](cfg, params, cache, tokens)
        step_logits.append(logits)
        return logits, new
    return spy


T.attention_decode = E.attention_decode = spy_attention_decode
E.cross_attention_decode = spy_cross_attention_decode
T.decode_step, E.decode_step = spy_decode_step(T), spy_decode_step(E)


def flat(tree, prefix=""):
    return {{k: v for key, val in tree.items() for k, v in
            (flat(val, prefix + key + "/").items() if isinstance(val, dict) else [(prefix + key, val)])}}


def close(a, b):
    return [bool(torch.allclose(a, b, rtol=TOL, atol=TOL)), (a - b).abs().max().item()]


def first_row(n, whole):
    \"\"\"The first of the ``n`` rows of a batch of ``whole`` that this rank decodes: its
    data-axis part where the batch splits.\"\"\"
    return 0 if n == whole else mesh.get_local_rank("data") * n


def my_rows(local, whole):
    return whole.narrow(0, first_row(local.shape[0], whole.shape[0]), local.shape[0])


def serve(cfg, model, batch, max_len, steps, tokens=None):
    \"\"\"make_prefill_step, then ``steps`` make_decode_step calls from its cache, each
    against the unsharded functions on the whole batch: the logits, the next tokens
    and every cache leaf.  Each side feeds its own greedy tokens back, or ``tokens``
    where given.\"\"\"
    prefill, _, pspecs = S.make_prefill_step(cfg, mesh, max_len)
    decode, _, _ = S.make_decode_step(cfg, mesh)
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    seen.clear()
    logits, cache = prefill(params, batch)
    want_logits, want = S.make_prefill_fn(cfg, max_len)(model, batch)
    specs = rules.param_specs(cfg, mesh, model)
    shard_of = {{n: (p if (s := rules.model_shard(rules.tp_spec(n, specs[n]), tuple(p.shape), mesh)) is None
                    else p.narrow(*s)) for n, p in model.named_parameters()}}
    out = {{"prefill": {{"logits": close(logits.full_tensor(), want_logits),
                       **{{k: close(v.full_tensor(), flat(want)[k]) for k, v in flat(cache).items()}}}},
            "prefill_local": all(tuple(u.shape) == tuple(shard_of[n].shape) for n, u in seen["leaves"][0].items()),
            "placements": {{k: [str(p) for p in v.placements] for k, v in flat(cache).items()}},
            "logits": [logits.full_tensor()], "steps": []}}
    mine = want_next = torch.argmax(want_logits[:, -1], dim=-1).to(torch.int32)[:, None]
    for i in range(steps):
        tok = (mine, want_next) if tokens is None else (tokens[i], tokens[i])
        seen.clear()
        decoded.clear()
        crossed.clear()
        step_logits.clear()
        next_tok, cache = decode(params, cache, tok[0])
        (got_logits,), k_seen, cross_seen = step_logits, decoded[:], crossed[:]
        step_logits.clear()
        want_next, want = S.make_decode_fn(cfg)(model, want, tok[1])
        mine = next_tok.full_tensor()
        out["logits"].append(got_logits)
        out["steps"].append({{
            "pos": int(want["pos"]) - 1, "logits": close(got_logits, my_rows(got_logits, step_logits[0])),
            "next": torch.equal(mine, want_next), "cache": {{k: close(v.full_tensor(), flat(want)[k])
                                                          for k, v in flat(cache).items()}},
            "k_seen": k_seen, "cross_seen": cross_seen, "decode_local": all(tuple(u.shape) == tuple(shard_of[n].shape)
                                                 for n, u in seen["leaves"][0].items())}})
    for leaf in ("k", "cross_k"):
        if leaf in cache:
            out[leaf] = {{"placements": [str(p) for p in cache[leaf].placements], "global": tuple(cache[leaf].shape),
                         "local": tuple(cache[leaf].to_local().shape)}}
    out["decode_tp"] = S.model_group(cfg, mesh, "baseline") is not None
    return out


def prompt(cfg, b, seed=1, frames=FRAMES["divided"]):
    gen = torch.Generator().manual_seed(seed)
    batch = {{"tokens": torch.randint(0, cfg.vocab_size, (b, 12), generator=gen, dtype=torch.int32)}}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((b, cfg.num_patches, cfg.d_model), generator=gen)
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn((b, frames, cfg.d_model), generator=gen)
    return batch


# the main case: a batch of 4, 12 tokens (and a vlm's patches) in a sequence of 32 (48 for a vlm), so that
# the 6 decode steps write across the boundary at 16 (24) between two shards; a batch of 1, whose
# sequence splits over every axis on the 2x2 mesh; a sequence of 31 (47), which divides no model axis;
# for whisper, 31 encoder frames, which divide no model axis either
serving = {{}}
for name in ARCH_NAMES:
    cfg, model = build(name)
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    cases = {{"main": (4, 32, FRAMES["divided"])}}
    if name != "mamba2-780m":
        cases.update(batch1=(1, 32, FRAMES["divided"]), undivided=(4, 31, FRAMES["divided"]))
    if cfg.family == "encdec":
        cases.update(frames_undivided=(4, 32, FRAMES["undivided"]))
    for case, (b, seq, frames) in cases.items():
        seq += 16 if prefix else 0
        row = serve(cfg, model, prompt(cfg, b, frames=frames), seq - prefix, 6)
        row.pop("logits")
        serving[name, case] = row

# against the reference: the same params, batch and greedy tokens as its prefill and decode_step
for name in REF_NAMES:
    ref = torch.load(f"{{REF_DIR}}/{{name}}.pt", weights_only=False)
    cfg, model = build(name)
    model.load_state_dict(ref["state"])
    got = serve(cfg, model, ref["batch"], ref["max_len"], len(ref["tokens"]), ref["tokens"])["logits"]
    b = ref["batch"]["tokens"].shape[0]
    serving[name, "reference"] = [got[0], *[(first_row(lg.shape[0], b), lg) for lg in got[1:]]]
result["serving"] = serving
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each mesh's directory, holding for each of REF_NAMES the port's params loaded
    from the reference's perturbed tree (``torch_parity.build``, the vocabulary
    padded as ``rules.pad_config_for_mesh`` pads it there), the batch and the
    greedy tokens of the reference's prefill and ``decode_step``; and the
    reference's logits, prefill first."""
    import jax.numpy as jnp
    from repro.models import get_model as jax_get_model
    from torch_parity import batches, build, tokens

    out = {}
    for mesh, tp in MESHES.items():
        d = tmp_path_factory.mktemp(f"tp{mesh}")
        out[mesh] = (d, {})
        for name in REF_NAMES:
            cfg, params, jcfg, jparams = build(name, vocab_pad_multiple=128 * tp)
            batch, jbatch = batches(cfg, tokens(2, 12, cfg.vocab_size, seed=12), seed=12)
            max_len = 32 + (16 - cfg.num_patches if cfg.family == "vlm" else 0)
            jm = jax_get_model(jcfg)
            jlogits, jcache = jm.prefill(jcfg, jparams, jbatch, max_len)
            logits, toks = [np.asarray(jlogits)], []
            for _ in range(REF_STEPS):
                toks.append(np.argmax(logits[-1][:, -1], axis=-1).astype(np.int32)[:, None])
                jlogits, jcache = jm.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[-1]))
                logits.append(np.asarray(jlogits))
            torch.save({"state": {n: p.detach() for n, p in params.state_dict().items()}, "batch": batch,
                        "tokens": [torch.from_numpy(t) for t in toks], "max_len": max_len}, d / f"{name}.pt")
            out[mesh][1][name] = logits
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    """Each mesh's 4 ranks' results, both groups run at once."""
    import concurrent.futures

    def one(mesh):
        d = reference[mesh][0]
        code = RANK.format(model=MESHES[mesh], arch_names=ARCH_NAMES, ocfg=OCFG, tol=TOL, ref_names=REF_NAMES,
                           ref_dir=str(d), frames=FRAMES)
        return run_ranks(code, 4, d)

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(one, MESHES)))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mesh", MESHES)
def test_region_ops_match_plain_ops(ranks, mesh, op):
    """Forward and every input's gradient (this rank's part of a split one) within
    1e-5 of the plain op's largest, on every rank; ``nll_sum``'s count exactly."""
    for r in ranks[mesh]:
        errs = r["ops"][op]
        assert max(errs) < 1e-5, (op, errs)
        if op == "nll_sum":
            a, b = r["ops"]["nll_sum_count"]
            assert a == b


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("mesh", MESHES)
def test_layers_with_sharded_leaves_match_unsharded(ranks, mesh, layer):
    """The layer on this rank's shards (``rules.model_shard``) against the unsharded
    layer: output, input gradient and each leaf's gradient (the shard's part of a
    split leaf, the whole of a replicated one) within 1e-5 of their largest.  The
    scan and the attention see H/tp heads; qwen2.5-3b's 2 kv heads split at tp = 2
    and are read one a rank, from the replicated pair, at tp = 4; with 6 q heads,
    3 a rank at tp = 2, and padded to 8 at tp = 4.  The MoE layer's experts and
    shared expert split their hidden columns, its router stays whole (its
    gradient, through the routing weights and the aux loss, summed once); the
    GELU MLP's ``wo`` is held by rows (``rules.tp_spec``), its biases perturbed,
    so that ``bo`` added on every rank would show; the cross-attention's encoder
    frames are inputs too."""
    tp = MESHES[mesh]
    for r in ranks[mesh]:
        got = r["layers"][layer]
        assert max(got["errs"].values()) < 1e-5, got["errs"]
        assert got["split"], "no leaf was split over the model axis"
        if layer == "mamba2_mixer":
            h = ARCHS["mamba2-780m"].reduced().ssm_num_heads
            assert got["heads"] == [("ssd_scan", h // tp), ("ssd_scan", h)]  # sharded, then plain
            assert set(got["split"]) == {"wz", "wx", "wdt", "conv_x", "a_log", "dt_bias", "d_skip", "out_proj"}
        if layer == "attention":
            assert got["heads"] == [("flash_attention", 4 // tp, 1), ("flash_attention", 4, 2)]
            assert ("wk" in got["split"]) == (tp == 2)
        if layer == "attention_padded_heads":
            h = -(-6 // tp) * tp  # 6 q heads, padded to 8 at tp = 4
            assert got["padded"] == [h, 6 if h > 6 else 0, 2] and got["local"]["wq"][1] == h // tp
        if layer == "moe":
            assert set(got["split"]) == {"gate", "up", "down", "shared.gate", "shared.up", "shared.down"}
        if layer == "gelu_mlp":
            f, d = ARCHS["whisper-medium"].reduced().d_ff, ARCHS["whisper-medium"].reduced().d_model
            assert set(got["split"]) == {"wi", "bi", "wo"} and got["local"]["wo"] == (f // tp, d)
        if layer == "cross_attention":
            assert {"wq", "wo"} <= set(got["split"]) and ("wk" in got["split"]) == (tp == 2)


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_routing_is_the_unsharded_layers_on_every_rank(ranks, mesh):
    """The routing of the MoE layer above (its top-k experts, each pair's slot in its
    expert's queue, and so the pairs past capacity that drop) is replicated: on
    every rank equal to the unsharded layer's on the same input, and some pairs
    drop."""
    first = ranks[mesh][0]["routing"]
    assert int((first["plain"]["slot"] >= first["capacity"]).sum()) > 0
    for r in ranks[mesh]:
        got = r["routing"]
        for key in ("topi", "slot"):
            assert torch.equal(got["sharded"][key], got["plain"][key]), key
            assert torch.equal(got["sharded"][key], first["sharded"][key]), key


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_cross_attention_decode_over_frames_split_or_whole(ranks, mesh, frames):
    """One token's cross-attention in decode, on this rank's heads of the layer,
    against the unsharded layer, within 1e-5 of its largest: over 32 frames each
    rank holds its part of them (``seq_split``, every q head, the softmaxes
    combined); 31 divide neither model axis, and each rank's heads read all."""
    tp = MESHES[mesh]
    for r in ranks[mesh]:
        got = r["cross_decode"][frames]
        assert got["err"] < 1e-5, got
        assert got["split"] == (frames == "divided")
        assert got["frames_seen"] == (FRAMES[frames] // tp if frames == "divided" else FRAMES[frames])


@pytest.mark.parametrize("mesh", MESHES)
def test_census_prices_an_all_to_all(ranks, mesh):
    """``tp.all_to_all`` moves a (8, 6 tp) tensor's split over the model axis from its
    columns to its rows and back, exactly; ``launch/dryrun.py``'s census records
    the one collective as an all-to-all of its 192-byte operand (tp parts of (8 /
    tp, 6) f32) over tp ranks, priced at (tp - 1) / tp of its result."""
    tp = MESHES[mesh]
    for r in ranks[mesh]:
        got = r["all_to_all"]
        assert got["rows"] and got["back"]
        assert got["collectives"] == [{"op": "all-to-all", "operand_bytes": 192, "result_bytes": 192,
                                       "group_size": tp}]
        assert got["wire"] == 192 * (tp - 1) / tp


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_whole_batch_step(ranks, mesh, name):
    """make_train_step under ``baseline`` against make_train_fn's step on the whole
    batch: loss, lr and grad norm at 1e-4, every param at 1e-3 lr (where the
    clipped gradient is not within 100 eps of zero) and each AdamW moment at
    1e-4, as ``test_torch_train.py`` holds them; every rank reports the same
    metrics and the same gathered tree."""
    got = [r["steps"][name] for r in ranks[mesh]]
    want = got[0]["want"]
    for r in got:
        assert r["tp"] and r["metrics"] == got[0]["metrics"]
        for key in ("params", "mu", "nu"):
            assert all(torch.equal(t, got[0][key][n]) for n, t in r[key].items()), key
    r = got[0]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(r["metrics"][k], v, rtol=TOL, atol=TOL, err_msg=k)
    noisy = []
    for n, p in want["params"].items():
        g = (want["mu"][n] / (1 - want["b1"])).numpy()
        miss = np.abs(r["params"][n].numpy() - p.numpy()) > PARAM_TOL
        noisy += [float(x) for x in g[miss]]
        for m in ("mu", "nu"):
            np.testing.assert_allclose(r[m][n].numpy(), want[m][n].numpy(), atol=MOMENT_TOL, rtol=0, err_msg=f"{m} {n}")
    assert all(abs(x) < 100 * want["eps"] for x in noisy)
    assert len(noisy) <= 1e-3 * sum(p.numel() for p in want["params"].values())


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_computes_only_each_ranks_model_shards(ranks, mesh, name):
    """Every leaf the model computes with in the step is exactly this rank's
    model-axis shard of it (``rules.model_shard`` of its compute spec,
    ``rules.tp_spec``: a GELU MLP's ``wo`` by rows; whole where the spec keeps it
    whole over ``model``), and the scan and flash attention get H/tp q heads
    (whisper's attention runs the plain path only, as the reference's)."""
    tp = MESHES[mesh]
    cfg = ARCHS[name].reduced()
    for r in ranks[mesh]:
        used = r["steps"][name]["used"]
        assert all(shape == want and same for shape, want, same in used.values()), used
        assert any(shape != tuple(r["steps"][name]["params"][n].shape) for n, (shape, _, _) in used.items())
        heads = r["steps"][name]["heads"]
        assert bool(heads) == (cfg.family != "encdec")
        assert all(h[1] == (cfg.ssm_num_heads if h[0] == "ssd_scan" else cfg.num_heads) // tp for h in heads)


def _held_to_unsharded(s):
    """Every prefill and decode step of a serving case: logits and every cache leaf
    within 1e-4 (abs and rel) of the unsharded functions', the next tokens equal;
    every leaf the model computed with is this rank's model-axis shard."""
    bad = {k: v for k, v in s["prefill"].items() if not v[0]}
    assert not bad, ("prefill", bad)
    assert s["prefill_local"] and s["decode_tp"]
    for st in s["steps"]:
        bad = {k: v for k, v in {"logits": st["logits"], **st["cache"]}.items() if not v[0]}
        assert not bad and st["next"] and st["decode_local"], (st["pos"], bad, st["next"])


def _cross_local(cfg, s, b_local, frames, split):
    """``_kv_local`` for whisper's cross K/V (``cross_k``), over ``frames`` encoder frames."""
    index, count = split or (0, 1)
    kd = (cfg.num_kv_heads, cfg.resolved_head_dim)
    assert s["cross_k"]["global"][2] == frames
    assert s["cross_k"]["local"] == (cfg.num_layers, b_local, frames // count, *kd), s["cross_k"]
    for st in s["steps"]:
        want = ((b_local, frames // count, *kd), None if split is None else index * frames // count)
        assert st["cross_seen"] == [want] * cfg.num_layers, (st["cross_seen"], want)


def _kv_local(cfg, s, b_local, seq, split):
    """The K/V leaf each rank holds and each attention was given: the rank's batch
    rows and, over the ``split`` shards, its part of the sequence; ``split`` is the
    rank's (shard index, shard count), or None for a sequence whole on the rank."""
    layers = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers
    index, count = split or (0, 1)
    kd = (cfg.num_kv_heads, cfg.resolved_head_dim)
    assert s["k"]["global"][2] == seq and s["k"]["local"] == (layers, b_local, seq // count, *kd), s["k"]
    for st in s["steps"]:
        want = ((b_local, seq // count, *kd), None if split is None else index * seq // count)
        assert st["k_seen"] == [want] * layers, (st["k_seen"], want)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_and_decode_steps_match_unsharded(ranks, mesh, name):
    """make_prefill_step and 6 greedy make_decode_step calls from its cache, all
    tensor parallel, against make_prefill_fn and make_decode_fn on a batch of 4:
    logits and every cache leaf at 1e-4, the next tokens equal.  Each rank keeps
    its K/V leaf as ``rules.cache_specs`` places it, its batch rows and its shard
    of the sequence (``S(2)`` on ``"model"``), never the whole sequence; the 12
    prompt tokens (after a vlm's 8 patches) put ``pos`` across the boundary
    between two shards during decode.  The SSM state stays split over the heads
    on ``model``; whisper's cross K/V are held split over their 32 frames
    alike, and each cross-attention reads the rank's part."""
    tp = MESHES[mesh]
    cfg = ARCHS[name].reduced()
    for r in ranks[mesh]:
        s = r["serving"][name, "main"]
        _held_to_unsharded(s)
        if "ssm/state" in s["placements"]:
            assert s["placements"]["ssm/state"][-1] == "S(2)"  # the heads, over the model axis
        if name not in KV_NAMES:
            continue
        seq = s["k"]["global"][2]
        assert s["k"]["placements"] == ["S(1)" if tp == 2 else "R", "S(2)"]
        assert len({st["pos"] // (seq // tp) for st in s["steps"]}) == 2  # the decode crosses a shard boundary
        _kv_local(cfg, s, tp, seq, (r["coordinate"][1], tp))  # 4 rows over 4 // tp data ranks: tp a rank
        if cfg.family == "encdec":
            assert s["cross_k"]["placements"] == s["k"]["placements"]
            _cross_local(cfg, s, tp, FRAMES["divided"], (r["coordinate"][1], tp))


@pytest.mark.parametrize("name", KV_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_of_a_batch_of_one_splits_the_sequence_over_every_axis(ranks, mesh, name):
    """A batch of 1 cannot split over the data axis, so ``rules.cache_specs`` splits
    the sequence over ``("data", "model")`` on the 2x2 mesh (over ``"model"`` on
    1x4): each rank holds a quarter of it, and the decode, whose ``pos`` crosses
    from one data rank's shards to the other's, equals the unsharded one."""
    tp = MESHES[mesh]
    cfg = ARCHS[name].reduced()
    for r in ranks[mesh]:
        s = r["serving"][name, "batch1"]
        _held_to_unsharded(s)
        seq = s["k"]["global"][2]
        assert s["k"]["placements"] == ["S(2)" if tp == 2 else "R", "S(2)"]
        assert len({st["pos"] // (seq // 4) for st in s["steps"]}) == 2
        data, model = r["coordinate"]
        _kv_local(cfg, s, 1, seq, (data * tp + model, 4))
        if cfg.family == "encdec":
            assert s["cross_k"]["placements"] == s["k"]["placements"]
            _cross_local(cfg, s, 1, FRAMES["divided"], (data * tp + model, 4))


@pytest.mark.parametrize("name", KV_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_over_a_sequence_that_does_not_divide_the_model_axis(ranks, mesh, name):
    """A sequence of 31 (47 with a vlm's prefix) divides neither model axis, so
    ``rules.cache_specs`` keeps it whole on every rank: attention is
    head-parallel (each rank's q heads over the kv heads they read, its ``wo``
    rows), the new K/V row covers every kv head, and the decode equals the
    unsharded one."""
    tp = MESHES[mesh]
    cfg = ARCHS[name].reduced()
    for r in ranks[mesh]:
        s = r["serving"][name, "undivided"]
        _held_to_unsharded(s)
        assert s["k"]["placements"] == ["S(1)" if tp == 2 else "R", "R"]
        _kv_local(cfg, s, tp, s["k"]["global"][2], None)


@pytest.mark.parametrize("mesh", MESHES)
def test_encdec_decode_over_frames_that_do_not_divide_the_model_axis(ranks, mesh):
    """whisper's 31 encoder frames divide neither model axis, so ``rules.cache_specs``
    keeps its cross K/V whole over them on every rank: each cross-attention is
    head-parallel over all the frames, while the self-attention's K/V stay split
    over the sequence, and the prefill and decode equal the unsharded ones."""
    tp = MESHES[mesh]
    cfg = ARCHS["whisper-medium"].reduced()
    for r in ranks[mesh]:
        s = r["serving"]["whisper-medium", "frames_undivided"]
        _held_to_unsharded(s)
        assert s["cross_k"]["placements"] == ["S(1)" if tp == 2 else "R", "R"]
        assert s["k"]["placements"] == ["S(1)" if tp == 2 else "R", "S(2)"]
        _cross_local(cfg, s, tp, FRAMES["undivided"], None)


@pytest.mark.parametrize("name", REF_NAMES)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decode_matches_the_reference(reference, ranks, mesh, name):
    """The sharded prefill and 6 decode steps, from the port's params loaded from the
    reference's perturbed tree, on the reference's greedy tokens: each rank's logits
    against the reference's ``prefill`` and ``decode_step`` (the JAX package, on the
    CPU), at ``torch_parity.check_prefill_and_decode``'s 1e-4."""
    from torch_parity import close

    want = reference[mesh][1][name]
    for r in ranks[mesh]:
        got = r["serving"][name, "reference"]
        assert len(got) == len(want) == REF_STEPS + 1
        close(got[0], want[0])
        for (lo, logits), w in zip(got[1:], want[1:]):
            close(logits, w[lo:lo + logits.shape[0]])


@pytest.mark.parametrize("mesh", MESHES)
def test_softmax_combine_matches_softmax_over_the_whole_axis(ranks, mesh):
    """``tp.softmax_combine`` over 4 shards of a sequence of 32 (split over the data
    then the model axis), masked by a window of 12 ending at position 21, so that
    the first and last shards are wholly masked, against ``torch.softmax`` over the
    whole axis: within 1e-6 in float32 on every rank."""
    masked = 0
    for r in ranks[mesh]:
        got = r["softmax_combine"]
        assert got["err"] < 1e-6, got
        masked += got["masked"]
    assert masked == 2
