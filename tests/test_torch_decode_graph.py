"""The decode step replayed from captured CUDA graphs, as far as the CPU can hold it.

``decode_step(..., out=)`` writes an ssm, hybrid or zamba2 model's new cache
into a given one, or into the input in place, bit for bit the allocating
call's; the hybrids' step reads nothing back to the host, as ``attention_decode``
takes ``pos`` as the cache's device tensor, bit for bit as from an int;
``decode_graphable`` picks the graph only for those families on the card, not
tensor-parallel (the card stood in for by fake tensors: nothing is allocated);
an engine on the CPU captures nothing; a runner refuses params it was not built
on; and ``bench/metrics/decode_graph_share.py`` reads hand-built traces.  The
replay itself runs on the card: ``tests/test_torch_gpu.py``.
"""
import dataclasses
from pathlib import Path

import pytest
import torch
from torch._subclasses import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.configs import ARCHS
from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sharding import tp
from test_torch_zamba2 import ARCH as ZAMBA2_TINY

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = sorted(n for n, c in ARCHS.items() if c.family != "encdec")


def _params(name, device="cpu"):
    """The registry's arch ``name`` reduced, or ``test_torch_zamba2.py``'s tiny zamba2."""
    cfg = ArchConfig(**ZAMBA2_TINY) if name == ZAMBA2_TINY["name"] else ARCHS[name].reduced()
    return cfg, transformer.init_params(cfg, torch.Generator().manual_seed(0), device=device)


def _on_fake_card(params):
    """``params`` moved in place onto a stand-in for the card: fake tensors, no memory, no card."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        params.to_empty(device="cuda")
    return params


# ------------------------------------------------------------ decode_step(out=)
SSM_ARCHS = sorted(n for n in LM_ARCHS if ARCHS[n].family == "ssm")
HYBRID_ARCHS = sorted(n for n in LM_ARCHS if ARCHS[n].family == "hybrid") + [ZAMBA2_TINY["name"]]
POSITIONAL_ARCHS = sorted(n for n in LM_ARCHS if ARCHS[n].family in ("dense", "moe", "vlm"))


def _decode_into(name, into):
    """``out=`` a cache of its own, or the input cache itself (updated in place, as the graph
    replays it): the logits and the new cache are the allocating call's, bit for bit, in
    ``out``'s tensors; a cache of its own leaves the input as it was."""
    cfg, params = _params(name)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    logits, cache = transformer.prefill(cfg, params, {"tokens": prompts}, 16)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    before = [t.clone() for t in transformer._leaves(cache)]
    want_logits, want = transformer.decode_step(cfg, params, cache, tok)
    out = tree_map(lambda t: torch.full_like(t, 7), cache) if into == "given" else cache
    got_logits, got = transformer.decode_step(cfg, params, cache, tok, out=out)
    assert torch.equal(got_logits, want_logits)
    assert all(g is o for g, o in zip(transformer._leaves(got), transformer._leaves(out)))
    assert all(torch.equal(g, w) for g, w in zip(transformer._leaves(got), transformer._leaves(want)))
    if into == "given":
        assert all(torch.equal(t, b) for t, b in zip(transformer._leaves(cache), before))
    # and it chains: the written cache decodes on as the allocated one does
    assert torch.equal(transformer.decode_step(cfg, params, got, tok, out=out)[0],
                       transformer.decode_step(cfg, params, want, tok)[0])


@pytest.mark.parametrize("name", SSM_ARCHS + HYBRID_ARCHS)
def test_decode_into_a_given_cache_is_the_allocating_step(name):
    _decode_into(name, "given")


@pytest.mark.parametrize("name", SSM_ARCHS + HYBRID_ARCHS)
def test_decode_in_place_is_the_allocating_step(name):
    _decode_into(name, "input")


@pytest.mark.parametrize("name", POSITIONAL_ARCHS)
def test_decode_into_a_given_cache_is_refused_with_positional_kv(name):
    cfg, params = _params(name)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    cache = transformer.prefill(cfg, params, {"tokens": prompts}, 16)[1]
    with pytest.raises(ValueError, match="ssm, hybrid or zamba2 cache"):
        transformer.decode_step(cfg, params, cache, prompts[:, :1], out=cache)


class _Reads(TorchDispatchMode):
    """Counts the ops that read a tensor's value back to the host (``int(t)``, ``t.item()``)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in (torch.ops.aten.item.default, torch.ops.aten._local_scalar_dense.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", SSM_ARCHS + HYBRID_ARCHS + POSITIONAL_ARCHS[:1])
def test_decode_reads_pos_back_only_with_positional_kv(name):
    """The Mamba2-loop families' step reads no tensor back to the host, so a graph can hold it;
    a moe step (as dense and vlm) reads ``pos`` once, which is what keeps it eager."""
    cfg, params = _params(name)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    logits, cache = transformer.prefill(cfg, params, {"tokens": prompts}, 16)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    with _Reads() as reads:
        transformer.decode_step(cfg, params, cache, tok)
    assert reads.count == (cfg.family not in transformer._MAMBA2_LOOP)


# ------------------------------------------------------ attention_decode(pos)
@pytest.mark.parametrize("window", [0, 3], ids=["whole", "window"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "no-rope"])
def test_attention_decode_at_a_device_pos_is_the_int_pos_bit_for_bit(rope, window):
    """``pos`` as the cache's 0-d int32 tensor: the same output and the same cache, row and all,
    as the int, with and without the rotation and the sliding window."""
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"].reduced(), sliding_window=window)
    g = torch.Generator().manual_seed(2)
    p = layers.Attention(cfg, g, "cpu")
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    shape = (2, 12, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv = {"k": torch.randn(shape, generator=g), "v": torch.randn(shape, generator=g)}
    for pos in (0, 5, 11):
        want_cache, got_cache = tree_map(torch.clone, kv), tree_map(torch.clone, kv)
        want = layers.attention_decode(cfg, p, x, want_cache, pos, rope=rope)[0]
        got = layers.attention_decode(cfg, p, x, got_cache, torch.tensor(pos, dtype=torch.int32), rope=rope)[0]
        assert torch.equal(got, want)
        assert all(torch.equal(got_cache[n], want_cache[n]) for n in kv)
        assert not torch.equal(got_cache["k"], kv["k"])  # the row went in


def test_attention_decode_refuses_a_device_pos_on_a_split_sequence():
    cfg = ARCHS["qwen2.5-3b"].reduced()
    p = layers.Attention(cfg, torch.Generator().manual_seed(2), "cpu")
    p.seq_split = tp.SeqSplit(offset=0, groups=(), kvm=p.kvm)
    shape = (2, 12, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    with pytest.raises(ValueError, match="sequence-split"):
        layers.attention_decode(cfg, p, torch.zeros((2, 1, cfg.d_model)), kv, torch.tensor(3, dtype=torch.int32))


# ---------------------------------------------------------------- the predicate
def test_graphs_apply_to_an_ssm_model_on_the_card():
    cfg, params = _params("mamba2-780m")
    assert not transformer.decode_graphable(cfg, params)
    assert transformer.decode_graphable(cfg, _on_fake_card(params))


@pytest.mark.parametrize("name", HYBRID_ARCHS)
def test_graphs_apply_to_a_hybrid_model_on_the_card(name):
    cfg, params = _params(name)
    assert not transformer.decode_graphable(cfg, params)
    assert transformer.decode_graphable(cfg, _on_fake_card(params))


@pytest.mark.parametrize("name", POSITIONAL_ARCHS)
def test_graphs_never_apply_to_a_family_with_positional_kv(name):
    cfg, params = _params(name)
    assert not transformer.decode_graphable(cfg, _on_fake_card(params))


@pytest.mark.parametrize("where", ["embedding", "mixer"])
def test_graphs_never_apply_under_tensor_parallelism(where):
    cfg, params = _params("mamba2-780m")
    params = _on_fake_card(params)
    module = params.embedding if where == "embedding" else params.layers[-1].ssm
    module.tp_group = tp.Group(group=None, rank=0, size=2)
    assert not transformer.decode_graphable(cfg, params)


def test_an_engine_on_the_cpu_captures_nothing_and_serves_eagerly():
    cfg, params = _params("mamba2-780m")
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu")
    before = dict(transformer.DECODE_GRAPHS)
    reqs = [Request(i, (torch.arange(8, dtype=torch.int32) * (i + 1) + 3) % cfg.vocab_size, max_new_tokens=4)
            for i in range(2)]
    served = eng.run_batch(reqs)
    assert eng._graphs is None and transformer.DECODE_GRAPHS == before
    assert all(len(r.output) == 4 for r in served)


def test_a_runner_refuses_params_it_was_not_built_on():
    cfg, params = _params("mamba2-780m")
    _, other = _params("mamba2-780m")
    runner = transformer.DecodeGraphs(cfg, params)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="other params"):
        runner(other, transformer.prefill(cfg, params, {"tokens": tok}, 16)[1], tok)
    assert runner._graph is None


# ------------------------------------------------------- the benchmark's reader
MAIN, OTHER = 1, 2


@pytest.fixture
def share(monkeypatch):
    """``decode_graph_share``'s reader over a hand-built trace of (start, end, name, thread) ops."""
    monkeypatch.syspath_prepend(str(ROOT))  # bench/ lives at the root
    from bench.harness import cell as cellmod
    from bench.harness.run_state import Run
    from bench.harness.spans import Spans
    from bench.harness.trace import Trace

    cell = cellmod.load("mamba2-780m.chat")
    read = cellmod.reader("decode_graph_share")

    def of(ops):
        trace = Trace(window_s=4.0, busy_s=2.0, kernels=1, ops=sorted(ops, key=lambda r: (r[0], -r[1])),
                      launches=[(10, MAIN, 0.5)])
        return read(Run(spans=Spans(sync=False, device_type="cpu"), trace=trace), cell)

    return of


def test_graph_share_is_the_share_of_steps_holding_a_replay(share):
    """Replayed steps (``model.decode_graph`` spans, on any thread) over those and the eager
    ``model.decode_step`` spans."""
    ops = [(0, 1000, "serve.run_batch", MAIN),
           (0, 50, "model.decode_step", MAIN), (10, 20, "model.mamba2", MAIN),
           (100, 150, "model.decode_step", MAIN),
           (200, 210, "model.decode_graph", MAIN), (300, 310, "model.decode_graph", OTHER)]
    assert share(ops) == pytest.approx(50.0)
    assert share(ops + [(400, 410, "model.decode_graph", MAIN)]) == pytest.approx(60.0)
    assert share([op for op in ops if op[2] != "model.decode_step"]) == pytest.approx(100.0)


@pytest.mark.parametrize("ops", [
    [(0, 100, "bench.decode", MAIN), (10, 20, "aten::mm", MAIN)],                 # no program spans
    [(0, 100, "model.decode_step", MAIN), (10, 20, "model.mamba2", MAIN)],        # steps, none replayed
], ids=["no-spans", "eager-steps"])
def test_graph_share_of_a_trace_without_replays_gives_nothing(share, ops):
    assert share(ops) is None
