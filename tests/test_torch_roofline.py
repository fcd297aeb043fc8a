"""The port's roofline (``repro_torch.launch.roofline``) against the reference's.

The reference's invariants (``tests/test_roofline.py``), ported; the
analytic terms equal to the reference's, float for float, on every arch,
shape, layout and production mesh; the port's differences pinned: the
H100's peaks in place of the TPU's, ``traced_*`` fields in place of
``xla_*``, and a reduce-scatter priced by its operand (ROADMAP fault (g)).
"""
import dataclasses
import importlib.util
import itertools
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import roofline as jax_roofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import roofline


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.size = 1
        for v in shape.values():
            self.size *= v


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
LAYOUTS = ("baseline", "dp-only", "replicated-weights", "pure-dp")


# ---- the reference's tests, ported


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_terms_positive_and_finite(arch):
    cfg = ARCHS[arch]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        a = roofline.analytic_costs(cfg, SHAPES[shape], MESH)
        assert a["flops_dev"] > 0 and a["hbm_dev"] > 0 and a["wire_dev"] >= 0
        for v in a.values():
            assert v == v and v != float("inf")


def test_multipod_divides_work():
    cfg = ARCHS["qwen3-8b"]
    single = roofline.analytic_costs(cfg, SHAPES["train_4k"], MESH)
    multi = roofline.analytic_costs(cfg, SHAPES["train_4k"], POD)
    # 2x devices -> per-device matmul flops halve (attention too)
    assert multi["flops_dev"] < 0.6 * single["flops_dev"]


def test_pure_dp_removes_tp_collectives():
    cfg = ARCHS["mamba2-780m"]
    base = roofline.analytic_costs(cfg, SHAPES["train_4k"], MESH, "baseline")
    pure = roofline.analytic_costs(cfg, SHAPES["train_4k"], MESH, "pure-dp")
    assert pure["wire_dev"] < 0.1 * base["wire_dev"]


def test_replicated_weights_kills_decode_gather():
    cfg = ARCHS["qwen3-moe-30b-a3b"]
    base = roofline.analytic_costs(cfg, SHAPES["decode_32k"], MESH, "baseline")
    repl = roofline.analytic_costs(cfg, SHAPES["decode_32k"], MESH, "replicated-weights")
    assert repl["wire_dev"] < 0.05 * base["wire_dev"]


def test_bf16_grads_halve_grad_reduction():
    cfg = ARCHS["mamba2-780m"]
    f32 = roofline.analytic_costs(cfg, SHAPES["train_4k"], MESH, "pure-dp", grad_bytes=4)
    bf16 = roofline.analytic_costs(cfg, SHAPES["train_4k"], MESH, "pure-dp", grad_bytes=2)
    assert bf16["wire_dev"] == pytest.approx(f32["wire_dev"] / 2, rel=0.01)


def test_train_flops_track_remat():
    cfg = ARCHS["qwen2.5-3b"]
    with_r = roofline.analytic_costs(cfg, SHAPES["train_4k"], MESH)
    no_r = roofline.analytic_costs(dataclasses.replace(cfg, remat=False), SHAPES["train_4k"], MESH)
    assert with_r["flops_dev"] == pytest.approx(no_r["flops_dev"] * 8 / 6, rel=0.02)


def test_model_flops_definition():
    cfg = ARCHS["deepseek-moe-16b"]
    mf_train = roofline.model_flops_for(cfg, SHAPES["train_4k"])
    assert mf_train == pytest.approx(6 * cfg.active_param_count() * 256 * 4096)
    mf_dec = roofline.model_flops_for(cfg, SHAPES["decode_32k"])
    assert mf_dec == pytest.approx(2 * cfg.active_param_count() * 128)


def test_collective_parse_handles_hlo_shapes():
    hlo = """
      %ar = f32[16,4096] all-reduce(f32[16,4096] %x), replica_groups={{0,1,2,3}}
      %ag = bf16[8,128] all-gather(bf16[2,128] %y), replica_groups=[4,8]<=[32]
      %cp = f32[4] collective-permute(f32[4] %z)
    """
    stats = roofline.collective_bytes(hlo)
    assert stats.count == 3
    ar = 2 * 16 * 4096 * 4 * (3 / 4)
    ag = 8 * 128 * 2 * (7 / 8)
    cp = 16
    assert stats.wire_bytes == pytest.approx(ar + ag + cp)


# ---- parity with the reference


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_costs_equal_reference(arch):
    """Pure-Python arithmetic on equal configs: the same floats, for every shape,
    layout, production mesh, gradient width and remat setting."""
    for shape, layout, mesh, grad_bytes, remat in itertools.product(SHAPES, LAYOUTS, (MESH, POD), (2, 4),
                                                                     (True, False)):
        cfg = dataclasses.replace(ARCHS[arch], remat=remat)
        ref = dataclasses.replace(JAX_ARCHS[arch], remat=remat)
        got = roofline.analytic_costs(cfg, SHAPES[shape], mesh, layout, grad_bytes)
        assert got == jax_roofline.analytic_costs(ref, JAX_SHAPES[shape], mesh, layout, grad_bytes)
    for shape in SHAPES:
        assert roofline.model_flops_for(ARCHS[arch], SHAPES[shape]) == \
            jax_roofline.model_flops_for(JAX_ARCHS[arch], JAX_SHAPES[shape])


class _Compiled:
    """What the reference's ``analyze`` reads of a compiled JAX object: no cost, no HLO."""

    def cost_analysis(self):
        return {"flops": 0.0, "bytes accessed": 0.0}

    def as_text(self):
        return ""


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_analyze_equals_reference_at_its_peaks(monkeypatch, shape):
    """At the reference's TPU constants, which this test supplies, ``analyze``'s
    analytic fields equal the reference's; each term is its figure over its peak.
    The three ``xla_*`` fields are ``traced_*`` in the port."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(jax_roofline, name))
    for arch, mesh, layout in itertools.product(sorted(ARCHS), (MESH, POD), LAYOUTS):
        cfg, ref_cfg = ARCHS[arch], JAX_ARCHS[arch]
        kw = dict(mesh=mesh, layout=layout, grad_bytes=2)
        got = dataclasses.asdict(roofline.analyze(roofline.Trace(), cfg=cfg, spec=SHAPES[shape],
                                                  model_flops=roofline.model_flops_for(cfg, SHAPES[shape]), **kw))
        want = dataclasses.asdict(jax_roofline.analyze(
            _Compiled(), cfg=ref_cfg, spec=JAX_SHAPES[shape],
            model_flops=jax_roofline.model_flops_for(ref_cfg, JAX_SHAPES[shape]), **kw))
        traced = {k: got.pop(k) for k in list(got) if k.startswith("traced_")}
        xla = {k: want.pop(k) for k in list(want) if k.startswith("xla_")}
        assert got == want
        assert {k.replace("traced_", "xla_") for k in traced} == set(xla)
        assert got["compute_s"] == got["flops_per_device"] / 197e12
        assert got["memory_s"] == got["hbm_bytes_per_device"] / 819e9
        assert got["collective_s"] == got["wire_bytes_per_device"] / 50e9


def test_peaks_are_the_h100s():
    """The H100 SXM's data-sheet bf16 and HBM peaks and the per-GPU InfiniBand
    rate replace the TPU v5e figures; chip_smoke.py reads the same two peaks."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert chip_smoke.h100_peaks() == (3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12})


# ---- fault (g): a reduce-scatter moves (k-1)/k of its operand

RS = "%rs = f32[4,128] reduce-scatter(f32[16,128] %x), replica_groups={{0,1,2,3}}, dimensions={0}"


def test_reduce_scatter_priced_by_its_operand():
    ref = jax_roofline.collective_bytes(RS)
    got = roofline.collective_bytes(RS)
    assert ref.wire_bytes == 4 * 128 * 4 * 3 / 4  # the result's bytes: fault (g)
    assert got.wire_bytes == 16 * 128 * 4 * 3 / 4 == 4 * ref.wire_bytes
    assert got.by_op == {"reduce-scatter": got.wire_bytes} and got.count == 1
    # the traced census prices the same collective the same way
    trace = roofline.Trace(collectives=[roofline.Collective("reduce-scatter", 16 * 128 * 4, 4 * 128 * 4, 4)])
    assert trace.collective_stats().wire_bytes == got.wire_bytes
