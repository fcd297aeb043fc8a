"""Rules the port keeps: no JAX and no ``repro`` inside it, the same configs as
the reference, entry points that run on the card unless told otherwise."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.models import get_model
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the package, the smoke test and every script that drives the port
PORT_SCRIPTS = [ROOT / "scripts" / f"{s}.py" for s in ("flash_variants", "ssd_variants", "merge_variants",
                                                        "lint_contracts_torch", "check_protocol_torch")]
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + PORT_SCRIPTS
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _modules() -> list[str]:
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_store_engine_runs_with_jax_and_repro_blocked(tmp_path):
    """``repro_torch.api`` imports and serves YCSB phases without JAX, through
    the lazy imports a rescale makes (``elastic/remap.py``, a namespace
    package) and the atomic write a snapshot makes (``checkpoint/atomic.py``)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core import StoreConfig\n"
        "from repro_torch.core.ycsb import Workload, make_key\n"
        "cfg = StoreConfig(l0_capacity=1 << 12, cache_bytes=1 << 15, segment_bytes=1 << 14, chunk_bytes=1 << 11)\n"
        "for part in ('none', 'hash:2', 'range:2'):\n"
        "    with api.open(api.EngineConfig(store=cfg, partitioning=part)) as eng:\n"
        "        n = sum(api.execute(eng, Workload('load_a', 'SD', num_keys=400, num_ops=0).load_ops()).values())\n"
        "        assert n == 400, n\n"
        "        if part != 'none':\n"
        "            eng.rescale(4)\n"
        "        api.execute(eng, Workload('run_a', 'SD', num_keys=400, num_ops=300).run_ops())\n"
        "        assert all(eng.get(make_key(i)) is not None for i in range(400))\n"
        "        if part != 'none':\n"
        "            eng.store.drain_migration()\n"
        f"        eng.snapshot({str(tmp_path)!r} + f'/{{part}}.json')\n"
        "assert 'repro_torch.elastic.remap' in sys.modules and 'repro_torch.checkpoint.atomic' in sys.modules\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_debug_checks_and_checkpointer_run_with_jax_and_repro_blocked(tmp_path):
    """The race detector, the protocol monitor and the checkpointer load and
    run without JAX: a checked range engine through a rescale, and a
    checkpoint saved and restored."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch.api as api\n"
        "from repro_torch.checkpoint.store import LogStructuredCheckpointer\n"
        "from repro_torch.core import StoreConfig\n"
        "cfg = StoreConfig(l0_capacity=1 << 12, cache_bytes=1 << 15, segment_bytes=1 << 14, chunk_bytes=1 << 11)\n"
        "with api.open(api.EngineConfig(store=cfg, partitioning='range:2', execution='async', debug_checks=True)) as eng:\n"
        "    for i in range(200):\n"
        "        eng.put(b'k%04d' % i, b'v' * (i % 31 + 1))\n"
        "    eng.rescale(3)\n"
        "    while eng.topology()['rescale'] is not None:\n"
        "        eng.migration_tick()\n"
        "    assert eng.get(b'k0042') == b'v' * 12\n"
        "    assert eng.race_checker.events > 0 and eng.race_checker.reports == []\n"
        "    assert eng.protocol_monitor.records_checked > 0\n"
        f"ck = LogStructuredCheckpointer({str(tmp_path)!r}, consolidate_every=2)\n"
        "state = {'w': np.arange(4096, dtype=np.float32), 'b': np.ones(16, np.float32), 's': np.float32(3)}\n"
        "for step in range(3):\n"
        "    state['w'] = state['w'] + 1\n"
        "    ck.save(step, state)\n"
        "out, step = ck.restore()\n"
        "assert step == 2 and all(out[k].tobytes() == np.asarray(v).tobytes() for k, v in state.items())\n"
        "assert 'repro_torch.analysis.racecheck' in sys.modules and 'repro_torch.analysis.protocol.monitor' in sys.modules\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_port(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


def test_archs_equal_reference():
    """The ten entries equal the reference's over the reference's fields; the port's own fields
    (the zamba2, granitemoehybrid and falcon_h1 families') hold their defaults in each entry and its reduced config."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    shared = [f.name for f in dataclasses.fields(JAX_ARCHS["mamba2-780m"])]
    own = [f for f in dataclasses.fields(ARCHS["mamba2-780m"]) if f.name not in shared]
    assert sorted(f.name for f in own) == sorted(
        ["hybrid_layer_ids", "num_mem_blocks", "adapter_rank", "mem_rope", "ssm_ngroups", "ssm_dt_min",
         "experts_held", "expert_first", "embedding_multiplier", "residual_multiplier",
         "attention_multiplier", "logits_scaling", "ssm_inner", "ssm_in_multiplier", "ssm_multipliers",
         "ssm_out_multiplier", "attention_out_multiplier", "mlp_multipliers"])

    def over_reference(cfg):
        return {k: getattr(cfg, k) for k in shared}

    for name, cfg in ARCHS.items():
        assert over_reference(cfg) == dataclasses.asdict(JAX_ARCHS[name])
        assert over_reference(cfg.reduced()) == dataclasses.asdict(JAX_ARCHS[name].reduced())
        for c in (cfg, cfg.reduced()):
            assert all(getattr(c, f.name) == f.default for f in own), name
        assert cfg.param_count() == JAX_ARCHS[name].param_count()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()
    }


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("mamba2-780m", "zamba2-2.7b", "whisper-medium"):  # ssm, hybrid, encdec
        cfg = ARCHS[name].reduced()
        m = get_model(cfg)
        params = m.init_params(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, params, device=None)
        with pytest.raises(RuntimeError, match="CUDA"):
            m.init_params(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            m.init_cache(cfg, 2, 64)
    # the training launcher, the host mesh and the examples (the store demos touch no device)
    from repro_torch.examples import quickstart, serve_lm, train_lm
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "mamba2-780m"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.train_demo()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main()
    monkeypatch.setattr(sys, "argv", ["train_lm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main()


def test_functions_refuse_a_config_the_params_were_not_built_for():
    cfg = ARCHS["mamba2-780m"].reduced()
    m = get_model(cfg)
    params = m.init_params(cfg, device="cpu")
    other = dataclasses.replace(cfg, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="compute_dtype"):
        m.forward(other, params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})


def test_dense_functions_refuse_another_config_but_take_another_attention_impl():
    cfg = ARCHS["qwen2.5-3b"].reduced()
    m = get_model(cfg)
    params = m.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="qkv_bias"):
        m.forward(dataclasses.replace(cfg, qkv_bias=False), params, {"tokens": tokens})
    # attention_impl picks the kernel per call and is built into no module
    flash, _ = m.forward(dataclasses.replace(cfg, attention_impl="flash"), params, {"tokens": tokens})
    torch.testing.assert_close(flash, m.forward(cfg, params, {"tokens": tokens})[0])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_arch_builds_and_runs_forward_on_cpu(name):
    """Every family is ported: the reduced config builds, and forward gives
    finite logits over the token positions (the vlm's patches sliced off)."""
    cfg = ARCHS[name].reduced()
    m = get_model(cfg)
    params = m.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=g)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((2, cfg.num_patches, cfg.d_model), generator=g)
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=g)
    logits, aux = m.forward(cfg, params, batch)
    assert logits.shape == (2, 12, cfg.vocab_padded) and torch.isfinite(logits).all()
    assert aux.shape == () and torch.isfinite(aux) and (float(aux.detach()) > 0) == (cfg.family == "moe")


def _run_launcher(*args: str) -> None:
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--device", "cpu"],
        capture_output=True, text=True, env=ENV, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("batch ") and "generated 64 tokens" in ln for ln in lines) == 3
    assert "'active': 0" in lines[0] and lines[-1].startswith("throughput:")


def test_launcher_runs_on_cpu():
    for name in ("mamba2-780m", "zamba2-2.7b", "whisper-medium"):  # ssm, hybrid, encdec
        _run_launcher("--arch", name)


def test_launcher_runs_on_cpu_with_its_default_arch():
    _run_launcher()  # qwen2.5-3b, the reference launcher's default too


def test_flash_refuses_padded_heads_whose_kv_map_differs():
    """ROADMAP fault (c): with padded q heads the kernel's h // (H/K) is not kv_head_map."""
    cfg = dataclasses.replace(ARCHS["yi-34b"].reduced(), num_heads=6, orig_num_heads=4, attention_impl="flash")
    m = get_model(cfg)
    params = m.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"fault \(c\)"):
        m.forward(cfg, params, {"tokens": tokens})
    plain = dataclasses.replace(cfg, attention_impl="xla")  # the plain path follows kv_head_map
    assert torch.isfinite(m.forward(plain, params, {"tokens": tokens})[0]).all()
