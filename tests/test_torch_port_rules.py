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
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "scripts" / "flash_variants.py"]
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
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(JAX_ARCHS[name].reduced())
        assert cfg.param_count() == JAX_ARCHS[name].param_count()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()
    }


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["mamba2-780m"].reduced()
    m = get_model(cfg)
    params = m.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(cfg, 2, 64)


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


def test_unported_families_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(ARCHS["deepseek-moe-16b"].reduced())


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
    _run_launcher("--arch", "mamba2-780m")


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
