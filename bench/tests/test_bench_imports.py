"""Nothing the benchmark runs loads JAX, the JAX package or the JAX-era benchmarks, compared by
whole top-level name (``repro_torch`` begins with ``repro``); the reference loads nothing of the port."""
import subprocess
import sys
import textwrap

from bench.harness.env import BANNED, ROOT

BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = set({blocked!r})

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".", 1)[0] in BLOCKED:
                raise ImportError(f"blocked: {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = [{src!r}, {root!r}]
""")


def _run(blocked, body: str) -> subprocess.CompletedProcess:
    code = BLOCKER.format(blocked=sorted(blocked), src=str(ROOT / "src"), root=str(ROOT)) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_harness_and_readers_load_nothing_banned():
    body = """
        import importlib, json, pathlib
        import bench.run, bench.calibrate
        from bench.harness import cell, env, program, serve, train, trace, traffic, weights, spans, run_state
        import repro_torch.serve.engine, repro_torch.train.step, repro_torch.optim.adamw
        spec = json.loads(pathlib.Path("BENCHMARK.json").read_text())
        for m in spec["per_layer"]:
            cell.reader(m["name"])
        for w in spec["workloads"]:
            cell.load(w["name"]).reference()
        leaked = env.banned_loaded()
        assert not leaked, leaked
        print("ok")
    """
    out = _run(BANNED, body)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_reference_loads_nothing_of_the_port():
    body = """
        import pkgutil, importlib, sys
        import bench.reference
        for m in pkgutil.iter_modules(bench.reference.__path__):
            importlib.import_module(f"bench.reference.{m.name}")
        assert not any(k.split(".")[0] == "repro_torch" for k in sys.modules)
        print("ok")
    """
    out = _run(set(BANNED) | {"repro_torch"}, body)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_the_check_compares_whole_names():
    from bench.harness import env

    assert env.banned_loaded({"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1}) == []
    assert env.banned_loaded({"repro.core": 1, "jax.numpy": 1, "os": 1}) == ["jax", "repro"]
