#!/usr/bin/env python3
"""Contract-linter CLI: the CI hard gate for the engine's invariants.

    python scripts/lint_contracts_torch.py               # lint the default targets
    python scripts/lint_contracts_torch.py --self-test   # prove every rule fires
    python scripts/lint_contracts_torch.py --json        # machine-readable output
    python scripts/lint_contracts_torch.py path.py ...   # lint explicit files

Default targets are the modeled-path modules: ``src/repro_torch/core/*.py`` plus
``src/repro_torch/api.py``.  (``src/repro_torch/analysis`` is *not* a target: the race
detector legitimately creates lock wrappers.)  Exit codes: 0 clean,
1 violations found, 2 self-test/usage failure.

``--self-test`` runs the seeded-violation fixture suite so rules cannot
silently rot: every ``tests/fixtures/lint_bad/*.py`` declares the rules it
plants with ``# lint-expect: <rule>`` lines and must produce exactly that rule
set; every ``tests/fixtures/lint_good/*.py`` must lint clean; and every
registered rule must be covered by at least one bad fixture.

``--json`` emits ``{"violations": [{"path", "line", "rule", "message"}],
"files": N}`` (the same shape as ``scripts/check_protocol_torch.py --json``); the
default text format (``path:line: [rule] message``) is matched by
``.github/problem-matchers/repro-analysis.json`` so CI annotates the
offending diff lines.
"""
from __future__ import annotations

import json
import pathlib
import re
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.analysis.lint import RULES, lint_paths  # noqa: E402

_EXPECT_RE = re.compile(r"#\s*lint-expect:\s*([a-z-]+)\s*$", re.MULTILINE)


def default_targets() -> list[pathlib.Path]:
    targets = sorted((REPO_ROOT / "src/repro_torch/core").glob("*.py"))
    targets.append(REPO_ROOT / "src/repro_torch/api.py")
    return targets


def self_test() -> int:
    bad_dir = REPO_ROOT / "tests/fixtures/lint_bad"
    good_dir = REPO_ROOT / "tests/fixtures/lint_good"
    failures: list[str] = []
    covered: set[str] = set()

    bad = sorted(bad_dir.glob("*.py"))
    if not bad:
        failures.append(f"no bad fixtures found under {bad_dir}")
    for path in bad:
        expected = set(_EXPECT_RE.findall(path.read_text(encoding="utf-8")))
        if not expected:
            failures.append(f"{path}: bad fixture declares no '# lint-expect:' rules")
            continue
        actual = {v.rule for v in lint_paths([path])}
        if actual != expected:
            failures.append(
                f"{path}: expected rule set {sorted(expected)}, linter produced "
                f"{sorted(actual)}")
        covered |= expected & actual

    for path in sorted(good_dir.glob("*.py")):
        got = lint_paths([path])
        for v in got:
            failures.append(f"{path}: good fixture tripped {v}")

    missing = {r.name for r in RULES} - covered
    if missing:
        failures.append(
            f"rules with no seeded bad-fixture coverage: {sorted(missing)} "
            f"(add a planted violation under {bad_dir})")

    if failures:
        print("lint self-test FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 2
    print(f"lint self-test ok: {len(bad)} bad fixtures, "
          f"{len(RULES)} rules covered")
    return 0


def main(argv: list[str]) -> int:
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return 0
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if "--self-test" in argv:
        rest = [a for a in argv if a != "--self-test"]
        if rest:
            print(f"error: --self-test takes no paths, got {rest!r}", file=sys.stderr)
            return 2
        return self_test()
    unknown = [a for a in argv if a.startswith("-")]
    if unknown:
        print(f"error: unknown flag(s) {unknown!r}; see --help", file=sys.stderr)
        return 2
    targets = [pathlib.Path(a) for a in argv] if argv else default_targets()
    missing = [t for t in targets if not t.is_file()]
    if missing:
        print(f"error: no such file(s): {[str(m) for m in missing]}", file=sys.stderr)
        return 2
    violations = lint_paths(targets)
    if as_json:
        print(json.dumps({
            "violations": [
                {"path": v.path, "line": v.lineno, "rule": v.rule,
                 "message": v.message}
                for v in violations
            ],
            "files": len(targets),
        }, indent=2))
    else:
        for v in violations:
            print(v)
    if violations:
        print(f"{len(violations)} contract violation(s) in {len(targets)} file(s)",
              file=sys.stderr)
        return 1
    if not as_json:
        print(f"contracts ok: {len(targets)} files clean")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
