"""The import rule: no module under portbench/ imports jax, jaxlib, flax
or longbow_tpu (the top-level name compared whole: longbow_tpu_torch
begins with longbow_tpu and is allowed), and the yardstick's files
import nothing of longbow_tpu_torch."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "longbow_tpu"}
# the reference, the recipe and the arithmetic: nothing of the program
YARDSTICK = {"reference.py", "recipe.py", "roofline.py", "measure.py", "control.py"}


def top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules() -> list:
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    seen = {}
    for p in modules():
        bad = top_imports(p) & FORBIDDEN
        assert not bad, f"{p.relative_to(BENCH)} imports {sorted(bad)}"
        seen[p.name] = top_imports(p)
    assert "longbow_tpu_torch" in seen["server.py"]  # the prefix is not a match


def test_yardstick_imports_nothing_of_the_port():
    for p in modules():
        if p.name in YARDSTICK:
            assert "longbow_tpu_torch" not in top_imports(p), p.name


def test_the_rule_compares_whole_names():
    assert "longbow_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN


def test_run_refuses_a_loaded_jax(monkeypatch, tiny_root, capsys):
    import run
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc = run.main(["--workload", "tiny-flat.batch", "--seed", "5", "--seconds", "1",
                   "--trace", "0"], device="cpu", bench=tiny_root / "portbench")
    cap = capsys.readouterr()
    assert rc != 0 and cap.out.strip() == "" and "jaxlib" in cap.err
