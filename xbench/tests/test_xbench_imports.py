"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program: each import's top-level
module name is compared whole (``repro_torch`` is not ``repro``)."""

from __future__ import annotations

import ast
import pathlib

import pytest

XBENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in XBENCH.rglob("*.py") if "out" not in p.relative_to(XBENCH).parts)


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(XBENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((XBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch", "torch"} - {"torch"})
    assert "repro_torch" not in imported(path)


def test_measured_process_holds_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, 'xbench'); import run; run.fixed_dirs(); "
            "from drivers import replay; import repro_torch.engine.replay; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=XBENCH.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
