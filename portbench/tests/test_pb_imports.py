"""No module under portbench/ imports JAX or the JAX package, compared by
whole top-level name (fedrann_tpu_torch's name begins with fedrann_tpu and
stays allowed); the generator, the reference and the yardstick import
nothing of the program either."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fedrann_tpu"}
# the yardstick: it takes nothing from the program under test
PROGRAM_FREE = ("gen/", "reference/", "work.py", "window.py", "trace.py",
                "cells.py", "metrics/")


def imported(path: Path) -> set[str]:
    """The top-level names of every module `path` imports, anywhere in
    it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [
    p for p in MODULES
    if str(p.relative_to(HERE)).startswith(PROGRAM_FREE)],
    ids=lambda p: str(p.relative_to(HERE)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "fedrann_tpu_torch" not in imported(path)


def test_the_top_level_name_is_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fedrann_tpu_torch_extra", sys)
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fedrann_tpu.knn", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["fedrann_tpu", "jax"]
