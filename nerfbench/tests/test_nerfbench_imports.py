"""No module of the benchmark imports JAX or the JAX package, by top-level
name compared whole; the reference imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tinynerf_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_whole_names():
    """The port's name begins with the JAX package's: only a whole name
    matches."""
    from nerfbench import harness

    assert "tinynerf_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "tinynerf_tpu.core".split(".")[0] in harness.FORBIDDEN


def test_reference_is_independent():
    for path in (ROOT / "reference").rglob("*.py"):
        assert not _top_level_imports(path) & {"tinynerf_tpu_torch", "nerfbench"}, path
