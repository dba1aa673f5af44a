"""What the benchmark's modules import: nothing of JAX, flax or the JAX
package anywhere under benchmark/, and nothing of the port in the
reference, the counts and the scenes.  Top-level names are compared whole,
since the port's name begins with the JAX package's."""

from __future__ import annotations

import ast

import pytest

from benchmark.tests.tiny import ROOT

BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "event3dgs_tpu"}
PORT = {"event3dgs_tpu_torch"}


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("sub", ["reference", "counts", "scenes", "layer_metrics"])
def test_yardstick_imports_nothing_of_the_port(sub):
    for path in sources(sub):
        assert not top_level_imports(path) & PORT, path


def test_names_compared_whole():
    assert "event3dgs_tpu_torch".split(".")[0] not in JAX
    assert "event3dgs_tpu.ops".split(".")[0] in JAX
