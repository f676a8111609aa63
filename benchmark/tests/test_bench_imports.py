"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (``gftorf_tpu_torch`` begins with ``gftorf_tpu``)."""

import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "gftorf_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "gftorf_tpu_torch" not in set(_imports(path))


def test_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import gftorf_tpu.render\nfrom jax import numpy\n"
                 "import gftorf_tpu_torch\n")
    assert set(_imports(str(p))) == {"gftorf_tpu", "jax", "gftorf_tpu_torch"}
