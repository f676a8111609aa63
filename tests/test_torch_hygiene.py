"""The port stands alone: no module of ``gftorf_tpu_torch`` and neither
``chip_smoke.py`` nor ``chip_ab.py`` imports JAX or anything of the
JAX package, and no module builds or loads a kernel when it is
imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gftorf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "gftorf_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [(line, name) for line, name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_sources_and_no_import_time_builds():
    for name in ("dense_forward", "dense_backward", "flat_forward",
                 "flat_backward"):
        assert (ROOT / "gftorf_tpu_torch" / "csrc" / f"{name}.cu").exists()
    assert (ROOT / "gftorf_tpu_torch" / "csrc" / "warp_cull.cuh").exists()
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert "triton" not in names, path
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                src = ast.unparse(node.value)
                assert "library(" not in src and "build(" not in src, (path, src)
