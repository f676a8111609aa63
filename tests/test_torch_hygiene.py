"""The port stands alone: no module of ``gftorf_tpu_torch`` and none of
``chip_smoke.py``, ``chip_ab.py`` and ``chip_parity20k.py`` imports JAX or
anything of the JAX package, and no module builds or loads a kernel when
it is imported.

Nor do they import cv2, PIL or matplotlib, which the card's machine does
not have: images are resized by ``utils/resize.py``, PNGs read and written
by ``utils/image_io.py``, JPEGs read by ``utils/jpeg.py``, plots drawn
with the bitmap font. The one exception is imageio, imported only by
``utils/image_io.py::write_video``, which writes a GIF without it.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gftorf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "chip_parity20k.py"]
FORBIDDEN = ("jax", "jaxlib", "gftorf_tpu")


IMAGE_LIBS = ("cv2", "PIL", "matplotlib")
# (module, function, library) of the imports allowed above.
ALLOWED = {("gftorf_tpu_torch/utils/image_io.py", "write_video", "imageio")}


def _import_of(node):
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    if (isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__") and node.args
            and isinstance(node.args[0], ast.Constant)):
        return [str(node.args[0].value)]
    return []


def _scoped_imports(node, scope=None):
    """(line, module, innermost enclosing function) of every import."""
    for name in _import_of(node):
        yield node.lineno, name, scope
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        scope = node.name
    for child in ast.iter_child_nodes(node):
        yield from _scoped_imports(child, scope)


def _imports(path):
    for line, name, _ in _scoped_imports(ast.parse(path.read_text(), str(path))):
        yield line, name


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [(line, name) for line, name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_image_library_import(path):
    rel = str(path.relative_to(ROOT))
    tree = ast.parse(path.read_text(), str(path))
    bad = [(line, name, scope) for line, name, scope in _scoped_imports(tree)
           if name.split(".")[0] in IMAGE_LIBS + ("imageio",)
           and (rel, scope, name.split(".")[0]) not in ALLOWED]
    assert not bad, f"{rel} imports {bad}"


def test_allowed_image_imports_are_where_named():
    """Each named exception exists, so the list cannot outlive the code."""
    for rel, scope, lib in ALLOWED:
        tree = ast.parse((ROOT / rel).read_text())
        assert any(s == scope and n.split(".")[0] == lib
                   for _, n, s in _scoped_imports(tree)), (rel, scope, lib)


def test_kernel_sources_and_no_import_time_builds():
    for name in ("dense_forward", "dense_backward", "flat_forward",
                 "flat_backward", "preprocess"):
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
