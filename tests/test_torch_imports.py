"""The port, ``chip_smoke.py`` and the ranks of the multi-card tests
(``tests/torch_dist_worker.py``, spawned processes) import neither JAX nor
the JAX package (``gfnerf_tpu`` and its modules, numpy-only ones included),
nor the image libraries the card's machine lacks (cv2, PIL, imageio,
skimage).

Every ``.py`` under ``gfnerf_tpu_torch/``, ``chip_smoke.py`` and
``tests/torch_dist_worker.py`` is parsed;
each ``import``/``from ... import`` statement, and each
``importlib.import_module``/``__import__`` call with a literal name, is
checked, wherever it sits (module level or inside a function).  One import
is known and held to its form: ``utils/image_io.read_image`` decodes a
file that is neither PNG nor JPEG through imageio where it imports, inside
a ``try`` whose ``ImportError`` handler raises ``NotImplementedError`` (PNG
and JPEG go through the port's own decoders on every device).
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gfnerf_tpu", "cv2", "PIL", "imageio",
             "skimage")
FILES = sorted((REPO / "gfnerf_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_dist_worker.py"]
# (file, module): the guarded optional import described above
KNOWN = {("gfnerf_tpu_torch/utils/image_io.py", "imageio.v2")}


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _imports(tree: ast.AST):
    """(module name, node, parents) of every import in ``tree``."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                names = [node.module]
        elif isinstance(node, ast.Call):
            f = node.func
            callee = (f.attr if isinstance(f, ast.Attribute)
                      else getattr(f, "id", ""))
            if (callee in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names = [node.args[0].value]
        for name in names:
            yield name, node, parents


def _guarded(node, parents) -> bool:
    """The import sits in a ``try`` whose ``ImportError`` handler raises
    ``NotImplementedError``."""
    child, up = node, parents.get(node)
    while up is not None:
        if isinstance(up, ast.Try) and child in up.body:
            for h in up.handlers:
                caught = ast.unparse(h.type) if h.type else ""
                raises = [n for n in ast.walk(h) if isinstance(n, ast.Raise)]
                if "ImportError" in caught and any(
                        "NotImplementedError" in ast.unparse(r)
                        for r in raises):
                    return True
        child, up = up, parents.get(up)
    return False


def test_files_found():
    assert len(FILES) > 60
    assert REPO / "gfnerf_tpu_torch" / "viewer" / "server.py" in FILES
    for name in ("__init__.py", "comm.py", "sharding.py"):
        assert REPO / "gfnerf_tpu_torch" / "parallel" / name in FILES


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(REPO)) for f in FILES])
def test_no_forbidden_import(path):
    rel = str(path.relative_to(REPO))
    tree = ast.parse(path.read_text(), filename=rel)
    bad = []
    for name, node, parents in _imports(tree):
        if not _forbidden(name):
            continue
        if (rel, name) in KNOWN and _guarded(node, parents):
            continue
        bad.append(f"{rel}:{node.lineno}: {name}")
    assert not bad, bad


def test_known_import_is_guarded():
    """The one known import is still there and still guarded, so that the
    allowance above cannot cover another form."""
    found = []
    for rel, name in KNOWN:
        tree = ast.parse((REPO / rel).read_text())
        found += [_guarded(node, parents) for n, node, parents
                  in _imports(tree) if n == name]
    assert found == [True]


def test_checker_catches_forbidden_forms():
    src = '''
import jax.numpy as jnp
from gfnerf_tpu.utils import colormaps
import gfnerf_tpu_torch.viewer
def f():
    import cv2
    from PIL import Image
    importlib.import_module("skimage.io")
    try:
        import imageio.v2
    except ImportError:
        pass
'''
    names = [n for n, _, _ in _imports(ast.parse(src)) if _forbidden(n)]
    assert sorted(names) == sorted(["jax.numpy", "gfnerf_tpu.utils", "cv2",
                                    "PIL", "skimage.io", "imageio.v2"])
    imp = [(n, node, p) for n, node, p in _imports(ast.parse(src))
           if n == "imageio.v2"]
    assert not _guarded(imp[0][1], imp[0][2])   # no NotImplementedError
