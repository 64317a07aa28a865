"""The port imports neither JAX nor the reference package.

An AST scan of every Python file of ``dint_tpu_torch/`` and of
``chip_smoke.py``: no ``import jax`` / ``from jax...`` and no import whose
top-level package is exactly ``dint_tpu`` (``dint_tpu_torch`` itself is
allowed, and relative imports stay inside the port).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "dint_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "dint_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
            node.func, "id", getattr(node.func, "attr", None)
        ) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_file_list_is_complete():
    rel = {os.path.relpath(f, REPO) for f in _port_files()}
    for must in ("chip_smoke.py", "dint_tpu_torch/kernels/decode_local.py",
                 "dint_tpu_torch/tools/decode.py",
                 "dint_tpu_torch/backend.py"):
        assert must in rel


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_or_reference_import(path):
    bad = [
        (name, line) for name, line in _top_level_imports(path)
        if name in FORBIDDEN
    ]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scanner_tells_the_port_from_the_reference(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(
        "import dint_tpu_torch.kernels\n"
        "from dint_tpu_torch import backend\n"
        "from . import sibling\n"
        "import dint_tpu.config\n"
        "from jax import numpy\n"
    )
    names = [n for n, _ in _top_level_imports(str(p))]
    assert [n for n in names if n in FORBIDDEN] == ["dint_tpu", "jax"]
