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
                 "dint_tpu_torch/backend.py",
                 "dint_tpu_torch/codecs/interpolative.py",
                 "dint_tpu_torch/codecs/dint.py",
                 "dint_tpu_torch/index/dint_index.py",
                 "dint_tpu_torch/query/lazy_decode.py",
                 "dint_tpu_torch/query/ranked.py",
                 "dint_tpu_torch/query/boolean.py",
                 "dint_tpu_torch/query/term_decode.py",
                 "dint_tpu_torch/query/device_batch.py",
                 "dint_tpu_torch/query/device_serve.py",
                 "dint_tpu_torch/query/bmw.py",
                 "dint_tpu_torch/query/bmw_device.py",
                 "dint_tpu_torch/tools/create_freq_index.py",
                 "dint_tpu_torch/tools/create_wand_data.py",
                 "dint_tpu_torch/tools/queries.py",
                 "dint_tpu_torch/kernels/store_probe.py",
                 "dint_tpu_torch/kernels/decode_pallas.py",
                 "dint_tpu_torch/kernels/unpack_device.py",
                 "dint_tpu_torch/query/native_host.py",
                 "dint_tpu_torch/tools/bench.py",
                 "dint_tpu_torch/tools/kernel_ablate.py",
                 "dint_tpu_torch/kernels/decode_xla.py",
                 "dint_tpu_torch/kernels/pipeline.py",
                 "dint_tpu_torch/codecs/blocks.py",
                 "dint_tpu_torch/codecs/qmx.py",
                 "dint_tpu_torch/codecs/zoonative.py",
                 "dint_tpu_torch/codecs/ef.py",
                 "dint_tpu_torch/utils/bitio.py",
                 "dint_tpu_torch/utils/bitnative.py",
                 "dint_tpu_torch/index/vroom_zoo.py",
                 "dint_tpu_torch/parallel/dist.py",
                 "dint_tpu_torch/parallel/steps.py",
                 "dint_tpu_torch/parallel/build.py",
                 "dint_tpu_torch/parallel/serve.py",
                 "dint_tpu_torch/parallel/dryrun.py",
                 "dint_tpu_torch/stats/collectors.py",
                 "dint_tpu_torch/stats/device_merge.py"):
        assert must in rel


# the one module of the reference without a counterpart of the same
# path, and the port's module that takes its place
RENAMED = {"utils/jaxcfg.py": "backend.py"}


def test_every_reference_module_has_its_port():
    """Each ``.py`` file of ``dint_tpu/`` has a counterpart at the same
    path in ``dint_tpu_torch/``, but for the modules of ``RENAMED``."""
    ref_root = os.path.join(REPO, "dint_tpu")
    ref = sorted(
        os.path.relpath(os.path.join(root, f), ref_root)
        for root, _, files in os.walk(ref_root)
        for f in files if f.endswith(".py")
    )
    assert len(ref) > 60 and "tools/decode.py" in ref
    missing = []
    for rel in ref:
        port = RENAMED.get(rel, rel)
        if not os.path.isfile(os.path.join(REPO, "dint_tpu_torch", port)):
            missing.append(rel)
    assert not missing, f"no port of {missing}"
    for rel in RENAMED:
        assert rel in ref
        assert not os.path.exists(os.path.join(REPO, "dint_tpu_torch", rel))


@pytest.mark.parametrize("module", [
    "dint_tpu_torch.codecs.interpolative", "dint_tpu_torch.codecs.dint",
    "dint_tpu_torch.index.dint_index", "dint_tpu_torch.query.lazy_decode",
    "dint_tpu_torch.query.ranked", "dint_tpu_torch.query.boolean",
    "dint_tpu_torch.query.term_decode", "dint_tpu_torch.query.device_batch",
    "dint_tpu_torch.query.device_serve",
    "dint_tpu_torch.tools.create_freq_index",
    "dint_tpu_torch.tools.create_wand_data", "dint_tpu_torch.tools.queries",
    "dint_tpu_torch.kernels.store_probe", "dint_tpu_torch.kernels.decode_pallas",
    "dint_tpu_torch.kernels.unpack_device", "dint_tpu_torch.query.native_host",
    "dint_tpu_torch.tools.decode", "dint_tpu_torch.tools.bench",
    "dint_tpu_torch.tools.kernel_ablate",
    "dint_tpu_torch.query.bmw", "dint_tpu_torch.query.bmw_device",
    "dint_tpu_torch.kernels.decode_xla", "dint_tpu_torch.kernels.pipeline",
    "dint_tpu_torch.codecs.blocks", "dint_tpu_torch.codecs.qmx",
    "dint_tpu_torch.codecs.zoonative", "dint_tpu_torch.codecs.ef",
    "dint_tpu_torch.utils.bitio", "dint_tpu_torch.utils.bitnative",
    "dint_tpu_torch.index.vroom_zoo", "dint_tpu_torch.tools.encode",
    "dint_tpu_torch.parallel.dist", "dint_tpu_torch.parallel.steps",
    "dint_tpu_torch.parallel.build", "dint_tpu_torch.parallel.serve",
    "dint_tpu_torch.parallel.dryrun", "dint_tpu_torch.stats.collectors",
    "dint_tpu_torch.stats.device_merge", "dint_tpu_torch.stats.block_stats",
    "dint_tpu_torch.tools.check_encoded_data",
    "dint_tpu_torch.tools.check_index",
    "dint_tpu_torch.tools.pair_wise_intersect",
    "dint_tpu_torch.tools.dict_perf_test", "dint_tpu_torch.utils.progress",
    "dint_tpu_torch.codecs.encode_batch", "dint_tpu_torch.stats.native_stats",
])
def test_serving_modules_import_without_jax(module):
    """Each module of the serving and bench slices imports in a fresh interpreter
    that cannot import jax or the reference package, and builds nothing
    at import."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dint_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import {module}\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


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
