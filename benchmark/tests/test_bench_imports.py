"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the plain reference loads nothing of
the program."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.manifest import BENCH_DIR, ROOT

JAXLIKE = {"jax", "jaxlib", "flax", "dint_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not \
                node.level:
            yield node.module


@pytest.mark.parametrize("names,bad", [
    (["dint_tpu_torch", "dint_tpu_torch.kernels"], []),
    (["dint_tpu", "dint_tpu.io"], ["dint_tpu", "dint_tpu.io"]),
    (["jax", "jaxlib.xla_client", "jax_foo", "flaxen"],
     ["jax", "jaxlib.xla_client"]),
    (["flax.linen", "numpy"], ["flax.linen"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, bad):
    assert harness.forbidden_modules(names) == sorted(bad)


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(d, f)):
                    assert mod.split(".")[0] not in JAXLIKE, (f, mod)


@pytest.mark.parametrize("module", ["reference", "collection", "roofline"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    for mod in _imports(os.path.join(BENCH_DIR, module + ".py")):
        assert mod.split(".")[0] in ("numpy", "torch", "os", "typing",
                                     "dataclasses", "__future__",
                                     "benchmark"), mod
    code = (f"import sys; import benchmark.{module}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('dint_tpu_torch', 'dint_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_cpu_run_leaves_no_forbidden_module_loaded(tmp_path):
    code = ("import sys, json; from benchmark.tests import tiny; "
            "from benchmark.manifest import Manifest; "
            "from benchmark import harness; "
            f"m = Manifest(tiny.make({str(tmp_path)!r})); "
            "tiny.run(m, 'gov2s-rect.scan'); "
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_exits_non_zero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "gov2s-rect.scan", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_exits_non_zero_without_the_program(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        open(os.path.join(ROOT, "BENCHMARK.json")).read())
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "gov2s-rect.scan", "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
