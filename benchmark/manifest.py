"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its ``configs`` entry; the
traffic mix is ``traffic/<name>.json`` beside this module, and its
``kind`` names the code that drives it, ``kinds/<kind>.py``; a per-layer
metric is read by ``metrics/<name>.py``.  A later change adds a
configuration, a mix or a metric as new files and manifest entries,
and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    def __init__(self, path: str = None, bench_dir: str = None):
        self.path = os.path.abspath(path or os.path.join(ROOT,
                                                         "BENCHMARK.json"))
        self.root = os.path.dirname(self.path)
        self.bench_dir = bench_dir or os.path.join(self.root, "benchmark")
        with open(self.path) as f:
            self.data = json.load(f)

    def _entry(self, section: str, name: str) -> dict:
        for e in self.data[section]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {section} entry named {name!r} in {self.path}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root, self._entry("configs",
                                                      name)["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        _check_name(name)
        with open(os.path.join(self.bench_dir, "traffic",
                               name + ".json")) as f:
            return json.load(f)

    def kind(self, name: str):
        _check_name(name)
        return _load(os.path.join(self.bench_dir, "kinds", name + ".py"),
                     "benchmark.kinds." + name.replace(".", "_"))

    def metric_reader(self, name: str):
        _check_name(name)
        return _load(os.path.join(self.bench_dir, "metrics", name + ".py"),
                     "benchmark.metrics." + name.replace(".", "_"))

    def end_to_end(self, cell: str):
        """The end-to-end metrics that ``cell`` reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str):
        """The per-layer metrics that ``cell`` reports."""
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]


def _check_name(name: str) -> None:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")


def _load(path: str, modname: str):
    """The module in ``path`` (its file name may hold dots)."""
    if not os.path.exists(path):
        raise KeyError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
