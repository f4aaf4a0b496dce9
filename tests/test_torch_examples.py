"""The port's examples (``examples/torch_*_example.py``) under ``--device
cpu`` beside the reference's (``examples/*_example.py``) under
``JAX_PLATFORMS=cpu`` with 8 simulated devices, each as a process; and the
port's entries in ``pyproject.toml``.

- PageRank: the same graph, the same top-5 ids in order, the same
  personalized neighbour.  The printed ranks agree to 1e-4, not to all six
  decimals: the reference's float32 run settles further from the float64
  ranks (0.178074 at the top node) than the port's (0.178057), which the
  test holds to 1e-6 of the JAX package's float64 run of the example.
- TF-IDF: the same output, line for line (the top-3 documents and scores).
- Multichip: the port's mesh of 8 CPU slots, every strategy within 1e-9 L1
  of one device, the reference's strategies and sharded TF-IDF counts.
"""

from __future__ import annotations

import importlib
import os
import pathlib
import re
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.api import pagerank as jpagerank
from page_rank_and_tfidf_using_apache_spark_tpu.io.graph import synthetic_powerlaw

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
JAX_ENV = {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
PORT_ARGS = {"pagerank": ["--device", "cpu"], "tfidf": ["--device", "cpu"],
             "multichip": ["--device", "cpu", "--slots", "8"]}
NODE_LINE = re.compile(r"^  node (\d+): (\S+)$")
L1_LINE = re.compile(r"^pagerank\[(\w+)\s*\] on (\d+) devices: L1 vs single-chip (\S+)$")


def _run(cmd: list, env: dict) -> list:
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, **env})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


@pytest.fixture(scope="module", params=sorted(PORT_ARGS))
def example(request):
    name = request.param
    port = _run([sys.executable, f"examples/torch_{name}_example.py", *PORT_ARGS[name]], {})
    ref = _run([sys.executable, f"examples/{name}_example.py"], JAX_ENV)
    return name, port, ref


def test_example_matches_the_references(example):
    name, port, ref = example
    if name == "pagerank":
        assert port[0] == ref[0]  # the graph
        got = [NODE_LINE.match(ln).groups() for ln in port[2:7]]
        want = [NODE_LINE.match(ln).groups() for ln in ref[2:7]]
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, a), (_, b) in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-4, (a, b)
        graph = synthetic_powerlaw(10_000, 80_000, seed=0)
        f64 = np.asarray(jpagerank(graph, iterations=50, tol=1e-9, dangling="redistribute",
                                   init="uniform", dtype="float64").ranks)
        rows = np.searchsorted(graph.node_ids, [int(g[0]) for g in got])
        assert np.abs(np.array([float(g[1]) for g in got]) - f64[rows]).max() <= 1e-6
        assert port[-1] == ref[-1]  # the personalized run's top neighbour
    elif name == "tfidf":
        assert port == ref
    else:
        l1 = {m[1]: float(m[3]) for m in map(L1_LINE.match, port) if m}
        want = {m[1] for m in map(L1_LINE.match, ref) if m}
        assert set(l1) == want and len(want) == 6
        assert max(l1.values()) <= 1e-9, l1
        assert all(m[2] == "8" for m in map(L1_LINE.match, port) if m)
        assert port[-1].split("(")[0] == ref[-1].split("(")[0]  # docs and nnz


def _project() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]


def test_pyproject_names_the_ports_console_scripts():
    scripts = _project()["scripts"]
    ours = {k: v for k, v in scripts.items() if v.startswith(PORT + ".")}
    assert set(ours.values()) == {f"{PORT}.cli.pagerank:main", f"{PORT}.cli.tfidf:main"}
    for target in ours.values():
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr))
    # the JAX package's scripts stay as they were
    assert scripts["tpu-pagerank"] == "page_rank_and_tfidf_using_apache_spark_tpu.cli.pagerank:main"
    assert scripts["tpu-tfidf"] == "page_rank_and_tfidf_using_apache_spark_tpu.cli.tfidf:main"


def test_pyproject_has_a_torch_extra():
    assert _project()["optional-dependencies"]["torch"] == ["torch"]


def test_package_data_carries_every_kernel_and_native_source():
    with open(ROOT / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][PORT]
    pkg = ROOT / PORT
    carried = {p for g in globs for p in pkg.glob(g)}
    sources = {p for d in ("csrc", "native") for p in (pkg / d).iterdir() if p.is_file()}
    assert sources and carried == sources
