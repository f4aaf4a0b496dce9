"""Import hygiene and device defaults of the PyTorch port.

The port (``page_rank_and_tfidf_using_apache_spark_tpu_torch``) and
``chip_smoke.py`` must import neither JAX nor anything of the JAX package
(the scan globs every ``.py`` file of the package, new modules included),
must not name the JAX package's ``native/`` copy, and every entry point
must run on ``cuda`` unless told otherwise — raising, not falling back,
where there is no CUDA.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import pagerank, tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as tfidf_cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import (
    gather_micro,
    spmv_breakdown,
    xla_cost_micro,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    PageRankConfig,
    TfidfConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu"})
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
TINY = str(ROOT / "tests" / "fixtures" / "tiny.txt")


def top_level_imports(source: str) -> set[str]:
    """Top-level module names a source imports: ``import``/``from``
    statements (absolute ones) and ``importlib.import_module`` /
    ``__import__`` calls with a literal name."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = top_level_imports(path.read_text()) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_covers_the_obs_core_and_the_segment_kernel():
    """The scan globs the package, so the obs copies, the profiling layer
    and the segmented-sum kernel's wrapper are among the files it reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {f"obs/{m}.py" for m in ("__init__", "events", "runtime", "metrics", "export",
                                    "federation", "trace", "manifest")} <= scanned
    assert {"ops/segment_kernels.py", "utils/profiling.py", "utils/metrics.py"} <= scanned


@pytest.mark.parametrize("source, flagged", [
    ("import page_rank_and_tfidf_using_apache_spark_tpu_torch.ops", set()),
    ("from page_rank_and_tfidf_using_apache_spark_tpu_torch import api", set()),
    ("from page_rank_and_tfidf_using_apache_spark_tpu.io import graph",
     {"page_rank_and_tfidf_using_apache_spark_tpu"}),
    ("import jax.numpy as jnp", {"jax"}),
    ("import importlib\nimportlib.import_module('jaxlib.xla')", {"jaxlib"}),
])
def test_import_scan_matches_whole_names(source, flagged):
    """The port's name begins with the JAX package's: the scan compares
    whole top-level names, never prefixes."""
    assert top_level_imports(source) & FORBIDDEN == flagged


def test_port_runs_with_jax_unimportable():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import page_rank_and_tfidf_using_apache_spark_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import SPMV_IMPLS
g = synthetic_powerlaw(60, 300, seed=1)
for impl in SPMV_IMPLS:
    res = port.pagerank(g, dangling="redistribute", init="uniform", spmv_impl=impl,
                        dtype="float64", device="cpu")
    assert abs(res.ranks.sum() - 1.0) < 1e-12, (impl, res.ranks.sum())
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


TOOLS = {"gather_micro": gather_micro, "spmv_breakdown": spmv_breakdown,
         "xla_cost_micro": xla_cost_micro}


@pytest.mark.parametrize("entry", ["api", "run_pagerank", "cli", *TOOLS, "api_tfidf",
                                   "run_tfidf", "cli_tfidf"])
def test_entry_points_raise_without_cuda(entry, monkeypatch, tmp_path):
    """With no CUDA and no ``device=``, every entry point raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synthetic_powerlaw(30, 90, seed=2)
    docs = ["a b c", "b c d"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "api":
            pagerank(g)
        elif entry == "run_pagerank":
            run_pagerank(g, PageRankConfig())
        elif entry == "cli":
            cli.main([TINY, "5", "--output", str(tmp_path / "r.txt")])
        elif entry == "api_tfidf":
            tfidf(docs)
        elif entry == "run_tfidf":
            run_tfidf(docs, TfidfConfig())
        elif entry == "cli_tfidf":
            tfidf_cli.main([TINY, "--lines", "--output", str(tmp_path / "r.json")])
        else:
            TOOLS[entry].main(["--reps", "1", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_explicit_cpu_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = pagerank(synthetic_powerlaw(30, 90, seed=2), device="cpu")
    assert res.ranks.shape == (res.ranks.size,) and np.isfinite(res.ranks).all()


def test_explicit_cpu_runs_tfidf(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tfidf(["a b c", "b c d"], vocab_bits=8, device="cpu")
    assert out.nnz == 6 and np.isfinite(out.weight).all()


def test_tfidf_runs_with_jax_unimportable():
    code = """
import sys
for name in ("jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import page_rank_and_tfidf_using_apache_spark_tpu_torch as port
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import load_snap
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native
out = port.tfidf(["the cat sat", "the dog sat", ""], vocab_bits=10, l2_normalize=True,
                 device="cpu")
assert out.nnz == 6 and out.metrics.records[0]["native"], out.metrics.records
assert load_snap(sys.argv[1]).native_steps == ("parse", "sort")
assert native.available()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code, TINY], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_the_reference_native_path(path):
    """The port builds and reads only its own copy of ``native/``."""
    text = path.read_text()
    for pattern in ("apache_spark_tpu/native", "apache_spark_tpu.native",
                    '"native", "build"', "native/build"):
        assert pattern not in text, (path.relative_to(ROOT), pattern)


def test_native_library_lives_in_the_port():
    for p in (native.SRC, native.BUILD_DIR, native.LIB_PATH):
        assert pathlib.Path(p).resolve().is_relative_to(PORT), p
