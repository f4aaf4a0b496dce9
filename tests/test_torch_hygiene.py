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
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import workloads as workloads_cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import run_components
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch import parallel
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
    run_tfidf,
    run_tfidf_streaming,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import (
    autotune,
    gather_micro,
    spmv_breakdown,
    xla_cost_micro,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    HitsConfig,
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


def test_scan_covers_the_streaming_slice():
    """The ingest pipeline, checkpoints, BM25 and the index are among the
    files the scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"dataflow/ingest.py", "dataflow/bm25.py", "utils/checkpoint.py",
            "serving/__init__.py", "serving/artifact.py", "models/tfidf.py"} <= scanned


def test_scan_covers_the_serving_slice():
    """The server, the segments copy and the serve CLI are among the files
    the scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"serving/server.py", "serving/segments.py", "cli/serve.py"} <= scanned


def test_scan_covers_the_workloads_slice():
    """The segment driver, the combine primitives, the three workloads and
    their CLI are among the files the scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"dataflow/fixpoint.py", "dataflow/combine.py", "dataflow/ppr.py",
            "dataflow/hits.py", "dataflow/components.py", "models/driver.py",
            "cli/workloads.py"} <= scanned


def test_scan_covers_the_resilience_slice():
    """The fault injector, the retry executor, the device-health registry
    and their package are among the files the scan reads, and import with
    JAX unimportable (the ``walk_packages`` test below imports every
    module)."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"resilience/__init__.py", "resilience/chaos.py",
            "resilience/elastic.py", "resilience/executor.py"} <= scanned


def test_scan_covers_the_tuned_profile_slice():
    """The tuner and the modules of the knob resolution ladder are among
    the files the scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"tools/autotune.py", "utils/config.py", "obs/manifest.py", "cli/pagerank.py",
            "cli/tfidf.py", "cli/serve.py"} <= scanned


def test_scan_covers_the_parallel_slice():
    """The mesh, the collectives, the three sharded runners, the boundary
    planner and the partitioned-collection types are among the files the
    scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
            "parallel/pagerank_sharded.py", "parallel/tfidf_sharded.py",
            "parallel/workloads_sharded.py", "ops/boundary.py",
            "dataflow/partition.py"} <= scanned


def test_scan_covers_the_fleet_slice():
    """The process supervisor, the fabric, the soaks and the crash harness
    are among the files the scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"resilience/process.py", "serving/fabric.py", "serving/soak.py",
            "tools/crash_harness.py"} <= scanned


def test_scan_covers_the_analysis_slice():
    """The port's static analysis, its gate and the protocol harness are
    among the files the scan reads."""
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {f"analysis/{m}.py" for m in ("__init__", "__main__", "findings", "engine",
                                         "context", "rules", "registry", "concurrency",
                                         "persistence", "protocol")} <= scanned
    assert "tools/protocol_harness.py" in scanned


ANALYSIS = sorted((PORT / "analysis").glob("*.py"))


@pytest.mark.parametrize("path", ANALYSIS, ids=lambda p: p.name)
def test_analysis_imports_only_the_stdlib(path):
    """The analyzer never imports the code it scans: no torch, no numpy, no
    jax, nothing of the JAX package — the stdlib and its own modules."""
    allowed = set(sys.stdlib_module_names) | {"page_rank_and_tfidf_using_apache_spark_tpu_torch"}
    bad = top_level_imports(path.read_text()) - allowed
    assert not bad, f"{path.name} imports {sorted(bad)}"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("page_rank_and_tfidf_using_apache_spark_tpu_torch"):
            assert node.module.startswith(
                "page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis"), node.module


def test_analyzer_runs_with_torch_unimportable():
    """Every ported tier runs with torch, numpy and JAX unimportable, as the
    reference's runs even when jax is broken: the CLI's tier 1 over the
    analyzer's own modules and tier 6 over the wire surface, tiers 4 and 5
    over the serving modules."""
    code = """
import sys
for name in ("torch", "numpy", "jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
from pathlib import Path
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import __main__ as cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import concurrency, persistence
port = Path("page_rank_and_tfidf_using_apache_spark_tpu_torch")
assert cli.main(["--tier", "1", str(port / "analysis")]) == 0
assert cli.main(["--tier", "6"]) == 0
root = Path.cwd()
assert not concurrency.run_concurrency(root=root, paths=[port / "serving"]).findings
assert not persistence.run_persistence(root=root, paths=[port / "serving"]).findings
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


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


def test_port_runs_with_jax_unimportable(tmp_path):
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
# a fleet replica process, itself started with JAX unimportable, shakes
# hands and answers a query
import json, urllib.request
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import process
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
tmp = sys.argv[1]
cfg = port.TfidfConfig(vocab_bits=10)
out = port.tfidf(["the cat sat", "the dog sat", "a cat ran"], cfg, device="cpu")
sgm.commit_append(tmp, sgm.seal_segment(tmp, out, cfg, doc_base=0, bm25=None),
                  cfg.config_hash())
child = ("import sys\\n"
         "for n in ('jax', 'jaxlib', 'page_rank_and_tfidf_using_apache_spark_tpu'):\\n"
         "    sys.modules[n] = None\\n"
         "from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric\\n"
         "sys.exit(fabric.main(sys.argv[1:]))\\n")
h = process.ProcessHandle([sys.executable, "-c", child, "--replica", tmp, "--device", "cpu",
                           "--top-k", "2"], ready_timeout_s=120.0).spawn()
try:
    req = urllib.request.Request(f"http://127.0.0.1:{h.ready['port']}/query",
                                 data=json.dumps({"rid": "h-1", "terms": ["cat"]}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["docs"][0] in (0, 2)
    assert h.terminate(20.0) == 0
finally:
    h.kill()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


TOOLS = {"gather_micro": gather_micro, "spmv_breakdown": spmv_breakdown,
         "xla_cost_micro": xla_cost_micro}


@pytest.mark.parametrize("entry", ["api", "run_pagerank", "cli", *TOOLS, "api_tfidf",
                                   "run_tfidf", "cli_tfidf", "api_tfidf_streaming",
                                   "run_tfidf_streaming", "cli_tfidf_streaming",
                                   "run_ppr_batch", "run_hits", "run_components",
                                   "cli_workloads_ppr", "cli_workloads_hits",
                                   "cli_workloads_cc", "autotune", "run_pagerank_sharded",
                                   "run_tfidf_sharded", "run_ppr_sharded", "run_hits_sharded",
                                   "run_components_sharded", "cli_mesh", "cli_tfidf_mesh"])
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
        elif entry == "api_tfidf_streaming":
            tfidf([docs], streaming=True)
        elif entry == "run_tfidf_streaming":
            run_tfidf_streaming([docs], TfidfConfig())
        elif entry == "cli_tfidf_streaming":
            tfidf_cli.main([TINY, "--lines", "--streaming", "--save-index", str(tmp_path / "r.json"),
                            "--output", str(tmp_path / "r.json")])
        elif entry == "run_ppr_batch":
            run_ppr_batch(g, PageRankConfig(), [[int(g.node_ids[0])]])
        elif entry == "run_hits":
            run_hits(g, HitsConfig())
        elif entry == "run_components":
            run_components(g)
        elif entry.startswith("cli_workloads_"):
            workload = entry.rsplit("_", 1)[1]
            extra = ["--queries", "1"] if workload == "ppr" else []
            workloads_cli.main([workload, TINY, *extra, "--metrics-json",
                                str(tmp_path / "r.json")])
        elif entry == "run_pagerank_sharded":
            parallel.run_pagerank_sharded(g, PageRankConfig(), n_devices=1)
        elif entry == "run_tfidf_sharded":
            parallel.run_tfidf_sharded([docs], TfidfConfig(), n_devices=1)
        elif entry == "run_ppr_sharded":
            parallel.run_ppr_sharded(g, PageRankConfig(), [[int(g.node_ids[0])]])
        elif entry == "run_hits_sharded":
            parallel.run_hits_sharded(g, HitsConfig())
        elif entry == "run_components_sharded":
            parallel.run_components_sharded(g)
        elif entry == "cli_mesh":
            cli.main([TINY, "5", "--mesh", "1", "--output", str(tmp_path / "r.json")])
        elif entry == "cli_tfidf_mesh":
            tfidf_cli.main([TINY, "--lines", "--streaming", "--mesh", "1",
                            "--output", str(tmp_path / "r.json")])
        elif entry == "autotune":
            autotune.main(["--budget-s", "0", "--out", str(tmp_path / "r.json")])
        else:
            TOOLS[entry].main(["--reps", "1", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


def test_explicit_cpu_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synthetic_powerlaw(30, 90, seed=2)
    res = pagerank(g, device="cpu")
    assert res.ranks.shape == (res.ranks.size,) and np.isfinite(res.ranks).all()
    ppr = run_ppr_batch(g, PageRankConfig(), [[int(g.node_ids[0])]], device="cpu")
    assert ppr.ranks.shape == (1, g.n_nodes) and np.isfinite(ppr.ranks).all()
    hits = run_hits(g, HitsConfig(), device="cpu")
    assert hits.hubs.shape == (g.n_nodes,) and np.isfinite(hits.authorities).all()
    cc = run_components(g, device="cpu")
    assert cc.converged and cc.labels.shape == (g.n_nodes,)


def test_explicit_cpu_runs_tfidf(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tfidf(["a b c", "b c d"], vocab_bits=8, device="cpu")
    assert out.nnz == 6 and np.isfinite(out.weight).all()


def test_explicit_cpu_runs_streaming(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tfidf([["a b c"], ["b c d"]], streaming=True, vocab_bits=8, device="cpu")
    assert out.nnz == 6 and out.device == "cpu" and np.isfinite(out.weight).all()
    assert tfidf_cli.main([TINY, "--lines", "--streaming", "--chunk-docs", "5",
                           "--save-index", str(tmp_path / "idx"), "--device", "cpu"]) == 0
    assert '"bm25": true' in capsys.readouterr().err


def test_streaming_runs_with_jax_unimportable(tmp_path):
    """Streaming with checkpoints, a resume, BM25 and the index, in a
    process where JAX and the JAX package cannot be imported."""
    code = """
import sys
for name in ("jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import page_rank_and_tfidf_using_apache_spark_tpu_torch as port
from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf_streaming
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import Bm25Config
tmp = sys.argv[1]
chunks = [["the cat sat", "the dog sat"], ["a cat ran", ""], ["dogs and cats"]]
kw = dict(vocab_bits=10, l2_normalize=True, checkpoint_every=1, checkpoint_dir=tmp + "/ck")
port.tfidf(iter(chunks[:2]), streaming=True, device="cpu", **kw)
out = run_tfidf_streaming(iter(chunks), port.TfidfConfig(**kw), resume=True, device="cpu")
assert out.metrics.records[0]["event"] == "resume", out.metrics.records[0]
batch = port.tfidf([d for c in chunks for d in c], vocab_bits=10, l2_normalize=True,
                   device="cpu")
assert out.to_dense().tobytes() == batch.to_dense().tobytes()
serving.save_index(tmp + "/idx", out, port.TfidfConfig(**kw), bm25=Bm25Config())
idx = serving.load_index(tmp + "/idx")
assert idx.nnz == batch.nnz and idx.bm25_weight is not None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_serving_runs_with_jax_unimportable(tmp_path):
    """Segments sealed, committed, served by both scorings, merged and
    refreshed, and the serve CLI, in a process where JAX and the JAX
    package cannot be imported."""
    code = """
import sys
for name in ("jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import page_rank_and_tfidf_using_apache_spark_tpu_torch as port
from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import serve
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import Bm25Config
tmp = sys.argv[1]
cfg = port.TfidfConfig(vocab_bits=10)
base = 0
for docs in (["the cat sat", "the dog sat"], ["a cat ran", "dogs and cats"]):
    out = port.tfidf(docs, cfg, device="cpu")
    ref = sgm.seal_segment(tmp, out, cfg, doc_base=base, bm25=Bm25Config())
    sgm.commit_append(tmp, ref, cfg.config_hash())
    base += out.n_docs
got = []
for scoring in ("coo", "impacted"):
    with serving.TfidfServer(sgm.load_segment_set(tmp), serving.ServeConfig(
            top_k=3, scoring=scoring), device="cpu") as srv:
        got.append(srv.query(["cat"], ranker="bm25"))
        if scoring == "impacted":
            assert sgm.SegmentMerger(tmp, cfg, max_segments=1, device="cpu").merge_once()
            srv.refresh_segments(sgm.load_segment_set(tmp))
            assert srv.query(["cat"], ranker="bm25")[1].tolist() == got[-1][1].tolist()
assert got[0][0].tobytes() == got[1][0].tobytes()
assert serve.main([tmp, "--queries", sys.argv[2], "--device", "cpu"]) == 0
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), TINY], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


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
