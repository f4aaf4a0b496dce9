"""The port's tier-4 concurrency & buffer-lifetime analysis against the
JAX package's, on the CPU.

Mirrors ``tests/test_concurrency_lint.py``:

1. **Fixture parity** — every fixture tree the reference's tier-4 tests
   build (``conc(...)``) goes through both analyzers, and every snippet
   its tier-1 thread-registry tests lint (``lint_snippet(...)``) through
   both tier-1 linters: the same rule ids at the same paths and lines.
   The trees need only the package renamed, but for the retry-closure
   shape: the reference's donating ``runner`` takes the port's in-place
   ``chunk_counts_carry`` (the port's runner swaps buffers and consumes
   nothing, so ``DONATED_CALLEES`` has no ``runner`` row).
2. **The whole surface** — tier 4 over the package and ``chip_smoke.py``
   is clean under the empty baseline; the lock graph names the serving
   drain lock; the port's ``THREAD_REGISTRY`` is exactly the threads
   tier 4 finds, with the locks it sees them take; the copy module is
   held to the reference's code.
"""

from __future__ import annotations

import ast
import fnmatch
import importlib.util
import inspect
import re
import textwrap
import time
from pathlib import Path

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.analysis import concurrency as ref_conc
from page_rank_and_tfidf_using_apache_spark_tpu.analysis.engine import lint_file as ref_lint_file
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
    baseline_path,
    load_baseline,
    registry,
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import __main__ as lint_cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.concurrency import (
    CONC_RULES,
    run_concurrency,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import lint_file
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import THREAD_REGISTRY

REPO = repo_root()
PORT = REPO / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF = REPO / "page_rank_and_tfidf_using_apache_spark_tpu"
_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF_TESTS = Path(__file__).resolve().parent / "test_concurrency_lint.py"
PKG_RE = re.compile(r"\bpage_rank_and_tfidf_using_apache_spark_tpu\b")


def _reference_module():
    spec = importlib.util.spec_from_file_location("reference_test_concurrency_lint",
                                                  REF_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_MODULE = _reference_module()


def reference_calls(helper: str) -> dict[str, object]:
    """The first argument after ``tmp_path`` of every ``helper(tmp_path,
    ...)`` call in the reference's tests, evaluated in the reference
    module's namespace (so its constants and ``.replace`` edits apply),
    keyed ``<test>`` / ``<test>#<n>``."""
    namespace = vars(REF_MODULE)
    out: dict[str, object] = {}
    for fn in ast.parse(REF_TESTS.read_text()).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", None) == helper and len(n.args) >= 2]
        for i, call in enumerate(sorted(calls, key=lambda c: c.lineno)):
            expr = ast.Expression(call.args[1])
            key = fn.name if len(calls) == 1 else f"{fn.name}#{i}"
            out[key] = eval(compile(expr, str(REF_TESTS), "eval"), namespace)
    return out


REF_TREES = reference_calls("conc")
REF_SNIPPETS = reference_calls("lint_snippet")

# The retry-closure hazard in the port: a retry would add the chunk's DF to
# the carry twice.
RETRY_CLOSURE_TORCH = """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx

def hot(d_doc, d_term, d_valid, df_dev):
    return rx.run_guarded(lambda: ops.chunk_counts_carry(d_doc, d_term, d_valid, df_dev, vocab=16), site="fix_step")
"""


def torch_source(src: str) -> str:
    if src == REF_MODULE.DONATE_TP_RETRY_CLOSURE:
        return RETRY_CLOSURE_TORCH
    return PKG_RE.sub(_PKG, src)


def _write(root: Path, files: dict[str, str], translate: bool) -> None:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(torch_source(src) if translate else src))


def conc(tmp_path: Path, files: dict[str, str]):
    """Write a tiny tree (the port's spelling) and run the port's tier 4."""
    _write(tmp_path, files, translate=True)
    return run_concurrency(root=tmp_path, paths=[tmp_path])


def rules_hit(findings) -> set[str]:
    return {f.rule for f in findings}


def _key(findings) -> set:
    return {(f.rule, f.path, f.line) for f in findings}


# ------------------------------------------------------------ parity


def test_reference_fixtures_found():
    assert len(REF_TREES) >= 25 and len(REF_SNIPPETS) >= 4


def test_retry_closure_translation_keeps_its_lines():
    ref = REF_MODULE.DONATE_TP_RETRY_CLOSURE
    assert RETRY_CLOSURE_TORCH.count("\n") == ref.count("\n")


@pytest.mark.parametrize("key", sorted(REF_TREES))
def test_tier4_fixture_parity(key, tmp_path):
    """Each reference tier-4 fixture tree: the reference's findings on it
    and the port's on its translation are the same rules at the same
    paths and lines."""
    files = REF_TREES[key]
    _write(tmp_path / "ref", files, translate=False)
    ref = ref_conc.run_concurrency(root=tmp_path / "ref", paths=[tmp_path / "ref"])
    port = conc(tmp_path / "port", files)
    assert _key(port.findings) == _key(ref.findings)
    assert set(port.graph.edges) == set(ref.graph.edges)


@pytest.mark.parametrize("key", sorted(REF_SNIPPETS))
def test_thread_registry_snippet_parity(key, tmp_path):
    """The reference's tier-1 thread-registry snippets, linted by both
    tier-1 linters (with the fixture's own utils/config.py where the
    reference test writes one)."""
    src = textwrap.dedent(REF_SNIPPETS[key])
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        if key == "test_thread_registry_declared_name_quiet":
            (d / "utils").mkdir()
            (d / "utils" / "config.py").write_text(
                textwrap.dedent(REF_MODULE._TMP_CONFIG))
        (d / "snippet.py").write_text(torch_source(src) if side == "port" else src)
    ref = ref_lint_file(tmp_path / "ref" / "snippet.py", tmp_path / "ref")
    port = lint_file(tmp_path / "port" / "snippet.py", tmp_path / "port")
    assert {(f.rule, f.line) for f in port} == {(f.rule, f.line) for f in ref}


# ------------------------------------------------- the port's own cases


@pytest.fixture(scope="module")
def repo_run():
    t0 = time.perf_counter()
    res = run_concurrency(root=REPO)
    return res, time.perf_counter() - t0


def test_lock_cycle_true_positive(tmp_path):
    res = conc(tmp_path, {"snippet.py": REF_MODULE.CYCLE_TP})
    assert "lock-order-cycle" in rules_hit(res.findings)
    assert ("snippet.py::LOCK_A", "snippet.py::LOCK_B") in res.graph.edges
    assert ("snippet.py::LOCK_B", "snippet.py::LOCK_A") in res.graph.edges


def test_lock_cycle_true_negative(tmp_path):
    res = conc(tmp_path, {"snippet.py": REF_MODULE.CYCLE_TN})
    assert "lock-order-cycle" not in rules_hit(res.findings)


@pytest.mark.parametrize("spelling, kind", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("self._done.synchronize()", ".synchronize()"),
    ("self._buf.cpu()", ".cpu()"),
    ("rx.device_get(self._buf, site='s')", "device_get"),
])
def test_device_sync_under_lock(spelling, kind, tmp_path):
    """The torch spellings of a device wait block every peer needing the
    lock."""
    res = conc(tmp_path, {"snippet.py": f"""
import threading

import torch


class Hub:
    def __init__(self):
        self._lock = threading.Lock()

    def flush(self, rx):
        with self._lock:
            {spelling}
"""})
    hits = [f for f in res.findings if f.rule == "blocking-under-lock"]
    assert hits and kind in hits[0].message and hits[0].line == 13


def test_use_after_overwrite_host_read(tmp_path):
    """A host read of the DF carry after ``chunk_counts_carry`` updated it
    in place, with the carry not rebound."""
    res = conc(tmp_path, {"snippet.py": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops


def ingest(d_doc, d_term, d_valid, df_dev):
    counts, new_df = ops.chunk_counts_carry(d_doc, d_term, d_valid, df_dev, vocab=16)
    return counts, new_df, df_dev.cpu()
"""})
    hits = [f for f in res.findings if f.rule == "use-after-donate"]
    assert hits and "host-side read" in hits[0].message


def test_staging_ring_consume(tmp_path):
    """The staged copy is handed to the stream by ``consume``: the binding
    it returns is the one to read, the staged one is consumed."""
    res = conc(tmp_path, {"snippet.py": """
def launch(ring, tokens, copied):
    ring.consume(tokens, copied)
    return tokens.cpu()


def launch_rebound(ring, tokens, copied):
    tokens = ring.consume(tokens, copied)
    return tokens.cpu()
"""})
    hits = [f for f in res.findings if f.rule == "use-after-donate"]
    assert [f.line for f in hits] == [4]


def test_donation_contract_of_the_port(repo_run):
    """The port's DONATED_CALLEES names its in-place callees, at the
    positions their signatures take the overwritten storage, and the entry
    points each serves: every entry declaring a non-empty ``donate`` is
    served with its argnums, so the contract validation in both
    directions finds nothing to drift."""
    rows = {leaf: (argnums, ents) for leaf, argnums, ents in registry.DONATED_CALLEES}
    assert rows == {"chunk_counts_carry": ((3,), ("tfidf_chunk_ingest_carry",)),
                    "consume": ((0,), ())}
    donating = {ep.name: ep.donate for ep in registry.ENTRY_POINTS if ep.donate}
    assert donating == {"tfidf_chunk_ingest_carry": (3,)}
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ingest import StagingRing
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    assert list(inspect.signature(ops.chunk_counts_carry).parameters)[3] == "df_carry"
    assert list(inspect.signature(StagingRing.consume).parameters)[0] == "tensor"
    assert not [f for f in repo_run[0].findings if f.rule == "use-after-donate"]


def test_chaos_coverage_true_positive(tmp_path):
    res = conc(tmp_path, {"models/thing.py": REF_MODULE.COVERAGE_SITE})
    hits = [f for f in res.findings if f.rule == "chaos-coverage-drift"]
    assert hits and "'frob_sync'" in hits[0].message


# ------------------------------------------------------- the whole surface


def test_whole_repo_tier4_clean(repo_run):
    """No tier-4 finding over the port's surface beyond the (empty)
    baseline.  Its 10 s budget is tools/lint.sh's; here the run may take
    3x that on a loaded machine."""
    res, elapsed = repo_run
    baseline = load_baseline(baseline_path(REPO))
    new = [f for f in res.findings if f.fingerprint not in baseline]
    assert not new, "unratcheted tier-4 findings:\n" + "\n".join(f.render() for f in new)
    assert elapsed < 30.0, f"tier-4 whole-repo run took {elapsed:.1f}s"


def test_repo_lock_graph_contents(repo_run):
    g = repo_run[0].graph
    server_lock = f"{_PKG}/serving/server.py::TfidfServer._lock"
    assert server_lock in g.nodes and g.nodes[server_lock]["kind"] == "Lock"
    drains = [t for t in g.threads if t["name"] == "tfidf-serve-drain"]
    assert drains and server_lock in drains[0]["locks"]
    dot = g.to_dot()
    assert dot.startswith("digraph lock_graph") and server_lock in dot
    assert set(g.to_json()) == {"nodes", "edges", "threads"}


def _canon(lock: str, module: str) -> str:
    return lock if "::" in lock else f"{module}::{lock}"


def test_thread_registry_is_the_threads_tier4_finds(repo_run):
    """Every thread tier 4 finds is declared for its module, with every
    lock it takes; every declared thread is found, or (a name handed
    through a parameter) spelled as a literal in its module."""
    found = repo_run[0].graph.threads
    assert found
    for t in found:
        rows = [r for r in THREAD_REGISTRY
                if r[1] == t["module"] and fnmatch.fnmatch(t["name"], r[0])]
        assert rows, f"undeclared thread {t}"
        declared = {_canon(lock, t["module"]) for r in rows for lock in r[2]}
        assert set(t["locks"]) <= declared, t
    for name, module, _locks in THREAD_REGISTRY:
        if any(t["module"] == module and fnmatch.fnmatch(t["name"], name) for t in found):
            continue
        assert name.split("*")[0] in (REPO / module).read_text(), name


def test_thread_registry_covers_the_references():
    """The port declares every thread of the reference's inventory that
    the port runs (the bench's roll-load thread has no port counterpart),
    with the same locks."""
    from page_rank_and_tfidf_using_apache_spark_tpu.utils.config import (
        THREAD_REGISTRY as REF_THREADS,
    )

    port = {name: (module.replace(_PKG, "PKG"), locks) for name, module, locks in THREAD_REGISTRY}
    for name, module, locks in REF_THREADS:
        if module == "bench.py":
            continue
        ref_module = module.replace("page_rank_and_tfidf_using_apache_spark_tpu", "PKG")
        assert name in port and port[name][0] == ref_module, name
        ref_locks = {lk.replace("page_rank_and_tfidf_using_apache_spark_tpu", "PKG")
                     for lk in locks}
        port_locks = {lk.replace(_PKG, "PKG") for lk in port[name][1]}
        assert ref_locks <= port_locks, name


def test_cli_tier4_and_lock_graph(capsys):
    assert lint_cli.main(["--tier", "4", "--lock-graph"]) == 0
    out = capsys.readouterr().out
    assert "digraph lock_graph" in out and "graftlint: clean" in out


def test_list_rules_includes_tier4(capsys):
    assert lint_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in CONC_RULES:
        assert rid in out
    assert "[tier 4]" in out


def test_copy_matches_reference():
    """``concurrency.py`` is the reference's code, docstrings aside, but
    for the torch spellings its docstring names: the host reads, the
    device syncs under a lock."""
    def code(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        # the spellings that differ, by name
        skip = {"_HOST_READ_CALLS", "_HOST_READ_METHODS", "_SYNC_METHODS"}
        tree.body = [n for n in tree.body if not (
            isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) in skip)]
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and fn.name == "_blocking_kind":
                fn.body = [ast.Pass()]
        return ast.dump(tree).replace(_PKG, "page_rank_and_tfidf_using_apache_spark_tpu")

    assert code(PORT / "analysis" / "concurrency.py") == code(REF / "analysis" / "concurrency.py")


# ---------------------------------------- the reference's cases, on the port


def _calls(fn_name: str, helper: str) -> bool:
    fn = getattr(REF_MODULE, fn_name)
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return any(isinstance(n, ast.Call) and getattr(n.func, "id", None) == helper
               for n in ast.walk(tree))


REF_CASES = sorted(n for n in dir(REF_MODULE) if n.startswith("test_")
                   and (_calls(n, "conc") or _calls(n, "lint_snippet")))


def _port_conc(tmp_path, files):
    """The reference test's tree through both analyzers: parity asserted,
    the port's result handed back to the reference's assertions."""
    _write(tmp_path / "ref", files, translate=False)
    ref = ref_conc.run_concurrency(root=tmp_path / "ref", paths=[tmp_path / "ref"])
    port = conc(tmp_path / "port", files)
    assert _key(port.findings) == _key(ref.findings)
    return port


def _port_lint_snippet(tmp_path, code, name="snippet.py"):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(torch_source(code)))
    return lint_file(f, tmp_path)


@pytest.mark.parametrize("name", REF_CASES)
def test_reference_case_on_the_port(name, tmp_path, monkeypatch):
    """The reference's own fixture test, its assertions unchanged, with its
    tree (or snippet) analyzed by the port."""
    monkeypatch.setattr(REF_MODULE, "conc", _port_conc)
    monkeypatch.setattr(REF_MODULE, "lint_snippet", _port_lint_snippet)
    monkeypatch.setattr(REF_MODULE, "lint_file", lint_file)
    getattr(REF_MODULE, name)(tmp_path)
