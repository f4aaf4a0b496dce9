"""The port's tier-5 persistence & crash-consistency analysis against the
JAX package's, on the CPU.

Mirrors ``tests/test_persistence_lint.py``:

1. **The reference's fixture cases, on the port** — every fixture test of
   the reference (a tree written through ``persist(...)``) runs with its
   assertions unchanged, its tree analyzed by both analyzers: the same
   rule ids at the same paths and lines, and the port's result is what
   the reference's assertions read.  The fixtures are stdlib-only, so the
   translation is the package name.
2. **The port's contract and surface** — the port's ``ARTIFACT_SCHEMAS``
   and ``COMMIT_LOCKS`` resolve over its modules, the whole surface is
   clean under the empty baseline, and ``persistence.py`` is the
   reference's code but for its package name.
3. **The derived crash surface** — ``--crash-points`` over the port is the
   reference's enumeration, entry for entry and boundary for boundary,
   modulo the package prefix (the copies' line numbers differ where their
   docstrings do).
"""

from __future__ import annotations

import ast
import importlib.util
import inspect
import json
import re
import textwrap
import time
from pathlib import Path

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.analysis import persistence as ref_persist
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
    baseline_path,
    load_baseline,
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import __main__ as lint_cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.persistence import (
    CRASH_ENTRIES,
    PERSIST_RULES,
    build_models,
    crash_point_report,
    enumerate_crash_points,
    persist_contract,
    run_persistence,
)

REPO = repo_root()
PORT = REPO / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF = REPO / "page_rank_and_tfidf_using_apache_spark_tpu"
_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
PKG_RE = re.compile(r"\bpage_rank_and_tfidf_using_apache_spark_tpu\b")
REF_TESTS = Path(__file__).resolve().parent / "test_persistence_lint.py"


def _reference_module():
    spec = importlib.util.spec_from_file_location("reference_test_persistence_lint",
                                                  REF_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_MODULE = _reference_module()


def _calls(fn_name: str, helper: str) -> bool:
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(REF_MODULE, fn_name))))
    return any(isinstance(n, ast.Call) and getattr(n.func, "id", None) == helper
               for n in ast.walk(tree))


REF_CASES = sorted(n for n in dir(REF_MODULE)
                   if n.startswith("test_") and _calls(n, "persist"))


def _write(root: Path, files: dict[str, str], translate: bool) -> None:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(PKG_RE.sub(_PKG, src) if translate else src))


def _key(findings) -> set:
    return {(f.rule, f.path, f.line) for f in findings}


def persist_both(tmp_path: Path, files: dict[str, str]):
    """The tree through both analyzers: parity asserted, the port's result
    returned."""
    _write(tmp_path / "ref", files, translate=False)
    _write(tmp_path / "port", files, translate=True)
    ref = ref_persist.run_persistence(root=tmp_path / "ref", paths=[tmp_path / "ref"])
    port = run_persistence(root=tmp_path / "port", paths=[tmp_path / "port"])
    assert _key(port.findings) == _key(ref.findings)
    assert port.monitored == ref.monitored
    return port


def test_reference_cases_found():
    assert len(REF_CASES) >= 20


@pytest.mark.parametrize("name", REF_CASES)
def test_reference_case_on_the_port(name, tmp_path, monkeypatch):
    """The reference's own fixture test, its assertions unchanged, with its
    tree analyzed by the port (and held equal to the reference's)."""
    monkeypatch.setattr(REF_MODULE, "persist", persist_both)
    getattr(REF_MODULE, name)(tmp_path)


# ------------------------------------------------- the port's own contract


def test_real_registry_schemas_resolve():
    contract = persist_contract(REPO)
    assert contract is not None
    families = {row[0] for row in contract.schemas}
    assert families == {"index", "segment_manifest", "checkpoint_meta", "run_manifest",
                        "cost_artifact", "tuned_profile", "fabric_floor"}
    assert contract.locks == ((f"{_PKG}/serving/segments.py", "_COMMIT_LOCK",
                               ("_write_manifest",)),)
    for _family, writers, readers, _keys, _aux in contract.schemas:
        for spec in writers + readers:
            path = spec.split("::")[0]
            assert (REPO / path).exists(), spec
            assert path.startswith(_PKG) or path == "chip_smoke.py", spec


def test_schemas_are_the_references_rows():
    """Every family but the run manifest's readers (the reference's live in
    the root tools/trace_report.py, outside the port's surface) declares
    the reference's key space, writers and readers."""
    ref = {row[0]: row for row in ref_persist.persist_contract(REPO).schemas}
    port = {row[0]: row for row in persist_contract(REPO).schemas}
    assert set(port) == set(ref)

    def norm(row):
        return json.loads(json.dumps(row).replace(_PKG, "PKG").replace(
            "page_rank_and_tfidf_using_apache_spark_tpu", "PKG"))

    for family in ref:
        r, p = norm(ref[family]), norm(port[family])
        assert p[0] == r[0] and p[1] == r[1] and p[3] == r[3], family
        if family == "run_manifest":
            assert set(r[4]) <= set(p[4])
        else:
            assert p[2] == r[2] and p[4] == r[4], family


@pytest.fixture(scope="module")
def models():
    """The port's surface parsed once for the module's enumerations."""
    return build_models(REPO)


@pytest.fixture(scope="module")
def repo_run():
    t0 = time.monotonic()
    res = run_persistence(root=REPO)
    return res, time.monotonic() - t0


def test_whole_repo_persistence_clean(repo_run):
    """No tier-5 finding over the port's surface beyond the (empty)
    baseline, within 3x the 10 s budget tools/lint.sh holds it to."""
    res, elapsed = repo_run
    baseline = load_baseline(baseline_path(REPO))
    new = [f for f in res.findings if f.fingerprint not in baseline]
    assert not new, "\n".join(f.render() for f in new)
    assert elapsed < 30.0, f"tier-5 sweep took {elapsed:.1f}s"
    monitored = set(res.monitored)
    for mod in (f"{_PKG}/utils/checkpoint.py", f"{_PKG}/utils/artifacts.py",
                f"{_PKG}/serving/artifact.py", f"{_PKG}/serving/segments.py",
                f"{_PKG}/obs/manifest.py", f"{_PKG}/serving/fabric.py"):
        assert mod in monitored, mod


def test_copy_matches_reference():
    """``persistence.py`` is the reference's code, docstrings aside, with
    the package name (``_PKG``) its docstring names."""
    def code(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(tree).replace(_PKG, "page_rank_and_tfidf_using_apache_spark_tpu")

    assert code(PORT / "analysis" / "persistence.py") == \
        code(REF / "analysis" / "persistence.py")


# ------------------------------------------------- crash-point enumeration


def test_crash_points_commit_append_pinned(models):
    pts = enumerate_crash_points(REPO, f"{_PKG}/serving/segments.py::commit_append", models)
    bounds = [p for p in pts if p["boundary"]]
    assert [b["op"] for b in bounds] == ["replace", "replace"]
    assert "_write_manifest()" in bounds[0]["via"]
    assert "durable_replace()" in bounds[0]["via"]
    assert "_write_pointer()" in bounds[1]["via"]
    ops = [p["op"] for p in pts]
    assert "write" in ops and "fsync" in ops
    assert "fsync" in ops[:ops.index("replace")]


def test_crash_points_commit_replace_has_deferred_delete(models):
    pts = enumerate_crash_points(REPO, f"{_PKG}/serving/segments.py::commit_replace", models)
    assert [p["op"] for p in pts if p["boundary"]] == ["replace", "replace", "delete"]


def test_crash_points_equal_the_references(models):
    """Every commit sequence's enumeration is the reference's, point for
    point, modulo the package prefix and the copies' line numbers."""
    def norm(report):
        doc = json.loads(json.dumps(report).replace(_PKG, "PKG").replace(
            "page_rank_and_tfidf_using_apache_spark_tpu", "PKG"))
        for points in doc.values():
            for p in points or ():
                del p["line"]
        return doc

    port, ref = crash_point_report(REPO, models), ref_persist.crash_point_report(REPO)
    assert norm(port) == norm(ref)
    assert all(port[e] for e in CRASH_ENTRIES)


def test_crash_points_commit_floor_is_one_rename(models):
    """The generation floor commits by one durable rename, the one kill
    point of the crash harness's ``floor`` scenario."""
    floor = enumerate_crash_points(REPO, f"{_PKG}/serving/fabric.py::commit_floor", models)
    assert [p["op"] for p in floor if p["boundary"]] == ["replace"]


# ----------------------------------------------------------------- CLI


def test_cli_tier5_clean_with_crash_points(capsys):
    """``--tier 5 --crash-points``: clean, and every declared commit
    sequence enumerated."""
    assert lint_cli.main(["--tier", "5", "--crash-points", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["findings"] == [] and doc["tiers"] == [5]
    for entry in CRASH_ENTRIES:
        assert doc["crash_points"][entry], entry


def test_cli_list_rules_has_tier5(capsys):
    assert lint_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in PERSIST_RULES:
        assert rule in out
    assert "[tier 5]" in out
