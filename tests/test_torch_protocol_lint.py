"""The port's tier-6 wire-protocol analysis and its conformance harness
against the JAX package's, on the CPU.

Mirrors ``tests/test_protocol_lint.py``:

1. **The reference's fixture cases, on the port** — every fixture test of
   the reference (a tree analyzed through ``wire(...)``, the floor cases
   through ``_floor``) runs with its assertions unchanged, its tree
   analyzed by both analyzers: the same rule ids at the same paths and
   lines, and the port's result is what the reference's assertions read.
2. **The port's contract** — ``WIRE_SCHEMAS`` resolves over the port's
   ``serving/fabric.py``, ``obs/export.py`` and ``obs/federation.py``,
   its rows are the reference's but for the package name, the whole wire
   surface is clean, and ``protocol.py`` is the reference's code.
3. **The derived message space and the live harness** — the port's
   ``--wire-probes`` equals the reference's enumeration; the port's
   ``tools/protocol_harness.py`` conforms against a fixture replica on the
   CPU (no double execution, ``double_served == 0``, a typed
   ``FabricExhausted`` on a stale floor); and deleting the query row's 503
   from a scratch copy of the contract fails both the static check and
   the harness.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import inspect
import json
import os
import re
import textwrap
import time
from pathlib import Path

import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.analysis import protocol as ref_protocol
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
    baseline_path,
    load_baseline,
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import __main__ as lint_cli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import protocol
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.protocol import (
    PROTO_RULES,
    SCAN_MODULES,
    enumerate_message_space,
    run_protocol,
    wire_contract,
    wire_fingerprint,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import protocol_harness

REPO = repo_root()
PORT = REPO / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF = REPO / "page_rank_and_tfidf_using_apache_spark_tpu"
_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
PKG_RE = re.compile(r"\bpage_rank_and_tfidf_using_apache_spark_tpu\b")
REF_TESTS = Path(__file__).resolve().parent / "test_protocol_lint.py"


def _reference_module():
    spec = importlib.util.spec_from_file_location("reference_test_protocol_lint", REF_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_MODULE = _reference_module()


def _calls(fn_name: str, helpers: tuple) -> bool:
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(REF_MODULE, fn_name))))
    return any(isinstance(n, ast.Call) and getattr(n.func, "id", None) in helpers
               for n in ast.walk(tree))


REF_CASES = sorted(n for n in dir(REF_MODULE)
                   if n.startswith("test_") and _calls(n, ("wire", "_floor")))


def _write(root: Path, files: dict[str, str], translate: bool) -> None:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(PKG_RE.sub(_PKG, src) if translate else src))


def _key(findings) -> set:
    return {(f.rule, f.path, f.line) for f in findings}


def wire_both(tmp_path: Path, files: dict[str, str], extra: tuple = ()):
    """The tree through both analyzers: parity asserted, the port's result
    returned."""
    _write(tmp_path / "ref", files, translate=False)
    _write(tmp_path / "port", files, translate=True)
    ref = ref_protocol.run_protocol(
        root=tmp_path / "ref",
        models=ref_protocol.build_models(tmp_path / "ref", extra=tuple(extra) or None))
    port = run_protocol(
        root=tmp_path / "port",
        models=protocol.build_models(tmp_path / "port", extra=tuple(extra) or None))
    assert _key(port.findings) == _key(ref.findings)
    assert port.monitored == ref.monitored
    return port


def test_reference_cases_found():
    assert len(REF_CASES) >= 25


@pytest.mark.parametrize("name", REF_CASES)
def test_reference_case_on_the_port(name, tmp_path, monkeypatch):
    """The reference's own fixture test, its assertions unchanged, with its
    tree analyzed by the port (and held equal to the reference's)."""
    monkeypatch.setattr(REF_MODULE, "wire", wire_both)
    getattr(REF_MODULE, name)(tmp_path)


# --------------------------------------------------------- the real contract


def test_real_contract_resolves():
    contract = wire_contract(REPO)
    assert contract is not None and contract.rows
    assert contract.relpath == f"{_PKG}/analysis/registry.py"
    models = protocol.build_models(REPO)
    for row in contract.rows:
        assert protocol._resolve_spec(models, row.handler) is not None, row.handler
        assert row.handler.startswith(_PKG)
        for spec in row.readers:
            assert protocol._resolve_spec(models, spec) is not None, spec
        assert row.status_classes, row.endpoint
    query = next(r for r in contract.rows if r.endpoint == "query")
    assert set(query.request_keys) == {"rid", "terms", "ranker"}
    assert (503, "retryable") in query.status_classes


def test_contract_rows_are_the_references():
    """The port's fleet speaks the reference's wire format: every row but
    the package name of its specs."""
    def norm(contract):
        return json.loads(json.dumps([dataclasses.astuple(r) for r in contract.rows])
                          .replace(_PKG, "PKG")
                          .replace("page_rank_and_tfidf_using_apache_spark_tpu", "PKG"))

    assert norm(wire_contract(REPO)) == norm(ref_protocol.wire_contract(REPO))


def test_wire_fingerprint_is_stable_hex():
    fp = wire_fingerprint(REPO)
    assert fp is not None and re.fullmatch(r"[0-9a-f]{16}", fp)
    assert wire_fingerprint(REPO) == fp


@pytest.fixture(scope="module")
def repo_run():
    t0 = time.monotonic()
    res = run_protocol(root=REPO)
    return res, time.monotonic() - t0


def test_whole_repo_protocol_clean(repo_run):
    """No tier-6 finding over the port's wire surface beyond the (empty)
    baseline, within 3x the 10 s budget tools/lint.sh holds it to."""
    res, elapsed = repo_run
    baseline = load_baseline(baseline_path(REPO))
    new = [f for f in res.findings if f.fingerprint not in baseline]
    assert not new, "\n".join(f.render() for f in new)
    assert elapsed < 30.0, f"tier-6 sweep took {elapsed:.1f}s"
    assert set(SCAN_MODULES) == {f"{_PKG}/serving/fabric.py", f"{_PKG}/obs/export.py",
                                 f"{_PKG}/cli/serve.py"}
    assert set(SCAN_MODULES) <= set(res.monitored)


def test_copy_matches_reference():
    """``protocol.py`` is the reference's code, docstrings aside, with the
    package name its docstring names."""
    def code(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(tree).replace(_PKG, "page_rank_and_tfidf_using_apache_spark_tpu")

    assert code(PORT / "analysis" / "protocol.py") == code(REF / "analysis" / "protocol.py")


# --------------------------------------------------- derived message space


def test_message_space_equals_the_references():
    probes = enumerate_message_space(REPO)
    assert probes == ref_protocol.enumerate_message_space(REPO)
    q_kinds = {p["kind"] for p in probes if p.get("endpoint") == "query"}
    assert {"malformed-syntax", "malformed-shape", "missing-rid", "missing-terms",
            "wrong-method", "undeclared-key", "duplicate-rid", "stale-floor",
            "declared-codes", "optional-ranker"} <= q_kinds
    stale = next(p for p in probes if p.get("endpoint") == "query"
                 and p["kind"] == "stale-floor")
    assert stale["expect"] == [503]
    assert any(p["kind"] == "unknown-path" for p in probes)


def test_cli_tier6_clean(capsys):
    rc = lint_cli.main(["--tier", "6"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "clean" in out


def test_cli_list_rules_has_tier6(capsys):
    assert lint_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in PROTO_RULES:
        assert rule in out
    assert "[tier 6]" in out


def test_cli_wire_probes_json(capsys):
    assert lint_cli.main(["--tier", "6", "--wire-probes", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["tiers"] == [6]
    kinds = {p["kind"] for p in doc["wire_probes"]}
    assert {"duplicate-rid", "stale-floor", "unknown-path"} <= kinds


# ------------------------------------- seeded mutation + the live harness


def _mutated_contract():
    """The acceptance mutation on a scratch copy of the port's contract:
    delete the query row's declared 503."""
    real = wire_contract(REPO)
    rows = tuple(
        dataclasses.replace(row, status_classes=tuple(
            (c, cls) for c, cls in row.status_classes if c != 503))
        if row.endpoint == "query" else row
        for row in real.rows
    )
    return dataclasses.replace(real, rows=rows)


def test_seeded_mutation_caught_statically(monkeypatch):
    monkeypatch.setitem(protocol._contract_cache, str(REPO), _mutated_contract())
    res = run_protocol(root=REPO)
    assert [f for f in res.findings if f.rule == "endpoint-contract-drift" and "503" in f.message]


def test_harness_conformant_against_real_contract(monkeypatch):
    """The port's harness, its fixture replica and the router on the CPU:
    every probe answers in its timeout with a declared code, the duplicate
    rid leaves executions unmoved, no double serve, a typed refusal."""
    monkeypatch.setenv("GRAFT_CHAOS", "replica_query:fail@1")  # cleared for the run
    report = protocol_harness.run_harness(timeout_s=10.0, device="cpu")
    assert "fatal" not in report, report
    assert report["ok"] is True, report["violations"]
    assert report["probes"] >= 10 and report["replica_checks"] >= 2
    assert report["router_checks"] >= 1
    assert report["fingerprint"] == wire_fingerprint(REPO)
    assert report["device"] == "cpu"
    assert report["duplicate_executions"] == 0 and report["double_served"] == 0
    assert report["router_refusal"] == "FabricExhausted"
    assert report["handshake_s"] > 0
    assert os.environ["GRAFT_CHAOS"] == "replica_query:fail@1"  # restored


def test_seeded_mutation_caught_on_the_wire(monkeypatch):
    """The same mutation fails the live harness: the replica's floor
    refusal (503) is observed on the wire but no longer declared."""
    monkeypatch.setitem(protocol._contract_cache, str(REPO), _mutated_contract())
    report = protocol_harness.run_harness(timeout_s=10.0, device="cpu")
    assert "fatal" not in report, report
    assert report["ok"] is False
    assert any("contract drift caught on the wire" in v["detail"]
               for v in report["violations"]), report["violations"]


def test_harness_cli_exit_codes(monkeypatch, capsys):
    """0 conforms; 2 when the fixture fleet cannot come up (no CUDA for the
    default device here)."""
    assert protocol_harness.main(["--device", "cpu", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert protocol_harness.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
