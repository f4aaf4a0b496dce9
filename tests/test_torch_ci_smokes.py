"""The CI gate's smokes (``..._torch/tools/ci_smokes.py``) and the port's
three gate scripts, on the CPU.

Each smoke runs at the reference's sizes (``tools/ci.sh``) with
``device="cpu"`` and must hold the reference's bars and its budget knob
(the functions assert them); the crash-harness smoke runs beside the crash
scenario in ``test_torch_chaos_scenarios.py``, to balance the two files.
A smoke's audit holds the reference router's audit keys.  The scripts
parse with ``bash -n``, are executable, stop on the first failure and name
no module of the JAX package; nor do the two Python modules import one.  The tests that ran positionally or compared
two packages' env-plan runs (repaired for the chaos gate) pass in a fresh
process under a plan that faults every second guarded call.
"""

from __future__ import annotations

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.serving import fabric as jfabric
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import ci_smokes

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = REPO / "page_rank_and_tfidf_using_apache_spark_tpu_torch" / "tools"
SCRIPTS = ("chaos.sh", "ci.sh", "precommit.sh")
JAX_PACKAGE = re.compile(r"\bpage_rank_and_tfidf_using_apache_spark_tpu(?!_torch)\b")

# the tests that read a record by position or compared two packages' runs
# under one env plan, whose calls each package counts on its own
REPAIRED = (
    "tests/test_torch_pagerank.py::test_run_records_metrics_and_writes_checkpoints",
    "tests/test_torch_fixpoint.py::test_records_and_spans_match_reference_names",
    "tests/test_torch_streaming.py::test_metrics_and_spans_match_reference_names",
    "tests/test_torch_tfidf.py::test_cli_matches_reference_cli",
    "tests/test_torch_obs.py::test_federation_scrape_matches_reference",
)


def _audit_keys_are_the_references(audit: dict, tmp_path) -> None:
    ref = jfabric.ServingFabric(str(tmp_path), jfabric.FabricConfig(federation=False)).audit()
    assert set(audit) <= set(ref)
    assert audit["dropped"] == audit["double_served"] == 0


# ------------------------------------------------------------- the smokes

def test_autotune_smoke():
    got = ci_smokes.autotune("cpu")
    assert got["prune_frac"] >= 0.30 and got["budget_s"] == 60.0
    assert got["seconds"] <= got["budget_s"] and got["knobs"] == 10


@pytest.mark.slow  # 43.0 s under the chaos gate's six workers; ci.sh runs it whole
def test_drain_kill_matrix_smoke(tmp_path):
    got = ci_smokes.drain("cpu")
    assert got["budget_s"] == 40.0 and got["seconds"] <= got["budget_s"]
    assert not got.get("skipped"), got["line"]
    assert got["audit"]["rolled"] == 3
    _audit_keys_are_the_references(got["audit"], tmp_path)


def test_traced_run_smoke():
    got = ci_smokes.traced("cpu")
    assert got["chunks"] == 3 and got["backend"] == "cpu"


def test_soak_smoke(monkeypatch):
    monkeypatch.delenv("GRAFT_SOAK_DURATION_S", raising=False)
    monkeypatch.delenv("GRAFT_SOAK_QPS", raising=False)
    plan = os.environ.get("GRAFT_CHAOS")
    got = ci_smokes.soak("cpu")
    assert got["dropped"] == got["double_served"] == 0
    assert got["time_to_recover_s"] is not None
    assert {"served_p99_ms", "recovery", "ingest", "requests", "qps"} <= set(got["keys"])
    # the plan is the smoke's own: nothing of it outlives the call
    assert os.environ.get("GRAFT_CHAOS") == plan


def test_fabric_smoke(tmp_path):
    got = ci_smokes.fabric_smoke("cpu")
    assert got["budget_s"] == 25.0 and got["audit"]["respawns"] >= 1
    _audit_keys_are_the_references(got["audit"], tmp_path)


def test_federation_smoke(tmp_path):
    got = ci_smokes.federation("cpu")
    assert got["budget_s"] == 25.0 and got["merged_requests"] >= 8
    assert got["audit"]["scale_ups"] >= 1
    _audit_keys_are_the_references(got["audit"], tmp_path)


def test_segment_smoke():
    got = ci_smokes.segment("cpu")
    assert got["budget_s"] == 15.0 and got["doc"] == 12


def test_owned_smoke():
    got = ci_smokes.owned("cpu")
    assert got["budget_s"] == 30.0 and got["l1"] <= 1e-9
    assert got["comm_bytes_per_step"] > 0


def test_a_blown_budget_fails_the_smoke(monkeypatch):
    monkeypatch.setenv("GRAFT_SEG_BUDGET_S", "0")
    with pytest.raises(AssertionError, match="exceeded its 0s budget"):
        ci_smokes.segment("cpu")


def test_cli_runs_named_smokes(capsys):
    assert ci_smokes.main(["--device", "cpu", "segment", "owned"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(" (")[0] for ln in out] == ["OK segment", "OK owned"]
    assert list(ci_smokes.SMOKES) == ["autotune", "crash", "drain", "traced", "soak", "fabric",
                                      "federation", "segment", "owned"]


# ------------------------------------------------------------ the scripts

@pytest.mark.parametrize("script", SCRIPTS)
def test_script_parses_and_names_no_jax_module(script):
    path = TOOLS / script
    assert subprocess.run(["bash", "-n", str(path)]).returncode == 0
    assert os.access(path, os.X_OK)
    text = path.read_text()
    assert text.startswith("#!/usr/bin/env bash\n") and "\nset -euo pipefail\n" in text
    assert not JAX_PACKAGE.search(text), JAX_PACKAGE.search(text)


def test_ci_runs_every_gate_in_order():
    text = (TOOLS / "ci.sh").read_text()
    order = ["tests/test_torch_*.py", '"$TOOLS/lint.sh"', "tools.ci_smokes",
             '"$TOOLS/chaos.sh"', "CI: all gates green"]
    at = [text.index(s) for s in order]
    assert at == sorted(at)
    chaos = (TOOLS / "chaos.sh").read_text()
    for s in ("GRAFT_CHAOS='*:fail@%5'", "GRAFT_RETRY_MAX=4", "GRAFT_BACKOFF_BASE_S=0.01",
              "GRAFT_SYNC_DEADLINE_S=60", "-n 6 --dist loadfile", '"$@"',
              "tools.chaos_scenarios\" --device cpu"):
        assert s in chaos, s
    assert '--changed-only "$BASE"' in (TOOLS / "precommit.sh").read_text()


@pytest.mark.parametrize("module", ["chaos_scenarios.py", "ci_smokes.py"])
def test_modules_import_no_jax(module):
    tree = ast.parse((TOOLS / module).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names
                          if m.split(".")[0] == "jax" or JAX_PACKAGE.match(m)], names


# ------------------------------------------------- the repaired tests

def test_repaired_tests_pass_under_a_fault_every_second_call():
    """The five tests repaired for the chaos gate, in a fresh process under
    ``*:fail@%2``: each passes (on the tree before the repair, four of
    them failed so)."""
    env = {**os.environ, "GRAFT_CHAOS": "*:fail@%2", "GRAFT_RETRY_MAX": "4",
           "GRAFT_BACKOFF_BASE_S": "0.01", "GRAFT_SYNC_DEADLINE_S": "60"}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *REPAIRED, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert re.search(r"\b7 passed\b", proc.stdout), proc.stdout[-500:]
