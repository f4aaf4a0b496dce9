"""The port's tier 3, passive half (``..._torch/analysis/cost.py``): the
static cost model of the registered entry points, against the reference's
tier-3 tests (``tests/test_cost_lint.py``).

For each check a true positive (a seeded entry point that must fire), a
true negative and a suppressed positive, under the reference's rule ids;
the in-place contract's mutations (a declared update that does not happen,
an undeclared write into an input) both ways.  Then: each kernel op costs
what the kernels' bounds count; the static pad_frac planner against the
reference's dryrun record and against what ``partition_graph`` places;
the provenance guard of the port's cost artifacts, which arms the
intensity gate only with a gpu stamp; and the whole registry clean.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import repo_root
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import cost, semantic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import trace as tr
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
    ENTRY_POINTS,
    EntryPoint,
    Traceable,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import artifacts

REPO = repo_root()
PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"


def _baseline(tmp_path: Path, backend: str) -> Path:
    p = tmp_path / f"cost_{backend}.json"
    p.write_text(json.dumps({"backend": backend, "ops": {}}))
    return p


def run_entries(*entries: EntryPoint, baseline: Path | None = None):
    return cost.run_cost(root=REPO, entries=list(entries), baseline_path=baseline)


def rules_hit(findings) -> set[str]:
    return {f.rule for f in findings}


# ---------------------------------------------------------- intensity-floor


def _build_memory_bound():
    """x + 1: one flop per element over 8 bytes read and written — a
    static intensity of 0.125, far under a floor of 1.0."""

    def f(x):
        return x + 1.0

    return Traceable(f, [("v", (tr.spec((1024,)),))])


def test_intensity_true_positive_with_gpu_baseline(tmp_path):
    ep = EntryPoint(name="membound", module="x.py", build=_build_memory_bound,
                    intensity_floor=1.0)
    res = run_entries(ep, baseline=_baseline(tmp_path, "gpu"))
    findings = [f for f in res.findings if f.rule == "intensity-floor"]
    assert findings and "below the declared floor" in findings[0].message
    assert "0.1250" in findings[0].message
    assert not res.advisories


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_intensity_advisory_without_gpu_baseline(tmp_path, backend):
    """The provenance downgrade: a cost artifact stamped by another backend
    (or none) must not gate the card's kernels — the same regression is a
    non-gating advisory."""
    ep = EntryPoint(name="membound", module="x.py", build=_build_memory_bound,
                    intensity_floor=1.0)
    res = run_entries(ep, baseline=_baseline(tmp_path, backend))
    assert "intensity-floor" not in rules_hit(res.findings)
    adv = [f for f in res.advisories if f.rule == "intensity-floor"]
    assert adv and "ADVISORY" in adv[0].message
    assert res.ok


def test_intensity_true_negative(tmp_path):
    ep = EntryPoint(name="membound", module="x.py", build=_build_memory_bound,
                    intensity_floor=0.01)
    res = run_entries(ep, baseline=_baseline(tmp_path, "gpu"))
    assert "intensity-floor" not in rules_hit(res.findings + res.advisories)


def test_intensity_suppressed(tmp_path):
    ep = EntryPoint(name="membound", module="x.py", build=_build_memory_bound,
                    intensity_floor=1.0, suppress=frozenset({"intensity-floor"}))
    res = run_entries(ep, baseline=_baseline(tmp_path, "gpu"))
    assert "intensity-floor" not in rules_hit(res.findings + res.advisories)


# ---------------------------------------------------------- pad-frac-budget


def _build_trivial():
    def f(x):
        return x * 2.0

    return Traceable(f, [("v", (tr.spec((16,)),))])


def test_pad_frac_true_positive():
    ep = EntryPoint(name="padded", module="x.py", build=_build_trivial,
                    pad_plan=lambda: [("d4", 0.62), ("d2", 0.10)], pad_frac_ceiling=0.25)
    findings = [f for f in run_entries(ep).findings if f.rule == "pad-frac-budget"]
    assert findings and "0.6200" in findings[0].message
    assert "'d4'" in findings[0].message  # the worst plan point


def test_pad_frac_true_negative():
    ep = EntryPoint(name="padded", module="x.py", build=_build_trivial,
                    pad_plan=lambda: [("d4", 0.12)], pad_frac_ceiling=0.25)
    assert "pad-frac-budget" not in rules_hit(run_entries(ep).findings)


def test_pad_frac_suppressed():
    ep = EntryPoint(name="padded", module="x.py", build=_build_trivial,
                    pad_plan=lambda: [("d4", 0.62)], pad_frac_ceiling=0.25,
                    suppress=frozenset({"pad-frac-budget"}))
    assert "pad-frac-budget" not in rules_hit(run_entries(ep).findings)


# -------------------------------------------------------- donation-contract


def _build_carry(in_place: bool):
    """A carry-shaped step, ``(c, x) -> (c + x, 2x)``: with ``in_place``
    it updates the carry's storage (the port's spelling of a donation),
    else it writes a fresh tensor."""

    def build():
        def f(c, x):
            return (c.add_(x) if in_place else c + x), x * 2.0

        return Traceable(f, [("v", (tr.spec((8,)), tr.spec((8,))))])

    return build


def test_donation_declared_but_absent_is_a_finding():
    ep = EntryPoint(name="carry", module="x.py", build=_build_carry(False), donate=(0,))
    findings = [f for f in run_entries(ep).findings if f.rule == "donation-contract"]
    assert findings and "does not happen" in findings[0].message


def test_donation_true_negative():
    ep = EntryPoint(name="carry", module="x.py", build=_build_carry(True), donate=(0,))
    res = run_entries(ep)
    assert "donation-contract" not in rules_hit(res.findings)
    assert res.report["entries"][0]["donation"] == {"declared": [0], "written": [0]}


def test_undeclared_donation_is_a_finding():
    """The inverse direction: a write into an input the registry does not
    declare (callers must know their tensor changes)."""
    ep = EntryPoint(name="carry", module="x.py", build=_build_carry(True), donate=())
    findings = [f for f in run_entries(ep).findings if f.rule == "donation-contract"]
    assert findings and "undeclared" in findings[0].message


def test_donation_through_a_view_is_a_write():
    """A write into a slice of an input writes the input."""

    def build():
        def f(c):
            c[1:3] = 0.0
            return c * 2.0

        return Traceable(f, [("v", (tr.spec((8,)),))])

    ep = EntryPoint(name="view", module="x.py", build=build, donate=())
    assert "donation-contract" in rules_hit(run_entries(ep).findings)


def test_donation_unchecked_when_not_declared():
    ep = EntryPoint(name="carry", module="x.py", build=_build_carry(True))
    assert "donation-contract" not in rules_hit(run_entries(ep).findings)


def test_donation_suppressed():
    ep = EntryPoint(name="carry", module="x.py", build=_build_carry(False), donate=(0,),
                    suppress=frozenset({"donation-contract"}))
    assert "donation-contract" not in rules_hit(run_entries(ep).findings)


def test_undeclared_write_into_a_real_step():
    """The mutation on a real entry: ``pagerank_step``'s step writing into
    its rank input, against its ``donate=()``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
        build_traceable,
    )

    real = next(ep for ep in ENTRY_POINTS if ep.name == "pagerank_step")
    t = build_traceable(real)

    def build():
        def fn(dg, ranks0, e):
            out = t.fn(dg, ranks0, e)[0]
            return ranks0.copy_(out)

        return Traceable(fn, t.variants, anchor=t.anchor)

    ep = EntryPoint(name="pagerank_step_writes", module=real.module, build=build, donate=())
    findings = [f for f in run_entries(ep).findings if f.rule == "donation-contract"]
    assert findings and "argnum(s) [1]" in findings[0].message


# --------------------------------------------------------- cost-entry-broken


def test_broken_entry_is_a_finding():
    def build():
        raise ImportError("entry point moved")

    ep = EntryPoint(name="gone", module="x.py", build=build)
    findings = [f for f in run_entries(ep).findings if f.rule == "cost-entry-broken"]
    assert findings and "ImportError" in findings[0].message


# ------------------------------------------------- the kernels' bound rows


def _kernel_row(fn, specs):
    summary = cost.summarize(tr.trace_variant(fn, tuple(tr.spec(s, d) for s, d in specs)))
    assert summary.eqns == 1, summary.classes
    [(name, row)] = summary.kernels.items()
    return name, row


def test_each_kernel_costs_what_its_bound_counts():
    """One row a kernel op: each input read once, each output written once,
    and the adds ``chip_smoke.py``'s bounds count (PERF.md section 6)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    f32, i32 = torch.float32, torch.int32
    n, e, r, w = 1000, 5000, 64, 128
    cases = {
        # src + ptr + w + out; one add an edge
        "segment": (lambda v, p, s: sk.segment_sum_kernel(v, p, n, src=s),
                    [((n,), f32), ((n + 1,), i32), ((e,), i32)],
                    4 * e + 4 * (n + 1) + 4 * n + 4 * n, e),
        "cumsum": (pk.cumsum_kernel, [((e,), f32)], 2 * 4 * e, e),
        "rowsum": (pk.rowsum_kernel, [((r, w), f32)], 4 * r * w + 4 * r, r * (w - 1)),
        # src + indptr + w + out; bounded by bytes
        "spmv": (lambda s, p, v: pk.spmv_pallas(s, p, v, n=n),
                 [((e,), i32), ((n + 1,), i32), ((n,), f32)],
                 4 * e + 4 * (n + 1) + 4 * n + 4 * n, 0),
        "gather": (lambda x, i: gk.take_along_rows_kernel(x, i, axis=1),
                   [((8, w), f32), ((64, w), i32)], 4 * 8 * w + 4 * 64 * w + 4 * 64 * w, 0),
    }
    for want, (fn, specs, nbytes, flops) in cases.items():
        name, row = _kernel_row(fn, specs)
        assert name == want and row == {"nodes": 1, "flops": flops, "bytes": nbytes}, (want, row)


def test_views_cost_nothing():
    def f(x):
        return x.view(4, 4).t()[1:].unsqueeze(0).expand(2, 3, 4)

    summary = cost.summarize(tr.trace_variant(f, (tr.spec((16,)),)))
    assert summary.hbm_bytes == 0 and summary.flops == 0


# ------------------------------------------- static pad_frac vs the dryrun


def _measured_dryrun_pad_fracs() -> dict[str, float]:
    """Strategy -> pad_frac the reference's 8-device dryrun measured
    (MULTICHIP_r05.json's log tail)."""
    tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    pairs = re.findall(r'"pad_frac": ([0-9.]+).*?dryrun pagerank\[(\w+)\]', tail, re.S)
    return {strategy: float(frac) for frac, strategy in pairs}


def test_static_pad_frac_matches_multichip_dryrun_within_2pct():
    """The port's planner, on the dryrun graph at its 8 slots, reproduces
    the pad_frac the reference's dryrun measured for src and nodes within
    2%, and plans strictly less than it for nodes_balanced (the min-max
    boundary search the reference adopted later)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
        plan_partition,
    )

    measured = _measured_dryrun_pad_fracs()
    d = json.loads((REPO / "MULTICHIP_r05.json").read_text())["n_devices"]
    graph = synthetic_powerlaw(64, 256, seed=0)
    for strategy in ("src", "nodes"):
        static = plan_partition(graph, d, strategy=strategy).pad_frac
        assert static == pytest.approx(measured[strategy], rel=0.02), strategy
    improved = plan_partition(graph, d, strategy="nodes_balanced").pad_frac
    assert improved < measured["nodes_balanced"] - 0.10
    assert plan_partition(graph, 4, strategy="hybrid").pad_frac <= 0.30


def test_plan_is_what_partition_graph_materializes():
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import pagerank_sharded as ps

    graph = synthetic_powerlaw(300, 2400, seed=5)
    for strategy in ("edges", "nodes", "nodes_balanced", "src", "src_ring", "hybrid"):
        for d in (1, 2, 4):
            plan = ps.plan_partition(graph, d, strategy=strategy)
            sg = ps.partition_graph(graph, d, strategy=strategy, need_local_indptr=False)
            assert sg.pad_frac == plan.pad_frac, (strategy, d)
            assert sg.n_pad == plan.n_pad and sg.block == plan.block
            assert sg.src.shape == (d, plan.e_dev)


def test_stream_pad_plan_runs_the_real_cap_policy():
    """grow_chunk_cap doubling from a 2^14 start: caps 16384, 131072,
    131072, 131072 over the registry matrix."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import stream_pad_plan

    [(label, frac)] = stream_pad_plan((9_000, 120_000, 97_531, 131_072))
    assert label == "stream"
    total_raw = 9_000 + 120_000 + 97_531 + 131_072
    assert frac == pytest.approx(1 - total_raw / (16_384 + 3 * 131_072), abs=1e-6)


# -------------------------------------------------- backend-provenance guard


def test_provenance_guard_refuses_cpu_over_gpu(tmp_path):
    p = tmp_path / "cost.json"
    artifacts.write_artifact(p, {"ops": {"x": 1}}, backend="gpu")
    assert artifacts.read_backend(p) == "gpu"
    with pytest.raises(artifacts.ProvenanceError):
        artifacts.write_artifact(p, {"ops": {"x": 2}}, backend="cpu")
    assert json.loads(p.read_text())["ops"] == {"x": 1}  # untouched
    rec = artifacts.write_artifact(p, {"v": 4}, backend="cpu", force=True)
    assert rec["backend"] == "cpu" == artifacts.read_backend(p)


def test_cost_tools_wire_the_guard():
    """The port's cost tools share one writer with --force that routes
    through utils/artifacts.py (the uniform backend stamp)."""
    src = (REPO / PKG / "tools" / "__init__.py").read_text()
    assert "artifacts.write_artifact" in src and "--force" in src
    for tool in ("xla_cost_micro.py", "gather_micro.py", "spmv_breakdown.py"):
        assert (REPO / PKG / "tools" / tool).is_file()


def test_the_gate_reads_the_ports_own_artifact():
    """The intensity gate reads the stamp of the port's artifact in its
    package directory, never the root xla_cost_tpu.json (the JAX
    package's); with none there it advises."""
    assert cost.COST_BASELINE_ARTIFACT.startswith(f"{PKG}/")
    res = cost.run_cost(root=REPO, entries=[ep for ep in ENTRY_POINTS
                                            if ep.name == "pagerank_step"])
    assert res.report["baseline_artifact"] == str(REPO / cost.COST_BASELINE_ARTIFACT)
    backend = cost.baseline_backend(REPO / cost.COST_BASELINE_ARTIFACT)
    assert res.report["intensity_gate"] == ("enforcing" if backend == "gpu" else "advisory")


# ------------------------------------------------------ the tier-3 gate


@pytest.fixture(scope="module")
def repo_cost():
    return cost.run_cost(root=REPO)


def test_repo_cost_clean(repo_cost):
    """Every registered entry point passes tier 3 with no finding: the
    ratchet stays empty.  Advisories are only intensity floors, the
    reference's numbers, while the gate advises."""
    msg = "\n".join(f.render() for f in repo_cost.findings)
    assert not repo_cost.findings, f"tier-3 findings (fix the code, not the gate):\n{msg}"
    assert {f.rule for f in repo_cost.advisories} <= {"intensity-floor"}
    assert repo_cost.report["intensity_gate"] == "advisory" or not repo_cost.advisories
    by_name = {e["entry"]: e for e in repo_cost.report["entries"]}
    assert len(by_name) == 26
    for ep in ENTRY_POINTS:
        row = by_name[ep.name]
        assert row["intensity_floor"] == ep.intensity_floor and row["intensity"] > 0, row


def test_in_place_entries_verify_in_the_report(repo_cost):
    """Declared == written: the streaming carry is written in place, every
    runner the reference donates into writes no input."""
    by_name = {e["entry"]: e for e in repo_cost.report["entries"]}
    assert by_name["tfidf_chunk_ingest_carry"]["donation"] == {"declared": [3], "written": [3]}
    for name in ("pagerank_step", "pagerank_step_tol_cumsum", "pagerank_step_pallas",
                 "pagerank_step_hybrid", "pagerank_step_sort_shuffle", "pagerank_sharded_owned",
                 "dataflow_ppr_batch", "dataflow_hits", "dataflow_components",
                 "tfidf_score_impacted_batch", "tfidf_topk_merge"):
        assert by_name[name]["donation"] == {"declared": [], "written": []}, name


def test_main_path_entries_cost_their_kernels(repo_cost):
    """Each main-path step costs its kernels as rows of their own: one op
    each where the step launches one."""
    by_name = {e["entry"]: e for e in repo_cost.report["entries"]}
    kernels = {name: next(iter(by_name[name]["variants"].values()))["kernels"]
               for name in ("pagerank_step", "pagerank_step_pallas", "pagerank_step_hybrid",
                            "pagerank_step_sort_shuffle", "pagerank_rowsum_pallas")}
    assert {k: {n: r["nodes"] for n, r in v.items()} for k, v in kernels.items()} == {
        "pagerank_step": {"segment": 1}, "pagerank_step_pallas": {"spmv": 1},
        "pagerank_step_hybrid": {"cumsum": 1, "rowsum": 1, "segment": 1},
        "pagerank_step_sort_shuffle": {"segment": 1}, "pagerank_rowsum_pallas": {"rowsum": 1}}


def test_tiers_two_and_three_share_one_trace_a_variant(repo_cost):
    """``--tier all`` traces each variant once a process: tier 2 after tier
    3 finds every trace cached."""
    cached = len(semantic._TRACE_CACHE)
    assert cached >= 26
    assert semantic.run_semantic(root=REPO) == []
    assert len(semantic._TRACE_CACHE) == cached


# ------------------------------------------------------------ CLI plumbing


def _cli(*args):
    return subprocess.run([sys.executable, "-m", f"{PKG}.analysis", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_cli_tier3_clean():
    proc = _cli("--tier", "3")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_tier_all_runs_every_tier_clean():
    proc = _cli("--tier", "all", "--json")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    doc = json.loads(proc.stdout)
    assert doc["ok"] and doc["findings"] == [] and doc["tiers"] == [1, 2, 3, 4, 5, 6]


def test_cli_cost_report():
    proc = _cli("--tier", "3", f"{PKG}/ops/pagerank.py", "--cost-report", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)["cost_report"]
    names = {e["entry"] for e in report["entries"]}
    assert {"pagerank_step", "pagerank_sharded_owned"} <= names
    assert "tfidf_batch_pipeline" not in names  # not watching ops/pagerank.py
    sample = next(e for e in report["entries"] if e["entry"] == "pagerank_step")
    variant = next(iter(sample["variants"].values()))
    assert variant["flops"] > 0 and variant["hbm_bytes"] > 0
    assert 0 < variant["intensity"] < 10


def test_cli_list_rules_includes_tier3():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid in ("intensity-floor", "pad-frac-budget", "donation-contract", "cost-entry-broken"):
        assert rid in proc.stdout
