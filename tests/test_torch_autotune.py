"""The port's autotuner (``..._torch/tools/autotune.py``) against the JAX
package's ``tools/autotune.py``, on the CPU.

The knob space and the entries' budgets are copies of the reference's
registry rows and must stay equal to them; the grid, the pad helpers, the
static prune and the survivors' order are the reference's on the same
probes, the ``hybrid`` and ``owned`` groups costed by each package's sharded
planner (``plan_partition`` at ``MESH_DEVICES`` slots).  The measured sweep
runs here with a budget of zero (every group a fallback) and on one
survivor a group, ``owned`` on four CPU slots.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from page_rank_and_tfidf_using_apache_spark_tpu.analysis.registry import (
    ENTRY_POINTS as REF_ENTRY_POINTS,
)
from page_rank_and_tfidf_using_apache_spark_tpu.analysis.registry import (
    TUNED_KNOBS as REF_TUNED_KNOBS,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import autotune
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's tools/autotune.py, loaded as its own tests load it."""
    spec = importlib.util.spec_from_file_location("autotune_reference", REPO / "tools" /
                                                  "autotune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    return autotune.build_probes()


@pytest.fixture(scope="module")
def ref_plan(ref):
    return ref.prune(ref.enumerate_grid(ref._knob_domains()), ref.build_probes(),
                     ref._entry_budgets())


@pytest.fixture(scope="module")
def plan(probes):
    return autotune.prune(autotune.enumerate_grid(autotune._knob_domains()), probes,
                          autotune._entry_budgets())


# --------------------------------------------------------- the copies

def test_knob_space_is_the_references():
    assert autotune.TUNED_KNOBS == REF_TUNED_KNOBS
    assert set(autotune._knob_domains()) == set(tcfg.TUNABLE_DEFAULTS)


def test_budgets_are_the_references():
    ref = {e.name: {"pad_frac_ceiling": e.pad_frac_ceiling,
                    "intensity_floor": e.intensity_floor} for e in REF_ENTRY_POINTS}
    assert autotune._entry_budgets() == {name: ref[name] for name in autotune.ENTRY_BUDGETS}
    # the entries static_violations reads
    assert set(autotune.ENTRY_BUDGETS) == {
        "pagerank_sharded_hybrid", "pagerank_sharded_owned",
        "pagerank_step_sort_shuffle", "tfidf_chunk_ingest_carry",
        "tfidf_score_query_batch", "tfidf_score_impacted_batch"}


def test_groups_and_anchors_are_the_references(ref):
    assert autotune.GROUPS == ref.GROUPS
    assert autotune.MESH_DEVICES == ref.MESH_DEVICES
    assert (autotune.SHUFFLE_BASE_INTENSITY, autotune.SHUFFLE_BASE_WIDTH) == \
        (ref.SHUFFLE_BASE_INTENSITY, ref.SHUFFLE_BASE_WIDTH)


# --------------------------------------------------------------- the grid

def test_grid_covers_declared_space():
    domains = autotune._knob_domains()
    grid = autotune.enumerate_grid(domains)
    grouped = [k for _, knobs in autotune.GROUPS for k in knobs]
    assert sorted(grouped) == sorted(domains), "a knob is grouped twice"
    for group, knobs in autotune.GROUPS:
        expect = 1
        for k in knobs:
            expect *= len(domains[k])
        assert len(grid[group]) == expect
        assert all(set(p) == set(knobs) for p in grid[group])


def test_grid_equals_the_references(ref):
    assert autotune.enumerate_grid(autotune._knob_domains()) == \
        ref.enumerate_grid(ref._knob_domains())


@pytest.mark.parametrize("change", ["extra", "missing"])
def test_grid_drift_guard(change):
    domains = autotune._knob_domains()
    if change == "extra":
        domains["bogus_knob"] = (1, 2)
    else:
        domains.pop("prefetch")
    with pytest.raises(ValueError, match="drift"):
        autotune.enumerate_grid(domains)


# ---------------------------------------------------------- pad helpers

def test_static_pad_helpers_are_exact():
    assert autotune.pack_counts([10, 10, 15], target=20, chunk_docs=8) == [20, 15]
    assert autotune.pack_counts([5, 5, 5], target=0, chunk_docs=2) == [10, 5]
    assert autotune.shuffle_padded_slots([1, 2, 3, 4, 5], width=4) == 24
    pad = autotune.impacted_static_pad([[20] * 16], width=8, min_bits=6)
    assert pad == pytest.approx(1 - 320 / 512)


@settings(max_examples=60, deadline=None)
@given(tokens=st.lists(st.integers(1, 500), max_size=40), target=st.integers(0, 1200),
       chunk_docs=st.integers(1, 9), width=st.sampled_from([2, 4, 8, 16]),
       runs=st.lists(st.lists(st.integers(0, 90), min_size=1, max_size=8), min_size=1,
                     max_size=6))
def test_pad_helpers_equal_the_references(ref, tokens, target, chunk_docs, width, runs):
    assert autotune.pack_counts(tokens, target, chunk_docs) == \
        ref.pack_counts(tokens, target, chunk_docs)
    assert autotune.shuffle_padded_slots(tokens, width) == ref.shuffle_padded_slots(tokens, width)
    assert autotune.impacted_static_pad(runs, width) == ref.impacted_static_pad(runs, width)


def test_probes_are_the_references(ref, probes):
    want = ref.build_probes()
    for key in ("doc_tokens", "chunk_docs", "batch_sizes", "run_lengths"):
        assert probes[key] == want[key], key
    g, wg = probes["graph"], want["graph"]
    assert (g.n_nodes, g.n_edges) == (wg.n_nodes, wg.n_edges)
    assert (g.src == wg.src).all() and (g.dst == wg.dst).all()


# ---------------------------------------------------------------- the prune

def test_prune_equals_the_references(plan, ref_plan, ref, probes):
    """87 raw points, 45 pruned; per group the reference's survivors and
    pruned points with their violations.  hybrid and owned are costed by
    the sharded planner in both packages, point for point, and at budgets
    tight enough to prune them the two prunes still agree."""
    assert (plan["raw_points"], plan["pruned_points"], plan["survivor_points"]) == (87, 45, 42)
    counts = {g: (len(v["survivors"]), len(v["pruned"])) for g, v in plan["groups"].items()}
    assert counts == {"hybrid": (9, 0), "owned": (3, 0), "shuffle": (3, 0),
                      "ingest": (9, 36), "serve": (18, 9)}
    assert plan == ref_plan
    ref_probes = ref.build_probes()
    for ceiling in (0.0, 0.05, 0.2):
        budgets = autotune._entry_budgets()
        for entry in ("pagerank_sharded_hybrid", "pagerank_sharded_owned"):
            budgets[entry]["pad_frac_ceiling"] = ceiling
        grid = {g: autotune.enumerate_grid(autotune._knob_domains())[g]
                for g in ("hybrid", "owned")}
        got = autotune.prune(grid, probes, budgets)
        assert got == ref.prune(grid, ref_probes, budgets), ceiling


def test_pruned_points_actually_violate(plan, probes):
    budgets = autotune._entry_budgets()
    assert plan["prune_frac"] >= 0.30
    for group, gp in plan["groups"].items():
        assert gp["survivors"], f"group {group!r} pruned to zero survivors"
        for entry in gp["pruned"]:
            assert entry["violations"], entry
            for v in entry["violations"]:
                budget = budgets[v["entry"]]
                if v["metric"] == "pad_frac":
                    assert v["value"] > budget["pad_frac_ceiling"] == v["budget"], v
                else:
                    assert v["metric"] == "intensity"
                    assert v["value"] < budget["intensity_floor"] == v["budget"], v
        for point in gp["survivors"]:
            assert autotune.static_violations(group, point, probes, budgets) == []


def test_prune_synthetic_budgets_both_extremes(probes):
    """No budgets prune nothing; impossible budgets prune every point of
    every group."""
    grid = autotune.enumerate_grid(autotune._knob_domains())
    none = {n: {"pad_frac_ceiling": None, "intensity_floor": None}
            for n in autotune.ENTRY_BUDGETS}
    p = autotune.prune(grid, probes, none)
    assert p["pruned_points"] == 0 and p["prune_frac"] == 0.0
    impossible = {n: {"pad_frac_ceiling": -1.0, "intensity_floor": 1e9}
                  for n in autotune.ENTRY_BUDGETS}
    p = autotune.prune(grid, probes, impossible)
    for group, gp in p["groups"].items():
        assert gp["survivors"] == [] and len(gp["pruned"]) == len(grid[group])
        assert all(v["entry"] for e in gp["pruned"] for v in e["violations"])


def test_survivor_order_is_the_references(ref, plan, probes):
    """The measured order: the reference's static rank for every group, the
    sharded planner's pad fraction for hybrid and owned."""
    ref_probes = ref.build_probes()
    for group, gp in plan["groups"].items():
        for point in gp["survivors"]:
            assert autotune._static_rank(group, point, probes) == \
                ref._static_rank(group, point, ref_probes)


def test_measure_signature_is_the_references(ref, plan):
    for group, gp in plan["groups"].items():
        for point in gp["survivors"]:
            assert autotune._measure_signature(group, point) == \
                ref._measure_signature(group, point)


# ---------------------------------------------------------- the sweep

def test_zero_budget_sweep_falls_back_everywhere(plan, probes):
    knobs, evidence = autotune.measure_survivors(plan, probes, 0.0, log=lambda m: None,
                                                 device="cpu")
    assert set(knobs) == set(tcfg.TUNABLE_DEFAULTS)
    assert all(g["fallback"] and g["measured"] == [] and g["winner_secs"] is None
               for g in evidence["groups"].values())
    # an unmeasured group keeps its defaults
    assert knobs == tcfg.TUNABLE_DEFAULTS


def test_sweep_measures_every_group_but_owned(plan, probes):
    """One survivor a group, on the CPU: every group, owned too (on four CPU
    slots), measures its defaults and the survivor (seconds above zero, not
    a fallback); a survivor that won is timed against the defaults in turns
    and kept only if each of its runs beat each of theirs."""
    small = {**plan, "groups": {g: {"survivors": v["survivors"][:1], "pruned": []}
                                for g, v in plan["groups"].items()}}
    logged = []
    knobs, evidence = autotune.measure_survivors(small, probes, 600.0, log=logged.append,
                                                 device="cpu")
    for group, gev in evidence["groups"].items():
        default = {k: tcfg.TUNABLE_DEFAULTS[k] for k in dict(autotune.GROUPS)[group]}
        survivor = small["groups"][group]["survivors"][0]
        assert not gev["fallback"] and gev["winner_secs"] > 0, (group, gev)
        assert [m["point"] for m in gev["measured"]] == [default, survivor]
        assert gev["measured"][0]["default"] and all("error" not in m for m in gev["measured"])
        confirm = gev.get("confirm")
        if gev["winner"] == survivor:
            assert confirm["kept"] == "winner" and max(confirm["winner"]) < min(confirm["default"])
        else:
            assert gev["winner"] == default
            assert confirm is None or confirm["kept"] == "default"
        assert {k: knobs[k] for k in default} == gev["winner"]
    assert len(logged) >= 8
    assert set(knobs) == set(tcfg.TUNABLE_DEFAULTS)


@pytest.mark.parametrize("case", ["beaten", "within_spread", "narrow_margin", "budget"])
def test_defaults_kept_unless_beaten_beyond_spread(case, plan, probes, monkeypatch):
    """Scripted times: the fastest survivor replaces the defaults only when
    every one of its CONFIRM_ORDER runs beats every run of the defaults.
    The defaults are measured first even where the static prune drops them
    (ingest's pack_target_tokens=0 on the probe), and a confirm the budget
    cuts short keeps them."""
    ingest = plan["groups"]["ingest"]
    default = {k: tcfg.TUNABLE_DEFAULTS[k] for k in dict(autotune.GROUPS)["ingest"]}
    assert default not in ingest["survivors"]
    assert default in [e["point"] for e in ingest["pruned"]]
    winner = ingest["survivors"][-1]
    seen = []
    # first pass: the defaults 1.0, the winner 0.5, the rest 0.9; then the
    # turns, in which one late run of the defaults (within_spread) is faster
    # than a run of the winner
    d, w = (0.9, 0.8) if case == "narrow_margin" else (1.0, 0.6)
    turns = [d if side == "D" else w for side in autotune.CONFIRM_ORDER]
    if case == "within_spread":
        turns[autotune.CONFIRM_ORDER.rindex("D")] = 0.55
    if case == "budget":
        turns = turns[:1]

    def fake(point, docs, device):
        seen.append(point)
        n = len(seen) - 2 - len(ingest["survivors"])
        if n >= 0:
            return turns[n]
        return 1.0 if point == default else 0.5 if point == winner else 0.9

    clock = iter(range(10_000))
    if case == "budget":  # the deadline falls after the first turn
        stop = len(ingest["survivors"]) + 2
        monkeypatch.setattr(autotune.time, "monotonic",
                            lambda: 0.0 if len(seen) < stop else 1e9 + next(clock))
    monkeypatch.setattr(autotune, "_bench_corpus", lambda n_docs: [])
    monkeypatch.setattr(autotune, "_measure_ingest", fake)
    only = {**plan, "groups": {g: (v if g == "ingest" else {"survivors": [], "pruned": []})
                               for g, v in plan["groups"].items()}}
    knobs, evidence = autotune.measure_survivors(only, probes, 1e6, log=lambda m: None,
                                                 device="cpu")
    gev = evidence["groups"]["ingest"]
    assert seen[0] == default and gev["measured"][0] == {"point": default, "secs": 1.0,
                                                        "default": True}
    assert len(gev["measured"]) == 1 + len(ingest["survivors"])
    assert seen[1 + len(ingest["survivors"]):] == [
        winner if side == "W" else default for side in autotune.CONFIRM_ORDER][:len(turns)]
    kept = case in ("beaten", "narrow_margin")
    assert gev["confirm"]["kept"] == ("winner" if kept else "default")
    assert gev["winner"] == (winner if kept else default)
    assert gev["winner_secs"] == (0.5 if kept else 1.0)
    assert {k: knobs[k] for k in default} == gev["winner"]


# ------------------------------------------------------------------ main

def test_dry_run_prints_the_references_plan(ref, capsys):
    assert autotune.main(["--dry-run", "--json"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref.main(["--dry-run", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert port == want and port["backend"] == "cpu" and port["dry_run"]


def test_main_writes_a_cpu_profile_that_loads(tmp_path, capsys):
    out = tmp_path / "tuned_profile_cpu.json"
    assert autotune.main(["--device", "cpu", "--out", str(out), "--budget-s", "0",
                          "--json"]) == 0
    printed = json.loads(capsys.readouterr().out)
    prof = tcfg.load_tuned_profile(backend="cpu", path=out)
    assert printed["path"] == str(out) and printed["record"]["knobs"] == prof.knobs
    assert set(prof.knobs) == set(tcfg.TUNABLE_DEFAULTS)
    assert prof.measured["device"] == "cpu" and prof.measured["power_limit"] is None
    assert prof.measured["prune"] == {"raw_points": 87, "pruned_points": 45,
                                      "prune_frac": round(45 / 87, 4)}
    assert printed["plan"]["raw_points"] == 87


def test_budget_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFT_TUNE_BUDGET_S", "0")
    out = tmp_path / "p.json"
    assert autotune.main(["--device", "cpu", "--out", str(out)]) == 0
    prof = tcfg.load_tuned_profile(backend="cpu", path=out)
    assert prof.measured["budget_s"] == 0.0
    assert all(g["fallback"] for g in prof.measured["groups"].values())


def test_gpu_profile_is_not_overwritten_without_force(tmp_path):
    out = tmp_path / "tuned_profile_gpu.json"
    tcfg.write_tuned_profile(out, "gpu", {"prefetch": 4})
    before = out.read_text()
    assert autotune.main(["--device", "cpu", "--out", str(out), "--budget-s", "0"]) == 2
    assert out.read_text() == before
    assert autotune.main(["--device", "cpu", "--out", str(out), "--budget-s", "0",
                          "--force"]) == 0
    assert tcfg.load_tuned_profile(backend="cpu", path=out).backend == "cpu"


def test_backend_must_be_the_devices(tmp_path):
    """A CPU sweep may not stamp itself gpu; under --dry-run the flag only
    names the plan's backend."""
    out = tmp_path / "p.json"
    assert autotune.main(["--device", "cpu", "--backend", "gpu", "--out", str(out),
                          "--budget-s", "0"]) == 2
    assert not out.exists()
    assert autotune.main(["--device", "cpu", "--backend", "cpu", "--out", str(out),
                          "--budget-s", "0"]) == 0


def test_committed_gpu_profile_obeys_the_rule():
    """The committed card profile came from this tuner: every measured group
    timed its defaults first and left them only for a winner each of whose
    CONFIRM_ORDER runs beat each of theirs; a group left unmeasured kept its
    default."""
    prof = tcfg.load_tuned_profile(backend="gpu")
    assert prof is not None and prof.source == "committed"
    for group, gev in prof.measured["groups"].items():
        default = {k: tcfg.TUNABLE_DEFAULTS[k] for k in dict(autotune.GROUPS)[group]}
        assert {k: prof.knobs[k] for k in default} == gev["winner"], group
        if gev["fallback"]:
            assert gev["winner"] == default
            continue
        assert gev["measured"][0]["point"] == default and gev["measured"][0]["default"]
        if gev["winner"] != default:
            confirm = gev["confirm"]
            assert confirm["kept"] == "winner", group
            assert len(confirm["winner"]) + len(confirm["default"]) == \
                len(autotune.CONFIRM_ORDER)
            assert max(confirm["winner"]) < min(confirm["default"]), group
