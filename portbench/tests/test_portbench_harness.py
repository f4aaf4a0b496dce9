"""One run of each cell, driven on the CPU at a small size with the card's
look skipped: the result line's keys, the metrics found by name, the
control and the program's faults coming out not correct, and a new cell,
configuration, traffic mix and metric found from new files alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, devtrace, faults, layers, roofline, run, spec

REPO = Path(__file__).resolve().parents[2]

CELLS = ("lj-pagerank-20it", "wg-ppr-b8", "lj-ppr-b8")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def names_for(root: Path, cell: str, kind: str) -> set[str]:
    b = bench(root)
    e2e = {m["name"] for m in b["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    if kind == "end_to_end":
        return e2e
    return {m["name"] for m in b["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_the_cells_end_to_end_metrics(tiny_root, cell):
    res = run.run_cell(tiny_root, cell, 2 ** 31 + 7, 0.3, False, device="cpu")
    assert list(res) == KEYS, "checks come last"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == names_for(tiny_root, cell, "end_to_end")
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for row in res["checks"].values():
        assert row["value"] <= row["limit"]
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics_and_breakdown(tiny_root, cell):
    res = run.run_cell(tiny_root, cell, 11, 0.3, True, device="cpu")
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"] is True
    # the CPU runs no kernel: the roofline reads nothing and stays out
    want = {n for n in names_for(tiny_root, cell, "per_layer") if "roofline" not in n}
    assert set(res["metrics"]) == want
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    for key in ("device_ops", "idle_gaps"):
        assert len(res["breakdown"][key]) <= 10
    assert res["breakdown"]["idle_gaps"], "the CPU's window is all idle on the device"


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(tiny_root, cell):
    res = run.run_cell(tiny_root, cell, 3, 0.3, False, device="cpu", control=control.make)
    assert res["correct"] is False
    assert any(row["value"] > row["limit"] for row in res["checks"].values())


ENTRY = {cell: spec.load(REPO, cell).traffic["entry"] for cell in CELLS}
FAULTS = [(cell, name) for cell in CELLS for name in faults.FAULTS
          if faults.applies(name, ENTRY[cell])]


@pytest.mark.parametrize("cell,name", FAULTS, ids=[f"{c}-{n}" for c, n in FAULTS])
def test_a_broken_step_is_not_correct(tiny_root, cell, name):
    with faults.planted(name, ENTRY[cell]):
        res = run.run_cell(tiny_root, cell, 5, 0.3, False, device="cpu")
    assert res["correct"] is False, res["checks"]
    res = run.run_cell(tiny_root, cell, 5, 0.3, False, device="cpu")
    assert res["correct"] is True, "the fault is lifted once its block ends"


def test_ppr_sources_are_uniform_over_all_nodes_and_follow_the_seed():
    entry = spec.entry(REPO, "ppr_batch")
    calls = entry.Calls(2 ** 31 + 11, {"batch": 64}, 8)
    drawn = [q for _ in range(20) for q in calls.next()]
    assert {q[0] for q in drawn} == set(range(8)) and all(len(q) == 1 for q in drawn)
    assert entry.Calls(2 ** 31 + 11, {"batch": 64}, 8).next() == drawn[:64]
    assert entry.Calls(2 ** 31 + 12, {"batch": 64}, 8).next() != drawn[:64]


def test_new_cell_config_traffic_and_metric_are_found_from_files_alone(tiny_root):
    b = bench(tiny_root)
    cfg = json.loads((tiny_root / "portbench/configs/snap-web-google.json").read_text())
    cfg["name"] = "tiny-web"
    cfg["graph"].update(nodes=1500, edges=9000)
    (tiny_root / "portbench/configs/tiny-web.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny_root / "portbench/traffic/ppr-b8.json").read_text())
    traffic["batch"] = 2
    (tiny_root / "portbench/traffic/ppr-b2.json").write_text(json.dumps(traffic))
    (tiny_root / "portbench/limits/tiny-ppr-b2.json").write_text(
        (tiny_root / "portbench/limits/lj-ppr-b8.json").read_text())
    (tiny_root / "portbench/metrics/calls_in_window.ppr.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    b["configs"].append({"name": "tiny-web", "source": "https://example.org/tiny",
                         "file": "portbench/configs/tiny-web.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-ppr-b2", "config": "tiny-web", "traffic": "ppr-b2",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"].startswith("ppr_"):
            m["workloads"].append("tiny-ppr-b2")
    b["per_layer"].append({"name": "calls_in_window.ppr", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "harness", "moves": "ppr_queries_per_s",
                           "workloads": ["tiny-ppr-b2"]})
    # a metric split by what it moves, with no file of its own: read by its quantity's reader
    b["per_layer"].append({"name": "loop_ms.tiny", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "segment loop",
                           "moves": "ppr_call_p95_ms", "workloads": ["tiny-ppr-b2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    res = run.run_cell(tiny_root, "tiny-ppr-b2", 9, 0.3, True, device="cpu")
    assert res["correct"] is True
    assert res["metrics"]["calls_in_window.ppr"]["value"] == res["attempted"]
    assert res["metrics"]["loop_ms.tiny"]["value"] > 0
    res = run.run_cell(tiny_root, "tiny-ppr-b2", 9, 0.3, False, device="cpu")
    assert set(res["metrics"]) == {"ppr_queries_per_s", "ppr_call_p95_ms", "setup_s"}


def _cli(cwd: Path, *extra: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "wg-ppr-b8",
                           "--seed", "1", "--seconds", "1", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_calibrate_reads_the_program_under_the_control(tiny_root):
    # the tiny checkout holds the benchmark's files; the program comes from the repository
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", "wg-ppr-b8",
                           "--seeds", "1,2", "--control-seeds", "3", "--fault-seeds", "4",
                           "--seconds", "0.2",
                           "--device", "cpu"], cwd=tiny_root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])["summary"]
    for name in ("rank_l1", "rank_max_rel"):
        assert summary[name]["upper"] > 100 * summary[name]["lower"] > 0
    for fault in faults.FAULTS:
        assert max(summary[n][fault] / summary[n]["lower"] for n in ("rank_l1", "rank_max_rel")) > 100


def test_without_a_card_the_command_fails_and_prints_no_result(tiny_root):
    proc = _cli(tiny_root)
    assert proc.returncode == 2
    assert '"correct"' not in proc.stdout


def test_with_only_the_benchmarks_files_the_command_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_trace_summary_busy_gaps_and_labels():
    E = devtrace.Event
    evs = [E("user_annotation", devtrace.WINDOW, 0, 1000, 1),
           E("user_annotation", "portbench.call", 0, 1000, 1),
           E("user_annotation", "pagerank.segment", 500, 900, 1),
           E("cpu_op", "aten::copy_", 100, 300, 1),
           E("kernel", "k", 300, 400, 7), E("kernel", "k", 350, 450, 7),
           E("gpu_memcpy", "Memcpy HtoD", 600, 700, 7), E("kernel", "late", 990, 1200, 7)]
    s = devtrace.summarize(evs)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx((150 + 100 + 10) * 1e-9)
    assert s.device_ops["k"][0] == 2 and s.device_ops["late"][1] == pytest.approx(10e-9)
    assert s.idle_by_host == pytest.approx({"portbench.call > aten::copy_": 300e-9,
                                            "pagerank.segment": (150 + 290) * 1e-9})
    ctx = layers.Context([], 1.0, 1.0, 1, 1, {}, s)
    assert layers.device_idle(ctx) == pytest.approx(100 * (1 - 260 / 1000))


def test_the_profilers_trace_is_read_with_its_host_ranges_and_ops():
    with devtrace.profiled(True) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            with torch.profiler.record_function("inner"):
                torch.ones(4096).mul_(3).sum()
    evs = devtrace.events(prof)
    kinds = {(e.kind, e.name) for e in evs}
    assert {("user_annotation", devtrace.WINDOW), ("user_annotation", "inner"),
            ("cpu_op", "aten::mul_")} <= kinds
    window = next(e for e in evs if e.name == devtrace.WINDOW)
    inner = next(e for e in evs if e.name == "inner")
    assert window.start <= inner.start < inner.end <= window.end
    assert devtrace.summarize(evs).window_s == pytest.approx((window.end - window.start) * 1e-9)


def test_nearest_rank_p95_and_rate():
    calls = [layers.Call(latency_s=i / 1000, iterations=20, queries=1, records=[])
             for i in range(1, 101)]
    ctx = layers.Context(calls, 10.0, 1.0, 1, 1, {}, None)
    assert layers.p95_ms(ctx) == pytest.approx(95.0)
    assert layers.rate(ctx, "iterations") == pytest.approx(200.0)
    assert layers.rate(ctx, "queries") == pytest.approx(10.0)


def test_segment_bytes_count_each_input_once():
    # the web-Google stand-in's main path: 24.7 MB, as the kernel table counts it
    assert roofline.segment_gather_bytes(872_513, 3_563_796) == pytest.approx(24.73e6, rel=1e-3)
