"""``BENCHMARK.json`` and the files it names, each found by its name.

Under the checkout's root:

- a configuration is the file its ``configs`` entry names;
- a traffic mix is ``portbench/traffic/<traffic>.json``;
- a cell's limits are ``portbench/limits/<workload>.json``;
- a metric's reader is ``portbench/metrics/<name>.py``, with a function
  ``read(ctx)`` that returns the metric's value, or None where the run
  gives it nothing to read; where that file is missing, the reader of the
  name's part before the first dot, so ``loop_ms.pr`` and ``loop_ms.ppr``,
  one quantity split by the end-to-end metric it moves, share
  ``loop_ms.py``;
- an entry of the program is ``portbench/entries/<entry>.py``, the
  traffic's ``entry``.

So a cell, a configuration, a traffic mix or a metric is added with new
files and new ``BENCHMARK.json`` entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

DATA = "portbench"


class Cell(NamedTuple):
    chips: int
    config: dict
    traffic: dict
    limits: dict | None  # None where the cell has no limits file
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files
    read."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    limits_path = root / DATA / "limits" / f"{workload}.json"
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    # a per-layer entry with no ``workloads`` is reported wherever its ``moves`` is
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        chips=int(w["chips"]),
        config=_json(root / cfg["file"]),
        traffic=_json(root / DATA / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.is_file() else None,
        end_to_end=e2e, per_layer=per_layer,
    )


def reader(root: Path, metric: str):
    """The ``read(ctx)`` of the metric ``metric``."""
    name = metric
    if not (root / DATA / "metrics" / f"{name}.py").is_file():
        name = metric.split(".")[0]
    return _module(root / DATA / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def entry(root: Path, name: str) -> ModuleType:
    """The entry module ``name`` of the program."""
    return _module(root / DATA / "entries" / f"{name}.py", f"portbench_entry_{name}")
