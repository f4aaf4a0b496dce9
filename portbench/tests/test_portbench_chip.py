"""The command on the card: one short run of a cell, untraced and traced.
Needs a CUDA card (``-m chip`` selects it); skips without one."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]



@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run_on_the_card(card, trace):
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "wg-ppr-b8",
                           "--seed", "2147483701", "--seconds", "2", "--trace", str(trace)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["segment_roofline.ppr"]["value"] <= 100
