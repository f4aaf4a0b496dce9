"""Fixtures of the benchmark's own tests (run them with
``python -m pytest portbench/tests -q`` from the repository root).

``chip`` marks a test that needs a CUDA card; it skips here, deciding in a
fixture, never while a module is imported.  ``tiny_root`` is a checkout of
the benchmark whose configurations keep their shape at a size the CPU
runs in a second.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# configuration -> (nodes, edges) at the tests' size; degree caps scale with them
TINY = {"snap-web-google": (3000, 17500), "snap-soc-livejournal1": (4000, 57000)}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_tiny_root(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/``'s files under
    ``dest``, every configuration cut to :data:`TINY`'s counts."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, (n, e) in TINY.items():
        path = dest / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        g = cfg["graph"]
        scale = n / g["nodes"]
        g.update(nodes=n, edges=e, max_out_degree=max(4.0, g["max_out_degree"] * scale * 10),
                 max_in_degree=max(4.0, g["max_in_degree"] * scale * 10))
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
