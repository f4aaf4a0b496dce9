"""What the benchmark may load: no JAX and no JAX package anywhere, and
nothing of the program in its yardstick.  Module names are compared by
their top-level part (before the first dot) as a whole, since the
program's package name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.run import FORBIDDEN

REPO = Path(__file__).resolve().parents[2]

PORT = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
SOURCES = sorted(p for p in (REPO / "portbench").rglob("*.py") if "__pycache__" not in p.parts)
# the yardstick: works from the benchmark's inputs alone
YARDSTICK = ("reference.py", "checks.py", "control.py", "graphgen.py", "roofline.py")


def top_level_imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_the_forbidden_names_are_whole_top_level_names():
    assert "jax" in FORBIDDEN and "page_rank_and_tfidf_using_apache_spark_tpu" in FORBIDDEN
    assert PORT not in FORBIDDEN and PORT.startswith("page_rank_and_tfidf_using_apache_spark_tpu")


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    tops = top_level_imports(REPO / "portbench" / name)
    assert PORT not in tops
    assert tops <= {"__future__", "typing", "math", "json", "numpy", "torch", "portbench"}


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        f"res = run.run_cell(Path({str(tiny_root)!r}), 'lj-pagerank-20it', 4, 0.2, True, device='cpu')\n"
        "print(json.dumps({'correct': res['correct'], 'found': run.forbidden_modules(),\n"
        "                  'port': 'page_rank_and_tfidf_using_apache_spark_tpu_torch' in sys.modules}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "found": [], "port": True}
