"""The port's lexical lint (tier 1, ``..._torch/analysis``) against the
JAX package's ``analysis``, on the CPU.

Mirrors ``tests/test_graftlint.py``:

1. **Fixture parity** — every fixture source of the reference's tier-1
   tests goes through both analyzers, the reference's unchanged and the
   port's on its PyTorch translation (a step handed to
   ``dataflow/fixpoint.iterate`` where the reference has a jit or a
   ``lax`` body; ``torch`` calls where it has ``jnp``/``jax``), placed at
   the snippet root and under ``models/``.  Both must give the same rule
   ids at the same lines.  The per-rule true positive / negative /
   suppressed cases then run on the port alone, and each of the thirteen
   rules has a true positive that makes the CLI exit 1.
2. **The engine** — fingerprints, the ratchet, suppressions, the baseline
   writer: the copies of ``findings.py`` and ``engine.py`` are held to the
   reference's code.
3. **The gate** — the port's surface (the package and ``chip_smoke.py``)
   is clean under the empty baseline, through the CLI and through
   ``tools/lint.sh``; the trace-based tiers are refused with exit 2.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.analysis.engine import lint_file as ref_lint_file
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
    RULES,
    apply_ratchet,
    baseline_path,
    default_targets,
    load_baseline,
    repo_root,
    run_lint,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import engine
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import rules as port_rules
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import lint_file

REPO = repo_root()
PORT = REPO / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF = REPO / "page_rank_and_tfidf_using_apache_spark_tpu"
REF_TESTS = Path(__file__).resolve().parent / "test_graftlint.py"
PKG_RE = re.compile(r"\bpage_rank_and_tfidf_using_apache_spark_tpu\b")


def reference_fixtures(path: Path) -> dict[str, str]:
    """Every fixture source of a reference test file: its module-level
    string constants, and the multi-line ``code = \"\"\"...\"\"\"`` of a test
    function (keyed ``fn:<test name>``)."""
    tree = ast.parse(path.read_text())
    out: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.isupper() and \
                isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
        elif isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Constant) and \
                        isinstance(sub.value.value, str) and "\n" in sub.value.value and \
                        any(isinstance(t, ast.Name) and t.id == "code" for t in sub.targets):
                    out[f"fn:{node.name}"] = sub.value.value
    return out


REF_FIXTURES = reference_fixtures(REF_TESTS)

# The PyTorch translations, line for line with the reference's fixtures.
# A fixture not listed here needs no translation beyond the package name
# (threads, env knobs, ladder rungs, the guarded executor's calls).
TORCH = {
    "HOST_SYNC_TP": """
import numpy as np
import torch


def drain(chunks):
    out = []
    for c in chunks:
        y = torch.matmul(c, c)     # device dispatch in the loop...
        out.append(y.cpu())        # ...and a host pull every iteration
    return out
""",
    "HOST_SYNC_TP_JIT": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(x):
    y = x + 1
    return float(y)  # a host read once a step
run = lambda c: iterate(f, c, iterations=3)
""",
    "HOST_SYNC_TN": """
import numpy as np

def host_only(chunks):
    out = []
    for c in chunks:
        out.append(c.numpy())  # pure host loop, no device work
    return out
""",
    "HOST_SYNC_SUPPRESSED": """
import numpy as np
import torch


def drain(chunks):
    out = []
    for c in chunks:
        y = torch.matmul(c, c)
        out.append(y.cpu())  # graftlint: disable=host-sync-in-loop (single batched drain)
    return out
""",
    "TRACER_BRANCH_TP": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(x):
    if x > 0:          # Python branch on a tensor
        return x
    return -x
run = lambda c: iterate(f, c, iterations=3)
""",
    "TRACER_BRANCH_TN": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


# flag is a host constant the step's default binds
def g(x, flag=True):
    if flag:             # host constant: decided on the host
        return x * 2
    if x.shape[0] == 0:  # shapes live on the host
        return x
    return x
run = lambda c: iterate(g, c, iterations=3)
""",
    "TRACER_BRANCH_SUPPRESSED": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(x):
    if x > 0:  # graftlint: disable=tracer-branch
        return x
    return -x
run = lambda c: iterate(f, c, iterations=3)
""",
    "fn:test_tracer_branch_in_scan_body": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dflow


def outer(xs):
    def body(carry):
        while carry > 0:   # a host read every step inside the step
            carry = carry - 1
        return carry
    return dflow.iterate(body, xs, iterations=3)
""",
    "DTYPE_TP": """
import numpy as np
import torch

def build(n):
    a = torch.zeros(n)                 # float default dtype
    b = torch.as_tensor(np.ones(n))    # numpy float64 default flows to torch
    c = torch.tensor(0.5)              # a float literal, default dtype
    return a, b, c
""",
    "DTYPE_TN": """
import numpy as np
import torch

def build(n):
    a = torch.zeros(n, dtype=torch.float32)
    b = torch.as_tensor(np.ones(n, np.float32))
    c = torch.full((n,), 0.5, dtype=torch.float32)
    d = np.zeros(n)  # host-only numpy never reaches the device here
    return a, b, c, d
""",
    "DTYPE_SUPPRESSED": """
import torch

def build(n):
    return torch.zeros(n)  # graftlint: disable=dtype-drift
""",
    "SHAPE_TP": """
import torch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(x):
    pos = x[x > 0]          # boolean mask: data-dependent shape
    idx = torch.nonzero(x)  # ditto
    return pos.sum() + idx.sum()
run = lambda c: iterate(f, c, iterations=3)
""",
    "SHAPE_TN": """
import torch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(x):
    pos = torch.where(x > 0, x, 0.0)          # fixed-shape masking
    idx = torch.topk(x, 8).indices            # a fixed-size selection
    return pos + idx.sum()

def host_filter(a):
    return a[a > 0]  # outside a step: plain filtering is fine
run = lambda c: iterate(f, c, iterations=3)
""",
    "SHAPE_SUPPRESSED": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(x):
    return x[x > 0]  # graftlint: disable=nonstatic-shape
run = lambda c: iterate(f, c, iterations=3)
""",
    "fn:test_nonstatic_shape_traced_slice_bound": """
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def f(carry):
    x, k = carry[0], carry[1] + 1
    return x[:k]   # slice bound is a tensor -> the host reads it
run = lambda c: iterate(f, c, iterations=3)
""",
    "DCE_TP_REGION": """
import time
import torch

def bench(x):
    t0 = time.perf_counter()
    torch.matmul(x, x)   # result discarded, nothing fenced: times the launch only
    return time.perf_counter() - t0
""",
    "DCE_TP_PARTIAL": """
import torch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate


def measure(reps, x0):

    def f(x):
        def body(acc):
            out = torch.sin(acc)
            return acc + out.ravel()[0]   # only element 0 is live
        return iterate(body, x, iterations=reps)
    return f(x0)
""",
    "DCE_TN": """
import time
import torch


def bench(x):
    t0 = time.perf_counter()
    y = torch.matmul(x, x)
    torch.cuda.synchronize()   # fenced: the work is measured
    secs = time.perf_counter() - t0
    return secs, y
""",
    "DCE_SUPPRESSED": """
import time
import torch

def bench(x):
    t0 = time.perf_counter()
    torch.matmul(x, x)  # graftlint: disable=dce-timed-region
    return time.perf_counter() - t0
""",
    "UNGUARDED_SYNC_TP": """
import numpy as np
import torch


def drain(counts):
    torch.cuda.synchronize()               # raw fence
    host = counts.cpu()                    # raw pull
    y = torch.matmul(host, host)
    arr = np.asarray(y)                    # hidden sync: y is device-bound
    return host, arr
""",
    "UNGUARDED_SYNC_SUPPRESSED": """
import torch

def drain(counts):
    return counts.cpu()  # graftlint: disable=unguarded-host-sync (bootstrap path, no executor yet)
""",
    "SYNC_PUT_LOOP_TP": """
import torch

def ingest(chunks, esh):
    out = []
    for chunk in chunks:
        out.append(torch.as_tensor(chunk, device=esh))  # raw per-chunk H2D
    return out
""",
    "SYNC_PUT_LOOP_TN": """
import torch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ingest import staged_put

def ingest(chunks, esh, metrics):
    out = []
    for chunk in chunks:
        out.append(staged_put(lambda: torch.as_tensor(chunk, device=esh),
                              metrics=metrics))  # the staging API
    graph = torch.as_tensor(chunks[0], device=esh)  # one-time put outside any loop
    return out, graph
""",
    "SYNC_PUT_LOOP_SUPPRESSED": """
import torch

def ingest(chunks):
    for chunk in chunks:
        torch.as_tensor(chunk, device="cuda")  # graftlint: disable=sync-put-in-ingest-loop (rare recovery path, one put per shrink)
""",
}

# test_env_knob_reads_local_declaration builds its own tree (ported below)
PARITY_KEYS = sorted(k for k in REF_FIXTURES if k != "fn:test_env_knob_reads_local_declaration")


def torch_source(key: str) -> str:
    if key in TORCH:
        return TORCH[key]
    return PKG_RE.sub("page_rank_and_tfidf_using_apache_spark_tpu_torch", REF_FIXTURES[key])


def _place(root: Path, where: str, code: str) -> Path:
    d = root / where if where else root
    d.mkdir(parents=True, exist_ok=True)
    f = d / "snippet.py"
    f.write_text(code)
    return f


def lint_snippet(tmp_path: Path, code: str):
    return lint_file(_place(tmp_path, "", code), tmp_path)


def lint_models_snippet(tmp_path: Path, code: str):
    """Under a models/ subtree: the guarded-path rules patrol models/,
    parallel/, io/, serving/ and dataflow/ only."""
    return lint_file(_place(tmp_path, "models", code), tmp_path)


def rules_hit(findings) -> set[str]:
    return {f.rule for f in findings}


# ------------------------------------------------------------ parity


def test_every_reference_fixture_is_covered():
    """The table covers the reference's fixtures and translates nothing
    the reference does not have."""
    assert set(TORCH) <= set(REF_FIXTURES)
    assert len(PARITY_KEYS) >= 40


@pytest.mark.parametrize("where", ["", "models"], ids=["root", "models"])
@pytest.mark.parametrize("key", PARITY_KEYS)
def test_fixture_parity(key, where, tmp_path):
    """The reference's fixture through the reference's analyzer and its
    translation through the port's: the same rule ids at the same lines."""
    ref = ref_lint_file(_place(tmp_path / "ref", where, REF_FIXTURES[key]), tmp_path / "ref")
    port = lint_file(_place(tmp_path / "port", where, torch_source(key)), tmp_path / "port")
    assert {(f.rule, f.line) for f in port} == {(f.rule, f.line) for f in ref}


def test_translations_speak_torch():
    """No translation keeps a JAX spelling, and each keeps the reference's
    line count (so a finding's line means the same statement)."""
    for key, src in TORCH.items():
        assert not re.search(r"\b(jax|jnp|lax)\b", src), key
        assert src.count("\n") >= REF_FIXTURES[key].count("\n"), key


def test_metric_name_parity(tmp_path):
    """metric-name-drift, which the reference tests only over its own
    tree: an undeclared publish in both, a declared one quiet in both."""
    bad = 'from page_rank_and_tfidf_using_apache_spark_tpu{} import obs\n\n' \
          'def publish():\n    obs.counter("no.such.metric")\n'
    ref = ref_lint_file(_place(tmp_path / "ref", "", bad.format("")), tmp_path / "ref")
    port = lint_file(_place(tmp_path / "port", "", bad.format("_torch")), tmp_path / "port")
    assert {(f.rule, f.line) for f in port} == {(f.rule, f.line) for f in ref} \
        == {("metric-name-drift", 4)}
    for side in ("ref2", "port2"):
        reg = tmp_path / side / "analysis" / "registry.py"
        reg.parent.mkdir(parents=True)
        reg.write_text('METRIC_SCHEMAS = (("my.metric", "counter", "count", '
                       '("snippet.py",)),)\n')
        _place(tmp_path / side, "", 'import obs\n\nobs.counter("my.metric")\n')
    port_rules._metric_schema_cache.clear()
    assert not ref_lint_file(tmp_path / "ref2" / "snippet.py", tmp_path / "ref2")
    assert not lint_file(tmp_path / "port2" / "snippet.py", tmp_path / "port2")


# ------------------------------------------------- the port's own cases


def test_host_sync_true_positive(tmp_path):
    assert "host-sync-in-loop" in rules_hit(lint_snippet(tmp_path, TORCH["HOST_SYNC_TP"]))


def test_host_sync_in_step_true_positive(tmp_path):
    findings = lint_snippet(tmp_path, TORCH["HOST_SYNC_TP_JIT"])
    assert "host-sync-in-loop" in rules_hit(findings)


def test_host_sync_true_negative(tmp_path):
    assert "host-sync-in-loop" not in rules_hit(lint_snippet(tmp_path, TORCH["HOST_SYNC_TN"]))


def test_host_sync_suppressed(tmp_path):
    assert "host-sync-in-loop" not in rules_hit(
        lint_snippet(tmp_path, TORCH["HOST_SYNC_SUPPRESSED"]))


@pytest.mark.parametrize("spelling", [
    "y.item()", "y.tolist()", "y.cpu()", "torch.cuda.synchronize()", "float(y)",
    "int(y)", "bool(y)", "np.asarray(y)", "event.synchronize()",
])
def test_host_sync_spellings(spelling, tmp_path):
    """Each torch spelling of a host round trip, in a loop that also
    dispatches, is flagged."""
    code = textwrap.dedent(f"""
        import numpy as np
        import torch

        def drain(chunks, event):
            for c in chunks:
                y = torch.matmul(c, c)
                {spelling}
    """)
    hits = [f for f in lint_snippet(tmp_path, code) if f.rule == "host-sync-in-loop"]
    assert [f.line for f in hits] == [8], spelling


def test_host_sync_through_the_drivers_step(tmp_path):
    """Inside the loop driver's own definition, its step callable is the
    dispatch: a read of a device-bound delta there syncs every step (the
    fixpoint.iterate shape, tol > 0)."""
    code = textwrap.dedent("""
        import torch

        def iterate(step, carry, *, iterations, tol, delta_fn):
            delta = torch.full((), float("inf"), dtype=torch.float32)
            while float(delta) > tol:
                new = step(carry)
                delta = delta_fn(new, carry)
                carry = new
            return carry
    """)
    hits = [f for f in lint_snippet(tmp_path, code) if f.rule == "host-sync-in-loop"]
    assert [f.line for f in hits] == [6]


def test_kernel_wrappers_dispatch(tmp_path):
    """A kernel wrapper's launch counts as device work for the loop rule."""
    code = textwrap.dedent("""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk

        def run(xs):
            for x in xs:
                y = pk.cumsum_kernel(x)
                print(y.item())
    """)
    assert "host-sync-in-loop" in rules_hit(lint_snippet(tmp_path, code))


def test_kernel_wrappers_are_the_launching_functions():
    """KERNEL_WRAPPERS names exactly the functions of ops/*_kernels.py
    that count a launch (``LAUNCHES[...] += 1``)."""
    launching = set()
    for path in sorted((PORT / "ops").glob("*_kernels.py")):
        for fn in ast.parse(path.read_text()).body:
            if isinstance(fn, ast.FunctionDef) and any(
                    isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Subscript)
                    and getattr(n.target.value, "id", None) == "LAUNCHES"
                    for n in ast.walk(fn)):
                launching.add(fn.name)
    assert launching == set(port_rules.KERNEL_WRAPPERS)


def test_step_contexts_of_the_port():
    """Every loop-driver call site of the port hands the driver a step the
    context resolves (the functions the issue's table names)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.context import FileContext

    def steps(rel):
        src = (PORT / rel).read_text()
        return FileContext(rel, src, ast.parse(src)).step_context_funcs

    for rel in ("ops/pagerank.py", "dataflow/hits.py", "dataflow/components.py",
                "dataflow/ppr.py", "parallel/pagerank_sharded.py",
                "parallel/workloads_sharded.py"):
        assert steps(rel), rel
    names = {getattr(f, "name", "<lambda>") for f in steps("ops/pagerank.py")}
    assert "pagerank_step" in names  # a same-file callee of the step lambda


def test_tracer_branch_true_positive(tmp_path):
    assert "tracer-branch" in rules_hit(lint_snippet(tmp_path, TORCH["TRACER_BRANCH_TP"]))


def test_tracer_branch_in_step_body(tmp_path):
    code = TORCH["fn:test_tracer_branch_in_scan_body"]
    assert "tracer-branch" in rules_hit(lint_snippet(tmp_path, code))


def test_tracer_branch_true_negative(tmp_path):
    assert "tracer-branch" not in rules_hit(lint_snippet(tmp_path, TORCH["TRACER_BRANCH_TN"]))


def test_tracer_branch_suppressed(tmp_path):
    assert "tracer-branch" not in rules_hit(
        lint_snippet(tmp_path, TORCH["TRACER_BRANCH_SUPPRESSED"]))


def test_metadata_reads_are_not_tensors(tmp_path):
    """.numel(), .size(), .dim() and .ndim read no device memory."""
    code = textwrap.dedent("""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate

        def f(x):
            if x.numel() == 0 or x.size(0) > 4 or x.dim() == 2 or x.ndim == 1:
                return x
            return x
        run = lambda c: iterate(f, c, iterations=3)
    """)
    assert "tracer-branch" not in rules_hit(lint_snippet(tmp_path, code))


def test_dtype_drift_true_positive(tmp_path):
    findings = [f for f in lint_snippet(tmp_path, TORCH["DTYPE_TP"]) if f.rule == "dtype-drift"]
    assert len(findings) >= 3  # all three drift spellings


def test_dtype_drift_float_arange(tmp_path):
    code = "import torch\na = torch.arange(0.0, 1.0, 0.25)\nb = torch.arange(8)\n"
    assert [f.line for f in lint_snippet(tmp_path, code) if f.rule == "dtype-drift"] == [2]


def test_dtype_drift_true_negative(tmp_path):
    assert "dtype-drift" not in rules_hit(lint_snippet(tmp_path, TORCH["DTYPE_TN"]))


def test_dtype_drift_suppressed(tmp_path):
    assert "dtype-drift" not in rules_hit(lint_snippet(tmp_path, TORCH["DTYPE_SUPPRESSED"]))


def test_nonstatic_shape_true_positive(tmp_path):
    findings = [f for f in lint_snippet(tmp_path, TORCH["SHAPE_TP"])
                if f.rule == "nonstatic-shape"]
    assert len(findings) >= 2  # mask indexing + nonzero


@pytest.mark.parametrize("call, flagged", [
    ("x.unique()", True), ("torch.masked_select(x, x > 0)", True),
    ("x.repeat_interleave(x.long())", True),
    ("x.repeat_interleave(x.long(), output_size=8)", False),
    ("x.repeat_interleave(2)", False), ("torch.where(x > 0)", True),
])
def test_nonstatic_shape_torch_calls(call, flagged, tmp_path):
    code = textwrap.dedent(f"""
        import torch
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate

        def f(x):
            y = {call}
            return x
        run = lambda c: iterate(f, c, iterations=3)
    """)
    assert ("nonstatic-shape" in rules_hit(lint_snippet(tmp_path, code))) is flagged


def test_nonstatic_shape_traced_slice_bound(tmp_path):
    code = TORCH["fn:test_nonstatic_shape_traced_slice_bound"]
    assert "nonstatic-shape" in rules_hit(lint_snippet(tmp_path, code))


def test_nonstatic_shape_true_negative(tmp_path):
    assert "nonstatic-shape" not in rules_hit(lint_snippet(tmp_path, TORCH["SHAPE_TN"]))


def test_nonstatic_shape_suppressed(tmp_path):
    assert "nonstatic-shape" not in rules_hit(
        lint_snippet(tmp_path, TORCH["SHAPE_SUPPRESSED"]))


def test_dce_timed_region_true_positive(tmp_path):
    assert "dce-timed-region" in rules_hit(lint_snippet(tmp_path, TORCH["DCE_TP_REGION"]))


def test_dce_partial_consumption_true_positive(tmp_path):
    assert "dce-timed-region" in rules_hit(lint_snippet(tmp_path, TORCH["DCE_TP_PARTIAL"]))


@pytest.mark.parametrize("fence", [
    "torch.cuda.synchronize()", "done.synchronize()", "y.item()", "float(y.sum())",
    "rx.block_until_ready(y, site='s')",
])
def test_dce_fences(fence, tmp_path):
    """A synchronize, an event's sync, a pulled result or the guarded
    fence before the stop make the region a measurement."""
    code = textwrap.dedent(f"""
        import time
        import torch

        def bench(x, done, rx):
            t0 = time.perf_counter()
            y = torch.matmul(x, x)
            {fence}
            return time.perf_counter() - t0
    """)
    assert "dce-timed-region" not in rules_hit(lint_snippet(tmp_path, code))


def test_dce_timed_region_true_negative(tmp_path):
    assert "dce-timed-region" not in rules_hit(lint_snippet(tmp_path, TORCH["DCE_TN"]))


def test_dce_timed_region_suppressed(tmp_path):
    assert "dce-timed-region" not in rules_hit(lint_snippet(tmp_path, TORCH["DCE_SUPPRESSED"]))


def test_unguarded_sync_true_positive(tmp_path):
    findings = [f for f in lint_models_snippet(tmp_path, TORCH["UNGUARDED_SYNC_TP"])
                if f.rule == "unguarded-host-sync"]
    assert len(findings) >= 3  # fence + pull + device-bound asarray


def test_unguarded_sync_true_negative(tmp_path):
    assert "unguarded-host-sync" not in rules_hit(
        lint_models_snippet(tmp_path, torch_source("UNGUARDED_SYNC_TN")))


def test_unguarded_sync_inside_the_executor_is_guarded(tmp_path):
    """A raw sync inside a guarded call's argument, or inside a same-file
    def handed to one by name, runs under retry and the deadline."""
    code = textwrap.dedent("""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx

        def drain(done, host, metrics):
            def wait_and_read():
                done.synchronize()
                return host.cpu()
            a = rx.run_guarded(wait_and_read, site="s", metrics=metrics)
            b = rx.run_guarded(lambda: host.cpu(), site="s", metrics=metrics)
            return a, b
    """)
    assert "unguarded-host-sync" not in rules_hit(lint_models_snippet(tmp_path, code))


def test_unguarded_sync_ignores_other_directories(tmp_path):
    assert "unguarded-host-sync" not in rules_hit(
        lint_snippet(tmp_path, TORCH["UNGUARDED_SYNC_TP"]))


def test_unguarded_sync_suppressed(tmp_path):
    assert "unguarded-host-sync" not in rules_hit(
        lint_models_snippet(tmp_path, TORCH["UNGUARDED_SYNC_SUPPRESSED"]))


def test_sync_put_in_ingest_loop_true_positive(tmp_path):
    findings = [f for f in lint_models_snippet(tmp_path, TORCH["SYNC_PUT_LOOP_TP"])
                if f.rule == "sync-put-in-ingest-loop"]
    assert len(findings) == 1


@pytest.mark.parametrize("put, flagged", [
    ("torch.from_numpy(a).to(dev)", True), ("torch.from_numpy(a).cuda()", True),
    ("torch.tensor(a, device=dev)", True), ("host_t.to(dev)", True),
    ("x.to(dev)", False), ("x.to(torch.float64)", False),
    ("torch.from_numpy(a).to('cpu')", False), ("torch.as_tensor(a)", False),
])
def test_sync_put_spellings(put, flagged, tmp_path):
    """A host-to-device copy of host data in a loop is flagged; a device
    tensor's copy to another slot (a collective's) and a dtype cast are
    not."""
    code = textwrap.dedent(f"""
        import numpy as np
        import torch

        def ingest(chunks, x, dev):
            host_t = torch.from_numpy(np.zeros(4, np.float32))
            for a in chunks:
                y = {put}
    """)
    hit = "sync-put-in-ingest-loop" in rules_hit(lint_models_snippet(tmp_path, code))
    assert hit is flagged, put


def test_sync_put_in_ingest_loop_true_negative(tmp_path):
    assert "sync-put-in-ingest-loop" not in rules_hit(
        lint_models_snippet(tmp_path, TORCH["SYNC_PUT_LOOP_TN"]))


def test_sync_put_in_ingest_loop_ignores_other_directories(tmp_path):
    assert "sync-put-in-ingest-loop" not in rules_hit(
        lint_snippet(tmp_path, TORCH["SYNC_PUT_LOOP_TP"]))


def test_sync_put_in_ingest_loop_suppressed(tmp_path):
    assert "sync-put-in-ingest-loop" not in rules_hit(
        lint_models_snippet(tmp_path, TORCH["SYNC_PUT_LOOP_SUPPRESSED"]))


def test_untraced_guarded_true_positive(tmp_path):
    findings = [f for f in lint_models_snippet(tmp_path, torch_source("UNTRACED_GUARDED_TP"))
                if f.rule == "untraced-guarded-site"]
    assert len(findings) == 2  # the guarded pull AND the run_guarded call


def test_untraced_guarded_true_negative(tmp_path):
    assert "untraced-guarded-site" not in rules_hit(
        lint_models_snippet(tmp_path, torch_source("UNTRACED_GUARDED_TN")))


def test_thread_state_true_positive(tmp_path):
    assert "unsynced-thread-state" in rules_hit(
        lint_snippet(tmp_path, torch_source("THREAD_STATE_TP")))


def test_thread_state_true_negative(tmp_path):
    assert "unsynced-thread-state" not in rules_hit(
        lint_snippet(tmp_path, torch_source("THREAD_STATE_TN")))


def test_env_knob_true_positive(tmp_path):
    assert "env-knob-drift" in rules_hit(lint_snippet(tmp_path, torch_source("ENV_KNOB_TP")))


def test_env_knob_true_negative(tmp_path):
    assert "env-knob-drift" not in rules_hit(
        lint_snippet(tmp_path, torch_source("ENV_KNOB_TN")))


def test_ladder_rung_true_positive(tmp_path):
    assert "ladder-rung-drift" in rules_hit(lint_snippet(tmp_path, torch_source("LADDER_TP")))


def test_ladder_rung_true_negative(tmp_path):
    assert "ladder-rung-drift" not in rules_hit(
        lint_snippet(tmp_path, torch_source("LADDER_TN")))


def test_ladder_rung_declaration_coverage(tmp_path):
    """The declaration side: a DEGRADE_LADDER rung no resilience/ module
    references is drift, flagged at the declaration."""
    cfg_dir = tmp_path / "utils"
    cfg_dir.mkdir()
    cfg = cfg_dir / "config.py"
    cfg.write_text('DEGRADE_LADDER = ("zeta",)\n')
    res_dir = tmp_path / "resilience"
    res_dir.mkdir()
    (res_dir / "impl.py").write_text('LADDER = "other"\n')
    assert "ladder-rung-drift" in rules_hit(lint_file(cfg, tmp_path))
    (res_dir / "impl.py").write_text('LADDER = "zeta"\n')
    port_rules._ladder_cache.clear()  # per-root cache from the first pass
    assert "ladder-rung-drift" not in rules_hit(lint_file(cfg, tmp_path))


def test_env_knob_reads_local_declaration(tmp_path):
    """A scanned tree's own utils/config.py declaration wins over the
    package fallback."""
    cfg_dir = tmp_path / "utils"
    cfg_dir.mkdir()
    (cfg_dir / "config.py").write_text('GRAFT_ENV_KNOBS = frozenset({"GRAFT_CUSTOM_KNOB"})\n')
    (tmp_path / "a.py").write_text('import os\nV = os.environ.get("GRAFT_CUSTOM_KNOB")\n')
    (tmp_path / "b.py").write_text('import os\nV = os.environ.get("GRAFT_RETRY_MAX")\n')
    findings = run_lint([tmp_path / "a.py", tmp_path / "b.py"], tmp_path)
    assert {f.path for f in findings if f.rule == "env-knob-drift"} == {"b.py"}


# One true positive a rule, for the CLI gate: (where, source).
TRUE_POSITIVES = {
    "host-sync-in-loop": ("", TORCH["HOST_SYNC_TP"]),
    "tracer-branch": ("", TORCH["TRACER_BRANCH_TP"]),
    "dtype-drift": ("", TORCH["DTYPE_TP"]),
    "nonstatic-shape": ("", TORCH["SHAPE_TP"]),
    "dce-timed-region": ("", TORCH["DCE_TP_REGION"]),
    "unguarded-host-sync": ("models", TORCH["UNGUARDED_SYNC_TP"]),
    "untraced-guarded-site": ("models", torch_source("UNTRACED_GUARDED_TP")),
    "unsynced-thread-state": ("", torch_source("THREAD_STATE_TP")),
    "thread-registry-drift": ("", "import threading\n\n"
                              "t = threading.Thread(target=print, name='totally-novel')\n"),
    "env-knob-drift": ("", torch_source("ENV_KNOB_TP")),
    "metric-name-drift": ("", "from page_rank_and_tfidf_using_apache_spark_tpu_torch "
                          "import obs\n\nobs.counter('no.such.metric')\n"),
    "ladder-rung-drift": ("", torch_source("LADDER_TP")),
    "sync-put-in-ingest-loop": ("models", TORCH["SYNC_PUT_LOOP_TP"]),
}


def test_every_rule_has_a_true_positive():
    assert set(TRUE_POSITIVES) == set(RULES)


@pytest.mark.parametrize("rule_id", sorted(TRUE_POSITIVES))
def test_true_positive_fails_the_gate(rule_id, tmp_path):
    """Each rule's true positive, linted through the CLI with the empty
    baseline, exits 1 and names the rule."""
    where, code = TRUE_POSITIVES[rule_id]
    f = _place(tmp_path, where, code)
    proc = subprocess.run(
        [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis",
         str(f), "--tier", "1", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rule_id in {x["rule"] for x in json.loads(proc.stdout)["findings"]}


# ----------------------------------------------------- engine machinery


@pytest.mark.parametrize("module", ["findings", "engine"])
def test_copy_matches_reference(module):
    """The engine and the findings model are the reference's code,
    docstrings aside, but for the scan surface and the skipped build
    directory the engine's docstring names."""
    def code(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
            if isinstance(node, ast.FunctionDef) and node.name == "default_targets":
                node.body = [ast.Pass()]
        return ast.dump(tree).replace("page_rank_and_tfidf_using_apache_spark_tpu_torch",
                                      "page_rank_and_tfidf_using_apache_spark_tpu")

    port, ref = code(PORT / "analysis" / f"{module}.py"), code(REF / "analysis" / f"{module}.py")
    if module == "engine":
        port = port.replace(", Constant(value='_build')", "")
    assert port == ref


def test_scan_surface():
    targets = default_targets(REPO)
    assert targets == [PORT, REPO / "chip_smoke.py"]
    files = {p.relative_to(REPO).as_posix() for p in engine.iter_python_files(targets)}
    assert "chip_smoke.py" in files
    assert "page_rank_and_tfidf_using_apache_spark_tpu_torch/tools/protocol_harness.py" in files
    assert not any("/_build/" in f or f.startswith("tools/") for f in files)


def test_fingerprints_stable_under_line_shift(tmp_path):
    a = lint_snippet(tmp_path, TORCH["HOST_SYNC_TP"])
    b = lint_snippet(tmp_path, "# a leading comment shifts every line\n" + TORCH["HOST_SYNC_TP"])
    assert {f.fingerprint for f in a} == {f.fingerprint for f in b}


def test_ratchet_blocks_new_but_allows_baselined(tmp_path):
    findings = lint_snippet(tmp_path, TORCH["HOST_SYNC_TP"])
    assert findings
    baseline = {
        f.fingerprint: {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path}
        for f in findings
    }
    assert apply_ratchet(findings, baseline).ok
    assert not apply_ratchet(findings, {}).ok
    assert len(apply_ratchet([], baseline).stale) == len(findings)


def test_file_level_suppression(tmp_path):
    code = "# graftlint: disable-file=host-sync-in-loop\n" + TORCH["HOST_SYNC_TP"]
    assert "host-sync-in-loop" not in rules_hit(lint_snippet(tmp_path, code))


def test_every_rule_has_summary():
    from page_rank_and_tfidf_using_apache_spark_tpu.analysis.rules import RULES as REF_RULES

    assert set(RULES) == set(REF_RULES)
    assert len(RULES) == 13
    for rule in RULES.values():
        assert rule.summary


def test_write_baseline_preserves_unscanned_entries(tmp_path):
    bl = tmp_path / "baseline.json"
    (tmp_path / "a.py").write_text(TORCH["HOST_SYNC_TP"])
    (tmp_path / "b.py").write_text(TORCH["TRACER_BRANCH_TP"])
    both = run_lint([tmp_path / "a.py", tmp_path / "b.py"], tmp_path)
    engine.write_baseline(bl, both, scanned_paths={"a.py", "b.py"})
    assert {e["path"] for e in load_baseline(bl).values()} == {"a.py", "b.py"}
    only_a = run_lint([tmp_path / "a.py"], tmp_path)
    engine.write_baseline(bl, only_a, scanned_paths={"a.py"})
    assert {e["path"] for e in load_baseline(bl).values()} == {"a.py", "b.py"}


# ----------------------------------------------------- the ratchet gate


def test_baseline_is_empty():
    doc = json.loads(baseline_path(REPO).read_text())
    assert doc["entries"] == []


def test_repo_clean_under_ratchet():
    """The port's surface produces no tier-1 finding beyond the (empty)
    baseline."""
    result = apply_ratchet(run_lint(default_targets(REPO), REPO),
                           load_baseline(baseline_path(REPO)))
    msg = "\n".join(f.render() for f in result.new)
    assert result.ok, f"new graftlint findings:\n{msg}"


SUPPRESS_RE = re.compile(r"graftlint:\s*disable(?:-file)?=([A-Za-z0-9_,\- ]+?)\s*(\(.*\))?$")


def _suppressions():
    out = []
    for f in engine.iter_python_files(default_targets(REPO)):
        rel = f.relative_to(REPO).as_posix()
        if "/analysis/" in rel:
            continue  # the analyzer's own docstrings spell the syntax
        for lineno, line in enumerate(f.read_text().splitlines(), 1):
            if "graftlint:" in line and "disable" in line:
                out.append((rel, lineno, line.strip()))
    return out


def test_every_suppression_names_its_reason():
    """Each inline suppression names its rule(s) and a parenthesized
    reason; outside the copies the port carries from the reference (whose
    reasons are the reference's), the reason names its ROADMAP Queue 3
    entry."""
    copies = {"page_rank_and_tfidf_using_apache_spark_tpu_torch/obs/metrics.py",
              "page_rank_and_tfidf_using_apache_spark_tpu_torch/obs/export.py"}
    found = _suppressions()
    assert found
    for rel, lineno, line in found:
        m = SUPPRESS_RE.search(line)
        assert m and m.group(2), f"{rel}:{lineno}: {line}"
        if rel not in copies:
            assert "ROADMAP Queue 3" in m.group(2), f"{rel}:{lineno}: {line}"


def test_hot_path_inline_suppressions_are_justified():
    """ops/ and parallel/ may suppress inline only with named rules AND a
    parenthesized justification on the same line."""
    justified = re.compile(r"graftlint:\s*disable(?:-file)?=[A-Za-z0-9_,\- ]+?\s*\(.+\)")
    for hot in ("ops", "parallel"):
        for f in sorted((PORT / hot).rglob("*.py")):
            for lineno, line in enumerate(f.read_text().splitlines(), 1):
                if "graftlint:" in line and "disable" in line:
                    assert justified.search(line), f"{f}:{lineno}: {line.strip()}"


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis",
         *args], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)


def test_lint_cli_json_output(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text(TORCH["TRACER_BRANCH_TP"])
    proc = _cli(str(f), "--json", "--no-baseline")
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload["ok"] is False and payload["tiers"] == [1, 2, 3, 4, 5, 6]
    assert any(x["rule"] == "tracer-branch" for x in payload["findings"])


@pytest.mark.parametrize("flags", [["--tier", "2"], ["--tier", "3"], ["--cost-report"],
                                   ["--profile-report"], ["--list-entry-points"]])
def test_trace_tiers_are_refused(flags):
    """The trace-based tiers were refused (exit 2) until they were ported
    (ROADMAP item 15b): now each of these flags runs, on one changed file
    where it traces, and exits 0 clean — none refuses, none names 15b."""
    report = flags[0] in ("--cost-report", "--profile-report")
    extra = []
    if flags[0] != "--list-entry-points":
        extra.append("page_rank_and_tfidf_using_apache_spark_tpu_torch/dataflow/bm25.py")
    if report:
        extra += ["--tier", "3", "--json"]
    proc = _cli(*flags, *extra)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "ROADMAP item 15b" not in proc.stdout + proc.stderr
    if report:
        doc = json.loads(proc.stdout)
        assert doc["ok"] and doc[flags[0][2:].replace("-", "_")], doc


def test_list_rules_names_the_ported_tiers():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for tier in ("[tier 1]", "[tier 2]", "[tier 3]", "[tier 4]", "[tier 5]", "[tier 6]"):
        assert tier in proc.stdout
    for rid in ("recompile-per-shape", "collective-uniformity", "donation-contract",
                "profile-drift"):
        assert rid in proc.stdout


def test_lint_gate_is_clean():
    """``tools/lint.sh``, the port's gate, exits 0 on the current tree:
    every ported tier, the three enumeration smokes and the protocol
    harness.  Its budgets are the reference's 10 s; this run allows 3x
    that, as a shared test machine is slower than the gate's own."""
    env = {**os.environ, "GRAFT_CONC_BUDGET_S": "30", "GRAFT_PERSIST_BUDGET_S": "30",
           "GRAFT_PROTO_BUDGET_S": "30", "GRAFT_SEMANTIC_BUDGET_S": "180",
           "GRAFT_COST_BUDGET_S": "90"}
    proc = subprocess.run([str(PORT / "tools" / "lint.sh")], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    for smoke in ("cost-report smoke: OK", "lock-graph smoke: OK", "crash-point smoke: OK",
                  "wire-probe smoke: OK", "protocol_harness: conformant", "lint gate: clean"):
        assert smoke in proc.stdout, smoke
