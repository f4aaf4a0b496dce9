"""The port's tier 2 (``..._torch/analysis/semantic.py``): trace-level
checks of the registered entry points, against the reference's tier-2
tests (``tests/test_semantic_lint.py``).

Every fixture of the reference's file, translated to torch: for each rule
a true positive (a seeded entry point that must fire), a true negative and
a suppressed positive, under the reference's rule ids.  The seeds are the
mutations the rules exist for — an ``.item()`` in a step, an int64
widening, a collective on an undeclared axis, a collective after a
slot-varying host read — and each is also applied to a real entry's step.
Then the registry against the reference's (read by AST and through the
reference's own ``build_traceable``, nothing of its ``semantic.py``), the
kernels as one op each, and the whole registry clean.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import repo_root
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import semantic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import trace as tr
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import (
    changed_python_files,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
    ENTRY_POINTS,
    EntryPoint,
    Traceable,
    build_traceable,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import Mesh, Slot

REPO = repo_root()
PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF_PKG = "page_rank_and_tfidf_using_apache_spark_tpu"


def run_entries(*entries: EntryPoint):
    return semantic.run_semantic(root=REPO, entries=list(entries))


def rules_hit(findings) -> set[str]:
    return {f.rule for f in findings}


def _mesh(axis: str, slots: int = 1) -> Mesh:
    return Mesh(tuple(Slot(i, torch.device("cpu")) for i in range(slots)), axis)


# ------------------------------------------------------ recompile-per-shape


def _build_unpadded():
    """Raw workload sizes straight into the step: one shape each."""

    def f(x):
        return x * 2.0

    return Traceable(f, [(f"n{n}", (tr.spec((n,)),)) for n in (100, 177, 256)])


def _build_padded():
    """The same sizes through a pow2 padding policy: one shape."""

    def f(x):
        return x * 2.0

    return Traceable(f, [(f"n{n}", (tr.spec((256,)),)) for n in (100, 177, 256)])


def test_recompile_true_positive():
    ep = EntryPoint(name="unpadded", module="x.py", build=_build_unpadded)
    findings = run_entries(ep)
    assert "recompile-per-shape" in rules_hit(findings)
    assert any("3 distinct leaf signatures" in f.message for f in findings)


def test_recompile_true_negative():
    ep = EntryPoint(name="padded", module="x.py", build=_build_padded)
    assert "recompile-per-shape" not in rules_hit(run_entries(ep))


def test_recompile_suppressed():
    ep = EntryPoint(name="unpadded", module="x.py", build=_build_unpadded,
                    suppress=frozenset({"recompile-per-shape"}))
    assert "recompile-per-shape" not in rules_hit(run_entries(ep))


# ------------------------------------------------------- implicit-promotion


def _build_promoting(kind: str = "arange"):
    """An unpinned ``arange`` (int64 by default), or an explicit widening."""

    def f(x):
        if kind == "arange":
            return x * torch.arange(x.shape[0], device=x.device)
        return x.long() + 1

    return lambda: Traceable(f, [("v", (tr.spec((16,)),))])


def _build_pinned():
    def f(x):
        return x * torch.arange(x.shape[0], dtype=torch.int32, device=x.device)

    return Traceable(f, [("v", (tr.spec((16,)),))])


@pytest.mark.parametrize("kind", ["arange", "widening"])
def test_promotion_true_positive(kind):
    ep = EntryPoint(name="promo", module="x.py", build=_build_promoting(kind))
    findings = [f for f in run_entries(ep) if f.rule == "implicit-promotion"]
    assert findings and "int64" in findings[0].message


def test_promotion_true_negative():
    ep = EntryPoint(name="pinned", module="x.py", build=_build_pinned)
    assert "implicit-promotion" not in rules_hit(run_entries(ep))


def test_promotion_suppressed_by_allow_64bit():
    ep = EntryPoint(name="promo", module="x.py", build=_build_promoting(), allow_64bit=True)
    assert "implicit-promotion" not in rules_hit(run_entries(ep))


def test_promotion_suppress_set():
    ep = EntryPoint(name="promo", module="x.py", build=_build_promoting(),
                    suppress=frozenset({"implicit-promotion"}))
    assert "implicit-promotion" not in rules_hit(run_entries(ep))


# --------------------------------------------------------- transfer-census


def _build_reading():
    """A step that reads a value on the host: ``.item()``."""

    def f(x):
        return x + x.sum().item()

    return Traceable(f, [("v", (tr.spec((8,)),))])


def _build_pure():
    def f(x):
        return x + 1.0

    return Traceable(f, [("v", (tr.spec((8,)),))])


def test_transfer_true_positive():
    ep = EntryPoint(name="xfer", module="x.py", build=_build_reading)
    findings = [f for f in run_entries(ep) if f.rule == "transfer-census"]
    assert findings and "budget 0" in findings[0].message


def test_transfer_true_negative():
    ep = EntryPoint(name="clean", module="x.py", build=_build_pure)
    assert "transfer-census" not in rules_hit(run_entries(ep))


def test_transfer_within_budget():
    ep = EntryPoint(name="xfer", module="x.py", build=_build_reading, transfer_budget=1)
    assert "transfer-census" not in rules_hit(run_entries(ep))


def test_transfer_suppressed():
    ep = EntryPoint(name="xfer", module="x.py", build=_build_reading,
                    suppress=frozenset({"transfer-census"}))
    assert "transfer-census" not in rules_hit(run_entries(ep))


# ----------------------------------------------------------- sharding-axis


def _psum_on(axis: str):
    def build():
        mesh = _mesh(axis)

        def f(x):
            return coll.psum([x], mesh=mesh)[0]

        return Traceable(f, [("v", (tr.spec((8,)),))])

    return build


def test_sharding_axis_true_positive():
    ep = EntryPoint(name="ax", module="x.py", build=_psum_on("data"),
                    axes=("nodes",))  # registry says nodes; the step's mesh says data
    findings = [f for f in run_entries(ep) if f.rule == "sharding-axis"]
    assert findings and "'data'" in findings[0].message


def test_sharding_axis_true_negative():
    ep = EntryPoint(name="ax", module="x.py", build=_psum_on("nodes"), axes=("nodes",),
                    collective_budget=1)
    assert "sharding-axis" not in rules_hit(run_entries(ep))


def test_collective_budget_true_positive():
    ep = EntryPoint(name="ax", module="x.py", build=_psum_on("nodes"), axes=("nodes",),
                    collective_budget=0)
    findings = [f for f in run_entries(ep) if f.rule == "sharding-axis"]
    assert findings and "collective(s) per step" in findings[0].message


def test_sharding_axis_suppressed():
    ep = EntryPoint(name="ax", module="x.py", build=_psum_on("data"), axes=("nodes",),
                    collective_budget=0, suppress=frozenset({"sharding-axis"}))
    assert "sharding-axis" not in rules_hit(run_entries(ep))


# ----------------------------------------------- collective-uniformity


def _slot_divergent(ctrl: str, uniform: bool):
    """A two-slot step whose ``ctrl`` (an ``if`` or a ``while`` on a host
    read) wraps a psum.  ``uniform=True`` reduces the read value with a
    psum first (the owned fixpoint's idiom): the same on every slot.
    False leaves it slot-varying: some processes would run the
    collective, the rest never arrive."""

    def build():
        mesh = _mesh("nodes", 2)

        def residual(xs):
            resid = [torch.sum(torch.abs(x)) for x in xs]
            return coll.psum(resid, mesh=mesh) if uniform else resid

        def f(x0, x1):
            xs = [x0, x1]
            if ctrl == "cond":
                if float(residual(xs)[0]) > 0.5:
                    return coll.psum(xs, mesh=mesh)
                return [x * 2.0 for x in xs]
            while float(residual(xs)[0]) > 0.5:
                xs = [x * 0.25 for x in coll.psum(xs, mesh=mesh)]
            return xs

        return Traceable(f, [("v", (tr.spec((8,)), tr.spec((8,))))])

    return build


@pytest.mark.parametrize("ctrl", ["cond", "while"])
def test_collective_uniformity_true_positive(ctrl):
    ep = EntryPoint(name=f"div_{ctrl}", module="x.py", build=_slot_divergent(ctrl, False),
                    axes=("nodes",), collective_budget=8, transfer_budget=100)
    findings = [f for f in run_entries(ep) if f.rule == "collective-uniformity"]
    assert findings and "psum" in findings[0].message
    assert "slot-varying" in findings[0].message and "Hoist" in findings[0].message


@pytest.mark.parametrize("ctrl", ["cond", "while"])
def test_collective_uniformity_true_negative_reduced_predicate(ctrl):
    """A psum-reduced value is the same on every slot, so the branch is
    taken alike everywhere and the collective inside is safe: the owned
    strategies pass by analysis, not by exemption."""
    ep = EntryPoint(name=f"uni_{ctrl}", module="x.py", build=_slot_divergent(ctrl, True),
                    axes=("nodes",), collective_budget=8, transfer_budget=100)
    assert "collective-uniformity" not in rules_hit(run_entries(ep))


def test_collective_uniformity_suppressed():
    ep = EntryPoint(name="div_cond_ok", module="x.py", build=_slot_divergent("cond", False),
                    axes=("nodes",), collective_budget=8,
                    suppress=frozenset({"collective-uniformity"}))
    assert "collective-uniformity" not in rules_hit(run_entries(ep))


def test_collective_uniformity_needs_declared_axes():
    """Unsharded entries (no ``axes`` contract) are not held to it: there
    is no mesh to diverge over."""
    ep = EntryPoint(name="unsharded", module="x.py", build=_slot_divergent("cond", False))
    assert "collective-uniformity" not in rules_hit(run_entries(ep))


def test_a_loop_on_a_host_read_stops_the_trace():
    """A ``while`` on a read answers the stand-in forever: the trace stops
    at MAX_HOST_READS and says so, never hangs."""
    t = _slot_divergent("while", False)()
    trace = tr.trace_variant(t.fn, t.variants[0][1])
    assert trace.stopped and len(trace.host_reads) == tr.MAX_HOST_READS + 1


# ------------------------------------------------------- entry-point-broken


def test_broken_entry_is_a_finding():
    def build():
        raise ImportError("entry point moved")

    ep = EntryPoint(name="gone", module="x.py", build=build)
    findings = [f for f in run_entries(ep) if f.rule == "entry-point-broken"]
    assert findings and "ImportError" in findings[0].message


def test_untraceable_entry_is_a_finding():
    def build():
        def f(x):
            return x.nonexistent_attribute

        return Traceable(f, [("v", (tr.spec((4,)),))])

    ep = EntryPoint(name="sick", module="x.py", build=build)
    assert "entry-point-broken" in rules_hit(run_entries(ep))


# ------------------------------------------ the mutations on a real entry


def _mutated(mutation: str):
    """``pagerank_step``'s real step with one seeded fault."""

    def build():
        t = build_traceable(next(ep for ep in ENTRY_POINTS if ep.name == "pagerank_step"))

        def fn(dg, ranks0, e):
            out = t.fn(dg, ranks0, e)[0]
            if mutation == "item":
                return out + out.sum().item()
            if mutation == "widening":
                return out.double()
            if mutation == "axis":
                return coll.psum([out], mesh=_mesh("data"))[0]
            return out

        return Traceable(fn, t.variants, anchor=t.anchor)

    return build


@pytest.mark.parametrize("mutation, rule", [
    ("item", "transfer-census"), ("widening", "implicit-promotion"),
    ("axis", "sharding-axis"), ("none", None)])
def test_mutations_of_a_real_step(mutation, rule):
    ep = EntryPoint(name="pagerank_step_mutated", module=f"{PKG}/ops/pagerank.py",
                    build=_mutated(mutation), axes=("nodes",) if mutation == "none" else ())
    hit = rules_hit(run_entries(ep))
    assert hit == ({rule} if rule else set()), hit


# ------------------------------------------------------ the tier-2 gate


def test_registry_covers_every_step_surface():
    """Each surface that dispatches a step keeps at least one contract."""
    modules = {ep.module for ep in ENTRY_POINTS}
    for m in ("ops/pagerank.py", "ops/tfidf.py", "ops/pallas_kernels.py",
              "parallel/pagerank_sharded.py", "parallel/tfidf_sharded.py",
              "parallel/workloads_sharded.py", "dataflow/ppr.py", "dataflow/hits.py",
              "dataflow/components.py", "dataflow/bm25.py"):
        assert f"{PKG}/{m}" in modules, m


def test_every_dataflow_step_surface_is_registered():
    """A module under dataflow/ that hands a step to the loop driver
    (``iterate(``) without a registry entry, or a ``watch`` hook from one,
    fails: a new workload cannot ship outside the tier-2 and tier-3 gates."""
    covered = {ep.module for ep in ENTRY_POINTS} | {w for ep in ENTRY_POINTS for w in ep.watch}
    missing = [f"{PKG}/dataflow/{p.name}" for p in sorted((REPO / PKG / "dataflow").glob("*.py"))
               if "iterate(" in p.read_text(encoding="utf-8")
               and f"{PKG}/dataflow/{p.name}" not in covered]
    assert not missing, missing


def test_every_watched_module_exists():
    for ep in ENTRY_POINTS:
        for path in (ep.module, *ep.watch):
            assert (REPO / path).is_file(), (ep.name, path)


def test_sharded_entries_trace_the_shrink_chain():
    """Every sharded entry declares one variant a slot count on the elastic
    shrink chain (4, 2, 1): the gates hold for the shrunk meshes a
    degraded run executes on."""
    sharded = [ep for ep in ENTRY_POINTS
               if ep.name.startswith("pagerank_sharded") or ep.name == "tfidf_sharded_ingest"]
    assert len(sharded) == 6
    for ep in sharded:
        labels = [label for label, _ in build_traceable(ep).variants]
        assert len(labels) >= 2, (ep.name, labels)
        assert any(label.endswith("-d1") or "d1-" in label for label in labels), labels
        assert len(labels) <= ep.max_compiles, (ep.name, labels)


def test_repo_semantic_clean():
    """Every registered entry point traces with no finding: the tier-2
    ratchet stays empty."""
    findings = semantic.run_semantic(root=REPO)
    msg = "\n".join(f.render() for f in findings)
    assert not findings, f"tier-2 findings (fix the code, not the gate):\n{msg}"


def test_semantic_findings_carry_real_anchors():
    """Findings point at the entry's public function (and a promotion at the
    function that makes the value), so fingerprints survive refactors."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    def build():
        fn = functools.partial(ops.chunk_counts, vocab=64)
        return Traceable(fn, [(f"n{n}", (tr.spec((n,), torch.int32), tr.spec((n,), torch.int32),
                                         tr.spec((n,), torch.bool))) for n in (64, 96)],
                         anchor=ops.chunk_counts)

    ep = EntryPoint(name="unpadded", module=f"{PKG}/ops/tfidf.py", build=build)
    findings = [f for f in run_entries(ep) if f.rule == "recompile-per-shape"]
    assert findings
    f = findings[0]
    assert f.path == f"{PKG}/ops/tfidf.py" and f.line > 1 and f.snippet.startswith("def chunk_counts")


def test_inline_suppression_is_honoured_at_the_line():
    """``_count_padded`` makes its 62-bit keys by design and says so at its
    ``def``: the finding is suppressed there; without the comment it
    fires at that line."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    def build():
        fn = functools.partial(ops.chunk_counts, vocab=64)
        return Traceable(fn, [("n64", (tr.spec((64,), torch.int32), tr.spec((64,), torch.int32),
                                       tr.spec((64,), torch.bool)))])

    ep = EntryPoint(name="keys", module=f"{PKG}/ops/tfidf.py", build=build)
    assert "implicit-promotion" not in rules_hit(run_entries(ep))
    assert semantic.suppressed(REPO, f"{PKG}/ops/tfidf.py",
                               ops._count_padded.__code__.co_firstlineno, "implicit-promotion")


def test_only_modules_respects_watch_list():
    """--changed-only re-traces an entry when a watched dependency changed,
    not just its own module."""
    ep = EntryPoint(name="unpadded", module="x.py", watch=("policy.py",), build=_build_unpadded)
    hit = semantic.run_semantic(root=REPO, entries=[ep], only_modules={"policy.py"})
    assert "recompile-per-shape" in rules_hit(hit)
    assert semantic.run_semantic(root=REPO, entries=[ep], only_modules={"unrelated.py"}) == []


# ------------------------------------------------ parity with the reference


def _entry_rows(path: Path) -> dict:
    """name -> the literal keywords of each ``EntryPoint(...)`` in a
    registry source, the module as its stem under the package."""
    rows = {}
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "EntryPoint":
            kw = {}
            for k in node.keywords:
                if k.arg == "module":
                    kw["module"] = ast.unparse(k.value).split("}/", 1)[1].rstrip("\"'")
                elif k.arg in ("max_compiles", "transfer_budget", "axes", "collective_budget",
                               "allow_64bit", "intensity_floor", "pad_frac_ceiling", "donate"):
                    kw[k.arg] = ast.literal_eval(k.value)
                elif k.arg in ("name",):
                    kw[k.arg] = k.value.value
                elif k.arg == "pad_plan":
                    kw["pad_plan"] = True
            rows[kw["name"]] = kw
    return rows


def test_entries_names_modules_and_budgets_are_the_references():
    """The 26 entries under the reference's names, module stems and
    budgets.  ``donate`` differs by design (ROADMAP Queue 3): the runners
    the reference donates into write no input in the port."""
    port = _entry_rows(REPO / PKG / "analysis" / "registry.py")
    ref = _entry_rows(REPO / REF_PKG / "analysis" / "registry.py")
    assert len(port) == 26 and port.keys() == ref.keys()
    by_design = {"pagerank_step", "pagerank_step_tol_cumsum", "pagerank_step_pallas",
                 "pagerank_step_hybrid", "pagerank_step_sort_shuffle", "pagerank_sharded_owned",
                 "dataflow_ppr_batch", "dataflow_hits", "dataflow_components"}
    for name in ref:
        mine, theirs = dict(port[name]), dict(ref[name])
        if name in by_design:
            assert theirs.pop("donate") and mine.pop("donate") == (), name
        assert mine == theirs, name


def _ref_registry():
    from page_rank_and_tfidf_using_apache_spark_tpu.analysis import registry as ref

    return ref


def test_signature_counts_are_the_references():
    """Each entry's distinct leaf signatures number the reference's
    variants' (x64 on, as the test session sets it)."""
    import jax

    ref = {ep.name: ep for ep in _ref_registry().ENTRY_POINTS}
    for ep in ENTRY_POINTS:
        ref_t = _ref_registry().build_traceable(ref[ep.name])
        ref_sigs = {tuple((tuple(leaf.shape), str(leaf.dtype))
                          for leaf in jax.tree_util.tree_leaves(args))
                    for _, args in ref_t.variants}
        mine = semantic.distinct_variants(build_traceable(ep))
        assert len(mine) == len(ref_sigs), (ep.name, len(mine), len(ref_sigs))


def test_pad_plans_are_the_references():
    ref = {ep.name: ep for ep in _ref_registry().ENTRY_POINTS}
    planned = [ep for ep in ENTRY_POINTS if ep.pad_plan is not None]
    assert len(planned) == 9
    for ep in planned:
        mine, theirs = list(ep.pad_plan()), list(ref[ep.name].pad_plan())
        assert [label for label, _ in mine] == [label for label, _ in theirs], ep.name
        np.testing.assert_allclose([f for _, f in mine], [f for _, f in theirs], rtol=0,
                                   atol=1e-12, err_msg=ep.name)


# ------------------------------------------------------ kernels as one op


def _kernel_calls():
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    i32 = torch.int32
    return {
        "segment": (lambda v, p, s: sk.segment_sum_kernel(v, p, 4, src=s),
                    lambda v, p, s: sk.segment_sum_plain(v, p, 4, src=s),
                    [((8,), torch.float32), ((5,), i32), ((16,), i32)]),
        "cumsum": (pk.cumsum_kernel, pk.cumsum_plain, [((16,), torch.float32)]),
        "rowsum": (pk.rowsum_kernel, pk.rowsum_plain, [((4, 8), torch.float32)]),
        "spmv": (lambda s, p, w: pk.spmv_pallas(s, p, w, n=4),
                 lambda s, p, w: pk.spmv_pallas_plain(s, p, w, n=4),
                 [((16,), i32), ((5,), i32), ((4,), torch.float32)]),
        "gather": (lambda x, i: gk.take_along_rows_kernel(x, i, axis=1),
                   lambda x, i: gk.take_along_rows_plain(x, i, axis=1),
                   [((8, 8), torch.float32), ((8, 8), i32)]),
    }


def _cpu_input(shape, dtype, rng):
    if dtype == torch.int32:
        if shape == (5,):  # CSR pointers over 16 values, 4 rows
            return torch.tensor([0, 3, 3, 10, 16], dtype=dtype)
        return torch.from_numpy(rng.integers(0, 4, shape).astype(np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name", ["segment", "cumsum", "rowsum", "spmv", "gather"])
def test_each_kernel_traces_as_one_op(name):
    """On fake tensors on the card's device a wrapper is exactly one op of
    the port's namespace, named by its LAUNCHES key; on CPU tensors it is
    its plain version, bit for bit."""
    kernel, plain, specs = _kernel_calls()[name]
    trace = tr.trace_variant(kernel, tuple(tr.spec(s, d) for s, d in specs))
    ops = [n.target for n in trace.nodes]
    assert ops == [f"graft_torch.{name}.default"], ops
    assert trace.kernel_nodes() == {name: 1}
    rng = np.random.default_rng(7)
    args = [_cpu_input(s, d, rng) for s, d in specs]
    assert torch.equal(kernel(*args), plain(*args))
    # the op's real implementation is the wrapper
    op = getattr(torch.ops.graft_torch, name)
    if name == "segment":
        got = op(args[0], args[1], 4, args[2], None)
    else:
        got = op(*args, *{"spmv": (4, None), "gather": (1,)}.get(name, ()))
    assert torch.equal(got, plain(*args))


def test_widened_segment_traces_as_one_op_of_its_dtype():
    """The owned head's float32-in, float64-out call traces as one
    ``segment`` op whose result is float64, as it runs."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    trace = tr.trace_variant(
        lambda v, p, s: sk.segment_sum_kernel(v, p, 4, src=s, out_dtype=torch.float64),
        (tr.spec((8,), torch.float32), tr.spec((5,), torch.int32), tr.spec((16,), torch.int32)))
    assert [n.target for n in trace.nodes] == ["graft_torch.segment.default"]
    assert [(tuple(shape), dtype) for shape, dtype, _ in trace.nodes[0].outputs] == \
        [((4,), torch.float64)]


# ------------------------------------------------------------ CLI plumbing


def test_cli_tier2_clean():
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.analysis", "--tier", "2"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_list_entry_points():
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.analysis", "--list-entry-points"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    ref = _entry_rows(REPO / REF_PKG / "analysis" / "registry.py")
    listed = [line.split()[0] for line in proc.stdout.splitlines()]
    assert sorted(listed) == sorted(ref)


def test_changed_only_mode(tmp_path):
    """--changed-only lints exactly the files changed vs the base ref."""
    repo = tmp_path / "r"
    repo.mkdir()
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
    subprocess.run(["git", "-C", str(repo), "config", "user.email", "t@t"], check=True)
    subprocess.run(["git", "-C", str(repo), "config", "user.name", "t"], check=True)
    (repo / "clean.py").write_text("x = 1\n")
    subprocess.run(["git", "-C", str(repo), "add", "."], check=True)
    subprocess.run(["git", "-C", str(repo), "commit", "-qm", "seed"], check=True)
    assert changed_python_files(repo, "HEAD") == []
    (repo / "clean.py").write_text("x = 2\n")
    (repo / "new.py").write_text("y = 3\n")
    (repo / "notes.txt").write_text("not python\n")
    assert [p.name for p in changed_python_files(repo, "HEAD")] == ["clean.py", "new.py"]


def test_cli_changed_only_runs_clean():
    """On the real repo the changed-only gate runs end to end (rc 0, never
    a crash), as the reference's test runs it."""
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.analysis", "--changed-only", "HEAD",
                           "--tier", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
