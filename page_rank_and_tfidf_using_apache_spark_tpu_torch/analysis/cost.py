"""graftlint tier 3 for the port: the static cost model of the registered
entry points.

Tier 2 (``semantic.py``) checks what a traced step does; this tier checks
what it costs, with nothing dispatched.  Each entry's step is traced as
tier 2 traces it (one trace a process serves both) and four budgets are
gated, under the reference's rule ids:

- **intensity-floor** — a static FLOP / byte model over the traced ops,
  one step (loop bodies counted once).  Bytes are each op's un-fused
  operand and result traffic, so the modelled intensity is a lower bound
  of what a fused step does.  A kernel op (``graft_torch``) counts what
  the kernels' bounds in PERF.md section 6 count: each input read once,
  each output written once, and its adds (``segment``: one a value;
  ``cumsum``: one an element; ``rowsum``: W-1 a row; ``spmv`` and
  ``gather``: none).  Views cost nothing.  The floors are the reference's
  numbers; the port's modelled intensity is reported beside each.  An
  entry under its floor is a finding only while the port's own cost
  artifact (``COST_BASELINE_ARTIFACT``, in its package directory) carries
  a ``gpu`` stamp, and an advisory otherwise: the root
  ``xla_cost_tpu.json`` is the JAX package's and is never read.
- **pad-frac-budget** — each entry's ``pad_plan`` evaluates its
  partition or padding plan without placing it
  (``parallel.pagerank_sharded.plan_partition``,
  ``models.tfidf.stream_pad_plan``, ``serving.server.serve_pad_plan``,
  ``impacted_pad_plan``); the worst point must stay under
  ``pad_frac_ceiling``.
- **donation-contract** — ``donate`` declares the inputs the step writes
  in place (where the reference donates a buffer, the port updates it in
  place).  The traced step's writes (the op schemas' write aliases on its
  input placeholders, through views) must equal the declaration, in both
  directions: a declared update that does not happen, and an in-place
  write the registry does not know of.
- **cost-entry-broken** — an entry that fails to build or trace (tier 2
  reports the same as ``entry-point-broken``; the distinct id keeps the
  two tiers' ratchet entries apart).

Findings honour the entry's ``suppress`` set and go through the same
fingerprint, baseline and ratchet machinery as the other tiers.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Sequence

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    Finding,
    assign_fingerprints,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
    ENTRY_POINTS,
    EntryPoint,
    build_traceable,
    quiet_telemetry,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.semantic import (
    _Sink,
    distinct_variants,
    trace_cached,
)

COST_RULES: dict[str, str] = {
    "intensity-floor": (
        "static FLOP/byte intensity fell below the entry's declared floor "
        "— the step got more memory-bound; advisory while the port's cost "
        "artifact is not stamped gpu"
    ),
    "pad-frac-budget": (
        "static padding-waste fraction of the entry's partition/padding "
        "plan exceeds its declared ceiling — more dispatched work is "
        "padding than the budget allows"
    ),
    "donation-contract": (
        "the inputs the traced step writes in place disagree with the "
        "entry's donate declaration — an in-place update that does not "
        "happen, or one the registry does not declare"
    ),
    "cost-entry-broken": (
        "a registered entry point no longer builds or traces for the "
        "tier-3 cost model — the registry contract is stale"
    ),
}

# The port's cost artifact: only its backend stamp is read.  A gpu stamp
# arms the intensity gate; anything else (or no file) leaves it advisory.
COST_BASELINE_ARTIFACT = "page_rank_and_tfidf_using_apache_spark_tpu_torch/xla_cost_gpu.json"

# ----------------------------------------------------------------------
# the per-op FLOP/byte model (the reference's families, as aten ops)
# ----------------------------------------------------------------------

_MATMUL = frozenset({"mm", "bmm", "matmul", "addmm", "mv", "dot", "baddbmm"})
_SORT = frozenset({"sort", "argsort", "msort", "topk", "kthvalue"})
_SCANS = frozenset({"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"})
_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "any", "all", "norm", "linalg_vector_norm", "logsumexp", "segment_reduce",
})
_GATHERISH = frozenset({"index", "index_select", "gather", "take", "embedding",
                        "take_along_dim"})
_SCATTERISH = frozenset({
    "index_add", "index_add_", "index_put", "index_put_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_copy", "index_copy_", "masked_scatter", "masked_scatter_",
})
_MATERIALIZE = frozenset({
    "arange", "zeros", "ones", "full", "empty", "empty_like", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full", "new_empty",
    "scalar_tensor", "empty_strided", "fill", "fill_", "zero_",
})
_MOVES = frozenset({
    "_to_copy", "copy", "copy_", "clone", "cat", "stack", "constant_pad_nd",
    "repeat", "expand_copy", "where", "lift_fresh_copy", "flip", "roll",
    "_unsafe_view", "contiguous",
})
_TRANSCENDENTAL = frozenset({
    "exp", "log", "log1p", "expm1", "tanh", "sin", "cos", "tan", "sigmoid",
    "erf", "erfc", "pow", "atan2", "exp2", "log2", "log10",
})
_SQRTISH = frozenset({"sqrt", "rsqrt"})


def _elems(shape) -> int:
    return math.prod(int(d) for d in shape)


def _bytes(tensors) -> int:
    return sum(_elems(shape) * dtype.itemsize for shape, dtype, _dev in tensors)


def _kernel_flops(node) -> int:
    """The adds PERF.md section 6's bound counts for each kernel."""
    ins = node.inputs
    if node.name == "segment":
        # values, ptr[, src[, edge_weight]]: one add a summed value
        return _elems(ins[2][0]) if len(ins) > 2 else _elems(ins[0][0])
    if node.name == "cumsum":
        return _elems(ins[0][0])
    if node.name == "rowsum":
        r, w = ins[0][0]
        return r * max(w - 1, 0)
    return 0  # spmv, gather: bounded by bytes alone


def classify(node) -> tuple[str, int]:
    """(cost class, flops) of one traced op."""
    name = node.name
    out_elems = max(sum(_elems(o[0]) for o in node.outputs), 1)
    in_elems = max(sum(_elems(i[0]) for i in node.inputs), 1)
    if node.is_kernel:
        return "kernel", _kernel_flops(node)
    if node.is_view:
        return "view", 0
    if name in _MATMUL:
        if len(node.inputs) >= 2 and node.inputs[0][0]:
            k = int(node.inputs[0][0][-1])
            return "matmul", 2 * out_elems * max(k, 1)
        return "matmul", 2 * out_elems
    if name in _SORT:
        n = _elems(node.inputs[0][0]) if node.inputs else in_elems
        return "sort", n * max(int(math.log2(max(n, 2))), 1)
    if name in _SCANS:
        return "scan-prefix", in_elems
    if name in _REDUCE:
        return "reduce", in_elems
    if name in _GATHERISH:
        return "gather", 0
    if name in _SCATTERISH:
        # the combine runs once per update element: the largest operand
        return "scatter", max((_elems(i[0]) for i in node.inputs), default=out_elems)
    if name in _MATERIALIZE:
        return "materialize", 0
    if name in _MOVES:
        return "move", 0
    if name in _TRANSCENDENTAL:
        return "elementwise", 10 * out_elems
    if name in _SQRTISH:
        return "elementwise", 4 * out_elems
    return "elementwise", out_elems  # one op per output element


@dataclasses.dataclass
class CostSummary:
    """Static per-step cost model of one traced variant."""

    flops: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    comm_bytes: int = 0  # the per-slot results of the step's collectives
    materialized_bytes: int = 0  # factory results and constants
    callback_eqns: int = 0  # host reads and host-bound moves
    eqns: int = 0  # ops that cost something (views left out)
    classes: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> nodes/flops/bytes

    @property
    def hbm_bytes(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1)

    def to_dict(self) -> dict:
        top = sorted(self.classes.items(), key=lambda kv: kv[1]["bytes"], reverse=True)
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "intensity": round(self.intensity, 6),
            "comm_bytes": self.comm_bytes,
            "materialized_bytes": self.materialized_bytes,
            "callback_eqns": self.callback_eqns,
            "eqns": self.eqns,
            "classes": dict(top),
            "kernels": dict(sorted(self.kernels.items())),
        }


def summarize(trace) -> CostSummary:
    """The static cost model of one traced step (``trace.Trace``)."""
    s = CostSummary()
    s.materialized_bytes += _bytes(trace.constants)
    s.callback_eqns = len(trace.transfers())
    s.comm_bytes = sum(c.nbytes for c in trace.collectives)
    for node in trace.nodes:
        cls, flops = classify(node)
        if cls == "view":
            continue
        read, written = _bytes(node.inputs), _bytes(node.outputs)
        s.eqns += 1
        s.flops += flops
        s.bytes_read += read
        s.bytes_written += written
        if cls == "materialize":
            s.materialized_bytes += written
        c = s.classes.setdefault(cls, {"eqns": 0, "flops": 0, "bytes": 0})
        c["eqns"] += 1
        c["flops"] += flops
        c["bytes"] += read + written
        if cls == "kernel":
            k = s.kernels.setdefault(node.name, {"nodes": 0, "flops": 0, "bytes": 0})
            k["nodes"] += 1
            k["flops"] += flops
            k["bytes"] += read + written
    return s


def baseline_backend(path: Path) -> str | None:
    """Backend stamp of the cost artifact (``"gpu"``, ``"cpu"``, or None
    when it is missing, unreadable or unstamped): the reader the port's
    write-time provenance guard uses."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.artifacts import read_backend

    return read_backend(path)


@dataclasses.dataclass
class CostResult:
    """Tier-3 output: gating findings, non-gating advisories (intensity
    under a floor while the cost artifact is not gpu-stamped), and the
    per-entry cost report for ``--cost-report``."""

    findings: list[Finding]
    advisories: list[Finding]
    report: dict

    @property
    def ok(self) -> bool:
        return not self.findings


def _analyze_entry_cost(ep: EntryPoint, root: Path,
                        enforce_intensity: bool) -> tuple[list, list, dict]:
    sink = _Sink(ep, root)
    report: dict = {"entry": ep.name, "variants": {}}
    try:
        t = build_traceable(ep)
    except Exception as exc:
        sink.add("cost-entry-broken",
                 f"entry point failed to build: {type(exc).__name__}: {exc}")
        return sink.findings, sink.advisories, report
    sink.t = t

    worst = None  # (intensity, label)
    for label, args in distinct_variants(t).values():
        try:
            trace = trace_cached(ep, t.fn, args)
        except Exception as exc:
            sink.add("cost-entry-broken",
                     f"tracing variant {label!r} failed: {type(exc).__name__}: {exc}")
            return sink.findings, sink.advisories, report
        summary = summarize(trace)
        report["variants"][label] = summary.to_dict()
        if worst is None or summary.intensity < worst[0]:
            worst = (summary.intensity, label)

    # ---- intensity-floor (advisory without a gpu-stamped artifact)
    if ep.intensity_floor is not None and worst is not None:
        report["intensity_floor"] = ep.intensity_floor
        report["intensity"] = round(worst[0], 6)
        if worst[0] < ep.intensity_floor:
            sink.add("intensity-floor",
                     f"static arithmetic intensity {worst[0]:.4f} flop/byte in variant "
                     f"{worst[1]!r} fell below the declared floor {ep.intensity_floor} — the "
                     "step got more memory-bound"
                     + ("" if enforce_intensity else
                        f" [ADVISORY: {COST_BASELINE_ARTIFACT} is not gpu-stamped; run the "
                        "port's cost tools on the card to arm this gate]"),
                     advisory=not enforce_intensity)

    # ---- pad-frac-budget (static plan analyzer)
    if ep.pad_plan is not None:
        try:
            with quiet_telemetry():
                plan_points = list(ep.pad_plan())
        except Exception as exc:
            sink.add("cost-entry-broken", f"pad plan failed: {type(exc).__name__}: {exc}")
            plan_points = []
        report["pad_plan"] = {lbl: round(frac, 4) for lbl, frac in plan_points}
        if ep.pad_frac_ceiling is not None and plan_points:
            report["pad_frac_ceiling"] = ep.pad_frac_ceiling
            worst_pad = max(plan_points, key=lambda p: p[1])
            if worst_pad[1] > ep.pad_frac_ceiling:
                sink.add("pad-frac-budget",
                         f"static pad_frac {worst_pad[1]:.4f} at plan point {worst_pad[0]!r} "
                         f"exceeds the declared ceiling {ep.pad_frac_ceiling} — more than the "
                         "budgeted fraction of dispatched work is padding")

    # ---- donation-contract (in-place writes of the traced step)
    if ep.donate is not None:
        label, args = t.variants[0]
        fn = t.donate_fn if t.donate_fn is not None else t.fn
        if t.donate_kwargs:
            import functools

            fn = functools.partial(fn, **t.donate_kwargs)
        try:
            written = sorted(trace_cached(ep, fn, args).writes)
        except Exception as exc:
            sink.add("cost-entry-broken",
                     f"tracing variant {label!r} for the donation check failed: "
                     f"{type(exc).__name__}: {exc}")
        else:
            declared = sorted(ep.donate)
            report["donation"] = {"declared": declared, "written": written}
            missing = [i for i in declared if i not in written]
            extra = [i for i in written if i not in declared]
            if missing:
                sink.add("donation-contract",
                         f"declares donate={declared} but the traced step writes inputs "
                         f"{written} in place — the declared in-place update of argnum(s) "
                         f"{missing} does not happen")
            if extra:
                sink.add("donation-contract",
                         f"the traced step writes input argnum(s) {extra} in place but the "
                         f"registry declares donate={declared} — an undeclared in-place "
                         "write; a caller reusing that input reads the updated values")
    return sink.findings, sink.advisories, report


def run_cost(
    root: Path | None = None,
    entries: Sequence[EntryPoint] | None = None,
    only_modules: set[str] | None = None,
    baseline_path: Path | None = None,
) -> CostResult:
    """Run the tier-3 static cost analysis.

    ``only_modules`` restricts the run as in :func:`semantic.run_semantic`.
    ``baseline_path`` overrides the cost artifact whose backend stamp
    decides whether the intensity floors gate (gpu) or advise."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import repo_root

    root = root or repo_root()
    bl_path = baseline_path or (root / COST_BASELINE_ARTIFACT)
    backend = baseline_backend(bl_path)
    enforce_intensity = backend == "gpu"
    findings: list[Finding] = []
    advisories: list[Finding] = []
    report: dict = {
        "baseline_artifact": str(bl_path),
        "baseline_backend": backend,
        "intensity_gate": "enforcing" if enforce_intensity else "advisory",
        "entries": [],
    }
    for ep in entries if entries is not None else ENTRY_POINTS:
        if only_modules is not None and not ({ep.module, *ep.watch} & only_modules):
            continue
        f, a, rep = _analyze_entry_cost(ep, root, enforce_intensity)
        findings.extend(f)
        advisories.extend(a)
        report["entries"].append(rep)
    return CostResult(findings=assign_fingerprints(findings),
                      advisories=assign_fingerprints(advisories), report=report)
