"""graftlint tier 2 for the port: trace-level checks of the registered
entry points.

The lexical tier (``rules.py``) sees source text; this tier sees what a
step runs.  Every :class:`~.registry.EntryPoint` is traced one step at a
time with ``make_fx`` on fake tensors on the card's device
(``analysis/trace.py``): no FLOPs, no card, a few tens of ms a variant.
The reference's six rule ids, in torch terms:

- **recompile-per-shape** — the entry's shape matrix (raw workload sizes
  run through the caller's real padding policy) must give at most
  ``max_compiles`` distinct leaf signatures.  Each is a plan build and an
  allocator size here, and would be a graph capture.
- **implicit-promotion** — traced from inputs pinned to float32/int32,
  the step must make no 64-bit value (an op result or a tensor it closes
  over), unless ``allow_64bit``.  A view of a 64-bit value makes none;
  what happens inside a kernel op is opaque.  One finding a function of
  the port that makes them, at its ``def`` line.
- **transfer-census** — the step's host reads (a scalar read, a result
  whose shape depends on the data) and its moves of card data to the
  host, against ``transfer_budget`` (default 0: a step never waits on
  the host).  At the first read's line.
- **sharding-axis** — every collective's mesh axis must be declared in
  ``axes``, and the collectives a step runs (the reference's primitives:
  a butterfly is log2(D) ``ppermute`` s) must not exceed
  ``collective_budget``.
- **collective-uniformity** — on a sharded entry, a collective recorded
  after a host read of a slot-varying value in the same step: the read
  can steer the step, so across processes the slots can disagree about
  running the collective.  At the collective's line.
- **entry-point-broken** — a builder or trace that raises is a finding,
  never a skip.

A finding at a line of the port's code honours a ``# graftlint:
disable=<rule> (reason)`` comment there; every rule honours the entry's
``suppress`` set.  Findings go through the same fingerprint, baseline
and ratchet machinery as tier 1.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    Finding,
    assign_fingerprints,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
    ENTRY_POINTS,
    EntryPoint,
    Traceable,
    build_traceable,
)

SEMANTIC_RULES: dict[str, str] = {
    "recompile-per-shape": (
        "shape matrix produces more distinct leaf signatures than the "
        "entry's max_compiles — unpadded/unbucketed shapes reach the step "
        "(a plan build and an allocator size each)"
    ),
    "implicit-promotion": (
        "a 64-bit value in a step traced from pinned float32/int32 inputs "
        "— an unpinned constructor or a widening doubles the bytes the "
        "step moves"
    ),
    "transfer-census": (
        "host reads and host-bound moves per traced step exceed the "
        "entry's transfer budget — a step must not wait on the host"
    ),
    "sharding-axis": (
        "collective mesh axes outside the entry's declared axes, or more "
        "collectives per step than its collective budget"
    ),
    "entry-point-broken": (
        "a registered entry point no longer builds or traces — the "
        "registry contract is stale"
    ),
    "collective-uniformity": (
        "a collective run after a host read of a slot-varying value in "
        "the same step — the read can steer the step, so processes can "
        "disagree about running the collective and the mesh hangs"
    ),
}

_TRACE_CACHE: dict = {}


def trace_cached(ep: EntryPoint, fn, args: tuple):
    """``trace.trace_variant(fn, args)``, once a process for each entry,
    callable and signature: ``--tier all`` traces for tiers 2 and 3 alike.
    Failures are not cached."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import trace as tr

    key = (ep, id(fn), tr.signature(args))
    hit = _TRACE_CACHE.get(key)
    if hit is None:
        hit = _TRACE_CACHE[key] = (fn, tr.trace_variant(fn, args))
    return hit[1]


def distinct_variants(t: Traceable) -> dict:
    """signature -> the first (label, args) variant with it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import trace as tr

    sigs: dict = {}
    for label, args in t.variants:
        sigs.setdefault(tr.signature(args), (label, args))
    return sigs


class _Sink:
    """Collects one entry's findings, at its anchor or at a line of the
    port's code, honouring the entry's ``suppress`` set and the inline
    suppressions at that line."""

    def __init__(self, ep: EntryPoint, root: Path):
        self.ep, self.root = ep, root
        self.findings: list[Finding] = []
        self.advisories: list[Finding] = []
        self.t: Traceable | None = None

    def add(self, rule: str, message: str, at: tuple | None = None,
            advisory: bool = False) -> None:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import trace as tr

        if rule in self.ep.suppress:
            return
        if at is not None:
            path, line = at[0], at[1]
            if suppressed(self.root, path, line, rule):
                return
            snippet = tr.source_line(self.root, path, line)
        else:
            anchor = None if self.t is None else (self.t.anchor or self.t.fn)
            path, line, snippet = tr.anchor_location(self.ep.module, anchor, self.root)
        f = Finding(rule=rule, path=path, line=line, col=0,
                    message=f"[{self.ep.name}] {message}", snippet=snippet)
        (self.advisories if advisory else self.findings).append(f)


_CONTEXTS: dict = {}


def suppressed(root: Path, path: str, line: int, rule: str) -> bool:
    """Whether ``path:line`` carries ``# graftlint: disable=<rule>``."""
    import ast

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.context import FileContext

    key = (str(root), path)
    if key not in _CONTEXTS:
        try:
            source = (root / path).read_text(encoding="utf-8")
            _CONTEXTS[key] = FileContext(path, source, ast.parse(source), root=root)
        except (OSError, SyntaxError, ValueError):
            _CONTEXTS[key] = None
    ctx = _CONTEXTS[key]
    return ctx is not None and ctx.is_suppressed(rule, line)


def _where(location) -> str:
    return f"{location[0]}:{location[1]}" if location else "?"


def sixty_four_bit(dtype) -> bool:
    return getattr(dtype, "itemsize", 0) == 8


def _analyze_entry(ep: EntryPoint, root: Path) -> list[Finding]:
    sink = _Sink(ep, root)
    try:
        t = build_traceable(ep)
    except Exception as exc:  # registry drifted from the code
        sink.add("entry-point-broken",
                 f"entry point failed to build: {type(exc).__name__}: {exc}")
        return sink.findings
    sink.t = t

    # ---- recompile-per-shape: distinct signatures across the matrix
    sigs = distinct_variants(t)
    if len(sigs) > ep.max_compiles:
        labels = sorted(label for label, _ in sigs.values())
        sink.add("recompile-per-shape",
                 f"{len(t.variants)} declared workload shapes produce {len(sigs)} distinct "
                 f"leaf signatures (budget {ep.max_compiles}): {', '.join(labels)} — "
                 "pad/bucket the shapes feeding this entry point")

    # ---- one trace per distinct signature; pool the step-level checks
    promo: dict = {}  # (path, def line) or None -> {"op:dtype@line"}
    worst_reads = {"n": 0, "label": "", "at": None, "stopped": None}
    worst_comms: tuple = (0, "")
    comm_counts: dict = {}
    undeclared: set = set()
    divergent: dict = {}  # collective name -> (label, location)
    for label, args in sigs.values():
        try:
            tr = trace_cached(ep, t.fn, args)
        except Exception as exc:
            sink.add("entry-point-broken",
                     f"tracing variant {label!r} failed: {type(exc).__name__}: {exc}")
            return sink.findings

        if not ep.allow_64bit:
            for shape, dtype, _dev in tr.constants:
                if sixty_four_bit(dtype):
                    promo.setdefault(None, set()).add(f"constant:{str(dtype)[6:]}")
            for node in tr.nodes:
                if node.is_view or node.is_kernel or not node.namespace:
                    continue
                for _shape, dtype, _dev in node.outputs:
                    if sixty_four_bit(dtype):
                        loc = node.location
                        key = None if loc is None else (loc[0], loc[2])
                        at = "" if loc is None else f"@{loc[1]}"
                        promo.setdefault(key, set()).add(f"{node.name}:{str(dtype)[6:]}{at}")

        reads = [r for r in tr.transfers()
                 if r.location is None
                 or not suppressed(root, r.location[0], r.location[1], "transfer-census")]
        if len(reads) > worst_reads["n"]:
            worst_reads = {"n": len(reads), "label": label, "stopped": tr.stopped,
                           "at": reads[0].location if reads else None}

        comms = 0
        for c in tr.collectives:
            if c.axis not in ep.axes:
                undeclared.add(str(c.axis))
            comms += c.count
            comm_counts[c.name] = comm_counts.get(c.name, 0) + c.count
            if ep.axes and c.after_varying_read:
                divergent.setdefault(c.name, (label, c.location))
        if comms > worst_comms[0]:
            worst_comms = (comms, label)

    for key, ops in sorted(promo.items(), key=lambda kv: kv[0] or ("", 0)):
        sink.add("implicit-promotion",
                 f"64-bit values in a step traced from pinned 32-bit inputs: "
                 f"{', '.join(sorted(ops))} — pin dtypes (int32/float32) where these "
                 "values are made, or suppress with the reason they must be 64-bit",
                 at=key)

    if worst_reads["n"] > ep.transfer_budget:
        stop = f"; the trace stopped: {worst_reads['stopped']}" if worst_reads["stopped"] else ""
        sink.add("transfer-census",
                 f"{worst_reads['n']} host read(s) per step in variant "
                 f"{worst_reads['label']!r} (budget {ep.transfer_budget}), the first at "
                 f"{_where(worst_reads['at'])}{stop} — a step must not wait on the host; "
                 "hoist the read out of the step or raise the budget with a review",
                 at=worst_reads["at"])

    if undeclared:
        sink.add("sharding-axis",
                 f"collective axis name(s) {sorted(undeclared)} not in the declared mesh "
                 f"axes {list(ep.axes)} — the program and the registry disagree about the "
                 "mesh contract")
    for name, (label, location) in sorted(divergent.items()):
        sink.add("collective-uniformity",
                 f"{name} at {_where(location)} runs after a host read of a slot-varying "
                 f"value in the same step (variant {label!r}) — processes can disagree about "
                 "running it and the mesh hangs. Hoist the collective out of the branch or "
                 "loop, or read a value the slots share (reduce it with psum/pmax first)",
                 at=location)
    if ep.collective_budget is not None and worst_comms[0] > ep.collective_budget:
        detail = ", ".join(f"{k}×{v}" for k, v in sorted(comm_counts.items()))
        sink.add("sharding-axis",
                 f"{worst_comms[0]} collective(s) per step in variant {worst_comms[1]!r} "
                 f"(budget {ep.collective_budget}; {detail}) — extra collectives entered "
                 "the step; fuse or re-budget with a review")
    return sink.findings


def run_semantic(
    root: Path | None = None,
    entries: Sequence[EntryPoint] | None = None,
    only_modules: set[str] | None = None,
) -> list[Finding]:
    """Trace and check registered entry points; returns fingerprinted
    findings (empty list == tier 2 clean).

    ``only_modules`` (repo-relative paths) restricts the run to entries
    whose contracted module — or any module on its ``watch`` list — is in
    the set: the ``--changed-only`` fast path.  When an ``analysis/`` file
    changed, pass None: the checker itself changed, so every contract is
    re-verified."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import repo_root

    root = root or repo_root()
    findings: list[Finding] = []
    for ep in entries if entries is not None else ENTRY_POINTS:
        if only_modules is not None and not ({ep.module, *ep.watch} & only_modules):
            continue
        findings.extend(_analyze_entry(ep, root))
    return assign_fingerprints(findings)
