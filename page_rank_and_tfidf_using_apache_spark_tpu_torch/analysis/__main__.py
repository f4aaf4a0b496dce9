"""The port's static-analysis CLI.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis \
        [paths...] [--tier 1|2|3|4|5|6|all] [--changed-only [BASE]] [--json] \
        [--baseline FILE | --no-baseline] [--write-baseline] \
        [--cost-report] [--profile-report] [--lock-graph] [--crash-points] \
        [--wire-probes] [--list-rules] [--list-entry-points]

The JAX package's CLI over the port's code and contracts, every tier.
Tier 1 is the lexical AST rule set.  Tier 2 traces one step of each
registered entry point (``analysis/registry.py ENTRY_POINTS``) with
``make_fx`` on fake tensors on the card's device, on the CPU, and checks
the trace: distinct shapes, 64-bit values, host reads, collectives.  Tier
3 is the static cost model over the same traces (FLOP/byte intensity
floors, advisory while the port's cost artifact is not gpu-stamped; the
pad_frac budgets of the partition and padding plans; the in-place
contract against the step's writes) and the tuned-profile contract
(``--profile-report``).  Tier 4 is the interprocedural concurrency &
buffer-lifetime analyzer (``--lock-graph`` emits its lock-acquisition
graph as DOT, JSON under ``--json``); tier 5 the persistence &
crash-consistency analyzer (``--crash-points`` prints every write
boundary of the declared commit sequences, what
``tools/crash_harness.py`` replays with SIGKILLs); tier 6 the
wire-protocol analyzer (``--wire-probes`` prints the declared message
space, what ``tools/protocol_harness.py`` replays at a live replica).
Tiers 1, 4, 5 and 6 and the profile half of tier 3 are stdlib-only: they
never import the code they scan, torch included; tiers 2 and 3's traces
import torch.  Tier-3 advisories are printed but never gate.

With no paths, tiers 1/4/5 scan the default surface (the package and the
root ``chip_smoke.py``), tiers 2/3 cover every registered entry point, and
tier 6 models the declared wire surface.  With explicit paths (or
``--changed-only``), tier 1 scans those files, tiers 2/3 run only the
entries whose module or ``watch`` list is among them, and tiers 4/5/6
still model the whole surface but report only findings in those files —
unless an ``analysis/`` file itself changed, which re-verifies every
contract.  ``--tier all`` prints the tiers it ran.

Exit codes: 0 = no findings beyond the ratchet baseline, 1 = new findings
(printed), 2 = bad invocation, or a trace-based tier that could not run
(torch missing).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import engine
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    render_human,
    render_json,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.rules import RULES

TIERS = ("1", "2", "3", "4", "5", "6")


def _relpaths(paths, root: Path) -> set[str]:
    out: set[str] = set()
    for f in engine.iter_python_files(paths):
        try:
            out.add(f.resolve().relative_to(root.resolve()).as_posix())
        except ValueError:
            out.add(f.as_posix())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="graftlint", description=__doc__)
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to scan (default: package + chip_smoke.py)")
    ap.add_argument("--tier", choices=("1", "2", "3", "4", "5", "6", "all"),
                    default="all",
                    help="1 = lexical rules, 2 = trace-level checks of the "
                         "entry points, 3 = static cost model (intensity/"
                         "pad_frac/in-place) and the tuned-profile contract, "
                         "4 = interprocedural concurrency & buffer-lifetime "
                         "analysis, 5 = persistence & crash-consistency "
                         "analysis, 6 = distributed wire-protocol analysis, "
                         "all = every tier (default)")
    ap.add_argument("--cost-report", action="store_true",
                    help="print the tier-3 per-entry cost table as JSON "
                         "(implies the tier-3 analysis ran)")
    ap.add_argument("--profile-report", action="store_true",
                    help="print the tier-3 autotuning report as JSON — "
                         "declared domain vs tuned value vs hand-picked "
                         "default, per knob per backend (implies the "
                         "tier-3 analysis ran)")
    ap.add_argument("--lock-graph", action="store_true",
                    help="emit the tier-4 lock-acquisition graph as DOT "
                         "(embedded as JSON under --json); implies the "
                         "tier-4 analysis ran")
    ap.add_argument("--crash-points", action="store_true",
                    help="print the tier-5 crash-point enumeration (every "
                         "write boundary of the declared commit sequences) "
                         "as JSON; implies the tier-5 analysis ran")
    ap.add_argument("--wire-probes", action="store_true",
                    help="print the tier-6 message-space enumeration "
                         "(every malformed/out-of-contract/duplicate/"
                         "stale-floor probe the conformance harness "
                         "replays) as JSON; implies the tier-6 analysis "
                         "ran")
    ap.add_argument("--changed-only", nargs="?", const="HEAD", default=None,
                    metavar="BASE",
                    help="lint only files changed vs BASE (default HEAD): "
                         "git worktree diff plus untracked files")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="ratchet file (default: analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the ratchet; report every finding and fail on any")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze current findings into the baseline file "
                         "(new entries get an UNREVIEWED placeholder "
                         "justification you must edit)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--list-entry-points", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.id:22s} [tier 1] {rule.summary}")
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.concurrency import (
            CONC_RULES,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.persistence import (
            PERSIST_RULES,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.profile import (
            PROFILE_RULES,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.protocol import (
            PROTO_RULES,
        )

        # the trace tiers import torch only when they trace
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.cost import COST_RULES
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.semantic import (
            SEMANTIC_RULES,
        )

        for rid, summary in SEMANTIC_RULES.items():
            print(f"{rid:22s} [tier 2] {summary}")
        for rid, summary in COST_RULES.items():
            print(f"{rid:22s} [tier 3] {summary}")
        for rid, summary in PROFILE_RULES.items():
            print(f"{rid:22s} [tier 3] {summary}")
        for rid, summary in CONC_RULES.items():
            print(f"{rid:22s} [tier 4] {summary}")
        for rid, summary in PERSIST_RULES.items():
            print(f"{rid:22s} [tier 5] {summary}")
        for rid, summary in PROTO_RULES.items():
            print(f"{rid:22s} [tier 6] {summary}")
        return 0

    if args.list_entry_points:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
            ENTRY_POINTS,
        )

        for ep in ENTRY_POINTS:
            axes = f" axes={list(ep.axes)}" if ep.axes else ""
            print(f"{ep.name:32s} {ep.module}{axes} max_compiles={ep.max_compiles} "
                  f"transfer_budget={ep.transfer_budget}")
        return 0

    root = engine.repo_root()
    tier1 = args.tier in ("1", "all")
    tier2 = args.tier in ("2", "all")
    tier3 = args.tier in ("3", "all") or args.cost_report or args.profile_report
    tier4 = args.tier in ("4", "all") or args.lock_graph
    tier5 = args.tier in ("5", "all") or args.crash_points
    tier6 = args.tier in ("6", "all") or args.wire_probes

    if args.changed_only is not None and args.paths:
        print("graftlint: give either paths or --changed-only, not both",
              file=sys.stderr)
        return 2

    restricted = False  # True when scanning a subset of the surface
    if args.changed_only is not None:
        try:
            changed = engine.changed_python_files(root, args.changed_only)
        except RuntimeError as exc:
            print(f"graftlint: {exc}", file=sys.stderr)
            return 2
        surface = set(engine.iter_python_files(engine.default_targets(root)))
        paths = [p for p in changed if p in surface]
        restricted = True
        if not paths:
            print("graftlint: no changed files on the lint surface — clean")
            return 0
    elif args.paths:
        missing = [p for p in args.paths if not p.exists()]
        if missing:
            print(f"graftlint: no such path: {missing[0]}", file=sys.stderr)
            return 2
        paths = list(args.paths)
        restricted = True
    else:
        paths = engine.default_targets(root)

    if args.write_baseline and args.tier != "all":
        # A single-tier write would carry over nothing for the other tier's
        # scanned files, silently deleting its justified entries.
        print("graftlint: --write-baseline requires --tier all (a partial "
              "write would wipe the other tier's baseline entries)",
              file=sys.stderr)
        return 2

    findings = engine.run_lint(paths, root) if tier1 else []

    scanned = _relpaths(paths, root)

    only_modules = None
    if restricted:
        # when the analyzer itself changed, every contract is suspect
        analyzer_changed = any(
            p.startswith(
                "page_rank_and_tfidf_using_apache_spark_tpu_torch/analysis/"
            )
            for p in scanned
        )
        only_modules = None if analyzer_changed else scanned

    def _tier_unavailable(tier: int, exc: Exception) -> int:
        # tier 1 works without torch; the trace-based tiers cannot: print
        # what tier 1 found, then fail with exit 2 ("could not check"),
        # apart from 1 ("findings")
        if findings:
            print(render_human(findings), file=sys.stderr)
        print(f"graftlint: tier {tier} unavailable ({type(exc).__name__}: {exc}); "
              "rerun with --tier 1 to lint without torch", file=sys.stderr)
        return 2

    if tier2:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import semantic

        missing = _torch_missing()
        if missing is not None:
            return _tier_unavailable(2, missing)
        sem = semantic.run_semantic(root=root, only_modules=only_modules)
        if sem:
            findings = engine.assign_fingerprints(list(findings) + sem)

    advisories: list = []
    cost_report: dict | None = None
    profile_report: dict | None = None
    if tier3:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import profile

        # the profile-contract half first: stdlib-only, so its findings
        # land even when the trace-based cost pass cannot import torch
        pres = profile.run_profile(root=root, only_modules=only_modules)
        if pres.findings:
            findings = engine.assign_fingerprints(list(findings) + pres.findings)
        profile_report = pres.report
        missing = _torch_missing()
        if missing is not None:
            return _tier_unavailable(3, missing)
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import cost

        cres = cost.run_cost(root=root, only_modules=only_modules)
        if cres.findings:
            findings = engine.assign_fingerprints(list(findings) + cres.findings)
        advisories = cres.advisories
        cost_report = cres.report

    lock_graph = None
    if tier4:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
            concurrency,
        )

        # interprocedural: always model the full surface; a restricted run
        # only filters which files may report findings
        cc = concurrency.run_concurrency(root=root, only_modules=only_modules)
        if cc.findings:
            findings = engine.assign_fingerprints(
                list(findings) + cc.findings
            )
        lock_graph = cc.graph

    crash_points = None
    if tier5:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
            persistence,
        )

        # like tier 4: always model the full surface; one model build serves
        # both the findings pass and the crash-point enumeration
        pmodels = persistence.build_models(root)
        pres = persistence.run_persistence(root=root,
                                           only_modules=only_modules,
                                           models=pmodels)
        if pres.findings:
            findings = engine.assign_fingerprints(
                list(findings) + pres.findings
            )
        if args.crash_points:
            crash_points = persistence.crash_point_report(root,
                                                          models=pmodels)

    wire_probes = None
    if tier6:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
            protocol,
        )

        # like tiers 4/5: always model the declared wire surface; one model
        # build serves both the findings pass and the probe enumeration
        wmodels = protocol.build_models(root)
        wres = protocol.run_protocol(root=root,
                                     only_modules=only_modules,
                                     models=wmodels)
        if wres.findings:
            findings = engine.assign_fingerprints(
                list(findings) + wres.findings
            )
        if args.wire_probes:
            wire_probes = protocol.enumerate_message_space(root,
                                                           models=wmodels)

    ran = [t for t, on in zip(TIERS, (tier1, tier2, tier3, tier4, tier5, tier6)) if on]
    if tier2 or tier3:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
            ENTRY_POINTS,
        )

        # tier-2/3 findings anchor in their entries' modules: include them
        # in the written-baseline scan set so --write-baseline is coherent
        scanned |= {ep.module for ep in ENTRY_POINTS
                    if only_modules is None or ({ep.module, *ep.watch} & only_modules)}
    bl_path = args.baseline or engine.baseline_path(root)

    if args.write_baseline:
        engine.write_baseline(bl_path, findings, scanned_paths=scanned)
        print(
            f"graftlint: froze {len(findings)} finding(s) over "
            f"{len(scanned)} file(s) into {bl_path} (entries for unscanned "
            "files preserved)"
        )
        return 0

    baseline = {} if args.no_baseline else engine.load_baseline(bl_path)
    result = engine.apply_ratchet(findings, baseline)
    # Staleness is only decidable on a full scan with every tier: a
    # restricted or single-tier run never re-finds entries for files (or
    # rules) it did not look at.
    stale = [] if (restricted or args.tier != "all") else result.stale

    if args.cost_report and cost_report is not None and not args.json:
        print(json.dumps(cost_report, indent=2))

    if args.profile_report and profile_report is not None and not args.json:
        print(json.dumps(profile_report, indent=2))

    if args.lock_graph and lock_graph is not None and not args.json:
        print(lock_graph.to_dot())

    if args.crash_points and crash_points is not None and not args.json:
        print(json.dumps(crash_points, indent=2))

    if args.wire_probes and wire_probes is not None and not args.json:
        print(json.dumps(wire_probes, indent=2))

    if args.json:
        extra_json: dict = {"tiers": [int(t) for t in ran]}
        if advisories:
            extra_json["advisories"] = [f.to_dict() for f in advisories]
        if args.cost_report and cost_report is not None:
            extra_json["cost_report"] = cost_report
        if args.profile_report and profile_report is not None:
            extra_json["profile_report"] = profile_report
        if args.lock_graph and lock_graph is not None:
            extra_json["lock_graph"] = lock_graph.to_json()
        if args.crash_points and crash_points is not None:
            extra_json["crash_points"] = crash_points
        if args.wire_probes and wire_probes is not None:
            extra_json["wire_probes"] = wire_probes
        print(
            render_json(
                result.new,
                known=len(result.known),
                stale=[e["fingerprint"] for e in stale],
                ok=result.ok,
                **extra_json,
            )
        )
    else:
        if args.tier == "all":
            print(f"graftlint: ran tiers {', '.join(ran)}")
        for f in advisories:
            print(f"graftlint: advisory (not gating): {f.render()}")
        if result.new:
            print(render_human(result.new))
            print(
                f"\ngraftlint: {len(result.new)} new finding(s) "
                f"({len(result.known)} baselined). Fix them, suppress with "
                "'# graftlint: disable=<rule>' (justify in review), or — "
                "outside hot paths — add to analysis/baseline.json with a "
                "justification."
            )
        else:
            print(
                f"graftlint: clean ({len(result.known)} baselined finding(s) "
                f"remain to burn down)"
            )
        for e in stale:
            print(
                f"graftlint: stale baseline entry {e['fingerprint']} "
                f"({e['rule']} at {e['path']}) — finding no longer exists; "
                "delete it from baseline.json"
            )
    return 0 if result.ok else 1


def _torch_missing() -> ImportError | None:
    """Why the trace-based tiers cannot run here, or None."""
    try:
        import torch  # noqa: F401 — the traces of tiers 2 and 3 import it
    except ImportError as exc:
        return exc
    return None


if __name__ == "__main__":
    sys.exit(main())
