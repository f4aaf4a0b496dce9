"""The port's static-analysis CLI.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis \
        [paths...] [--tier 1|4|5|6|all] [--changed-only [BASE]] [--json] \
        [--baseline FILE | --no-baseline] [--write-baseline] \
        [--lock-graph] [--crash-points] [--wire-probes] [--list-rules]

The JAX package's CLI over the port's code and contracts, for the four
tiers that read no trace.  Tier 1 is the lexical AST rule set; tier 4 the
interprocedural concurrency & buffer-lifetime analyzer (``--lock-graph``
emits its lock-acquisition graph as DOT, JSON under ``--json``); tier 5
the persistence & crash-consistency analyzer (``--crash-points`` prints
every write boundary of the declared commit sequences, what
``tools/crash_harness.py`` replays with SIGKILLs); tier 6 the wire-protocol
analyzer (``--wire-probes`` prints the declared message space, what
``tools/protocol_harness.py`` replays at a live replica).  All four are
stdlib-only: they never import the code they scan, torch included.  The
reference's trace-based tiers 2 and 3 (``--tier 2``/``3``,
``--cost-report``, ``--profile-report``, ``--list-entry-points``) are not
ported yet (ROADMAP item 15b): asking for them exits 2.

With no paths, every tier scans the default surface (the package and the
root ``chip_smoke.py``), and tier 6 models the declared wire surface.
With explicit paths (or ``--changed-only``), tier 1 scans those files and
tiers 4/5/6 still model the whole surface but report only findings in
those files — unless an ``analysis/`` file itself changed, which
re-verifies every contract.  ``--tier all`` prints the tiers it ran.

Exit codes: 0 = no findings beyond the ratchet baseline, 1 = new findings
(printed), 2 = bad invocation or a tier that is not ported.
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

PORTED_TIERS = ("1", "4", "5", "6")
_NOT_PORTED = (
    "the trace-based tiers 2 and 3 (semantic, cost, profile) are not ported "
    "to the PyTorch package yet (ROADMAP item 15b)"
)


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
                    help="1 = lexical rules, 4 = interprocedural concurrency "
                         "& buffer-lifetime analysis, 5 = persistence & "
                         "crash-consistency analysis, 6 = distributed "
                         "wire-protocol analysis, all = every ported tier "
                         "(default); 2 and 3 are not ported and exit 2")
    ap.add_argument("--cost-report", action="store_true",
                    help="not ported (tier 3): exits 2")
    ap.add_argument("--profile-report", action="store_true",
                    help="not ported (tier 3): exits 2")
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
    ap.add_argument("--list-entry-points", action="store_true",
                    help="not ported (tiers 2/3): exits 2")
    args = ap.parse_args(argv)

    refused = [flag for flag, asked in (
        (f"--tier {args.tier}", args.tier in ("2", "3")),
        ("--cost-report", args.cost_report),
        ("--profile-report", args.profile_report),
        ("--list-entry-points", args.list_entry_points),
    ) if asked]
    if refused:
        print(f"graftlint: {', '.join(refused)}: {_NOT_PORTED}",
              file=sys.stderr)
        return 2

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.id:22s} [tier 1] {rule.summary}")
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.concurrency import (
            CONC_RULES,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.persistence import (
            PERSIST_RULES,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.protocol import (
            PROTO_RULES,
        )

        for rid, summary in CONC_RULES.items():
            print(f"{rid:22s} [tier 4] {summary}")
        for rid, summary in PERSIST_RULES.items():
            print(f"{rid:22s} [tier 5] {summary}")
        for rid, summary in PROTO_RULES.items():
            print(f"{rid:22s} [tier 6] {summary}")
        return 0

    root = engine.repo_root()
    tier1 = args.tier in ("1", "all")
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

    ran = [t for t, on in zip(PORTED_TIERS, (tier1, tier4, tier5, tier6)) if on]
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

    if args.lock_graph and lock_graph is not None and not args.json:
        print(lock_graph.to_dot())

    if args.crash_points and crash_points is not None and not args.json:
        print(json.dumps(crash_points, indent=2))

    if args.wire_probes and wire_probes is not None and not args.json:
        print(json.dumps(wire_probes, indent=2))

    if args.json:
        extra_json: dict = {"tiers": [int(t) for t in ran]}
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
            print(f"graftlint: ran tiers {', '.join(ran)} (tiers 2 and 3 "
                  "are not ported: ROADMAP item 15b)")
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


if __name__ == "__main__":
    sys.exit(main())
