"""Tier 3, active half: the autotuning profile contract of the port.

A copy of the JAX package's ``analysis/profile.py`` over the port's own
surfaces: ``analysis/registry.py TUNED_KNOBS`` declares the knob search
space (knob -> candidate domain -> affected registry entries),
``utils/config.py TUNABLE_DEFAULTS`` holds the hand-picked defaults, and
``tools/autotune.py`` commits per-backend ``tuned_profile_<backend>.json``
optima into the port's package directory, which every runner resolves
through ``utils.config.load_tuned_profile``.  It differs from the
reference in the package it names and in reading the profiles beside the
port's package, never the repository root's (the JAX package's).  Two
checks, on the shared findings/suppression/ratchet machinery:

- **profile-drift** — the committed profile artifacts vs the declared
  space, validated in both directions: a profile knob no longer declared
  (stale), a missing or mismatched backend stamp, a tuned value outside
  its declared domain, a declared knob the profile never tuned — and the
  declaration itself vs TUNABLE_DEFAULTS and the entry-point registry (a
  searchable knob with no default, a default with no search space, an
  affected entry that does not exist).
- **untuned-knob-read** — a declared tunable read from a bare literal in
  ``models//parallel//serving//dataflow/`` instead of through the
  resolution ladder: a function-signature or dataclass-field default
  spelled as a number, or a call-site keyword that re-states the default
  value literally.

Like tiers 1/4/5 this is stdlib-only — pure AST over the registry, the
config table, and the scan surface; the JSON artifacts are read with
``json`` — so the checks run first in the tier-3 block, before the
trace-based cost pass imports torch.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.concurrency import (
    _Sink,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.context import (
    FileContext,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import (
    iter_python_files,
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    assign_fingerprints,
)

PROFILE_RULES: dict[str, str] = {
    "profile-drift": (
        "a committed tuned_profile_<backend>.json drifted from the "
        "TUNED_KNOBS search-space contract (stale knob, missing/mismatched "
        "backend stamp, out-of-domain value, declared-but-untuned knob), "
        "or the contract itself drifted from TUNABLE_DEFAULTS / the "
        "entry-point registry"
    ),
    "untuned-knob-read": (
        "a declared tunable read from a bare literal in models//parallel//"
        "serving//dataflow/ — a signature/dataclass default not reading "
        "TUNABLE_DEFAULTS, or a call-site keyword duplicating the default "
        "value — so the tuned-profile resolution ladder cannot reach it"
    ),
}

_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
_REGISTRY_REL = f"{_PKG}/analysis/registry.py"
_CONFIG_REL = f"{_PKG}/utils/config.py"

# the directories whose knob reads must go through the resolution ladder
_SCAN_PREFIXES = (
    f"{_PKG}/models/",
    f"{_PKG}/parallel/",
    f"{_PKG}/serving/",
    f"{_PKG}/dataflow/",
)


# --------------------------------------------------------------------------
# the declared contract (parsed lexically, persistence.py style)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProfileContract:
    knobs: tuple  # rows (name, domain tuple of numbers, entry-name tuple)
    entry_names: frozenset  # EntryPoint(name=...) spellings in the registry
    defaults: dict  # TUNABLE_DEFAULTS: name -> number
    registry_ctx: "FileContext | None"
    config_ctx: "FileContext | None"
    knobs_line: int
    defaults_line: int


def _num(node: ast.AST) -> "int | float | None":
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _str_tuple(node: ast.AST) -> tuple:
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(
            e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        )
    return ()


def _num_tuple(node: ast.AST) -> tuple:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            v = _num(e)
            if v is not None:
                out.append(v)
        return tuple(out)
    return ()


def _load_ctx(root: Path, rel: str) -> "FileContext | None":
    path = root / rel
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError):
        return None
    return FileContext(rel, source, tree, root=root)


def _parse_registry(ctx: FileContext) -> tuple:
    """(TUNED_KNOBS rows, declaration line, EntryPoint names)."""
    rows: tuple = ()
    line = 1
    names: set[str] = set()
    for node in ast.walk(ctx.tree):
        value: "ast.expr | None" = None
        name: "str | None" = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.target, ast.Name):
            name, value = node.target.id, node.value
        if name == "TUNED_KNOBS" and isinstance(value, (ast.Tuple, ast.List)):
            line = node.lineno
            parsed = []
            for row in value.elts:
                if not isinstance(row, (ast.Tuple, ast.List)) or \
                        len(row.elts) != 3:
                    continue
                knob = row.elts[0]
                if not (isinstance(knob, ast.Constant)
                        and isinstance(knob.value, str)):
                    continue
                parsed.append((knob.value,
                               _num_tuple(row.elts[1]),
                               _str_tuple(row.elts[2])))
            rows = tuple(parsed)
        if isinstance(node, ast.Call):
            fn = node.func
            leaf = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if leaf == "EntryPoint":
                for kw in node.keywords:
                    if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str):
                        names.add(kw.value.value)
    return rows, line, frozenset(names)


def _parse_defaults(ctx: FileContext) -> tuple:
    """(TUNABLE_DEFAULTS mapping, declaration line)."""
    table: dict = {}
    line = 1
    for node in ast.walk(ctx.tree):
        value: "ast.expr | None" = None
        name: "str | None" = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.target, ast.Name):
            name, value = node.target.id, node.value
        if name == "TUNABLE_DEFAULTS" and isinstance(value, ast.Dict):
            line = node.lineno
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    num = _num(v)
                    if num is not None:
                        table[k.value] = num
    return table, line


_contract_cache: dict[str, "ProfileContract | None"] = {}


def profile_contract(root: Path) -> "ProfileContract | None":
    key = str(root)
    if key in _contract_cache:
        return _contract_cache[key]
    reg_ctx = _load_ctx(root, _REGISTRY_REL)
    cfg_ctx = _load_ctx(root, _CONFIG_REL)
    contract = None
    if reg_ctx is not None and cfg_ctx is not None:
        knobs, knobs_line, entry_names = _parse_registry(reg_ctx)
        defaults, defaults_line = _parse_defaults(cfg_ctx)
        if knobs or defaults:
            contract = ProfileContract(
                knobs=knobs, entry_names=entry_names, defaults=defaults,
                registry_ctx=reg_ctx, config_ctx=cfg_ctx,
                knobs_line=knobs_line, defaults_line=defaults_line,
            )
    _contract_cache[key] = contract
    return contract


# --------------------------------------------------------------------------
# committed profile artifacts
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProfileArtifact:
    relpath: str  # e.g. "page_rank_and_tfidf_using_apache_spark_tpu_torch/tuned_profile_gpu.json"
    backend: str  # backend named by the FILENAME
    record: "dict | None"  # parsed JSON (None: unreadable)
    error: "str | None"


def discover_profiles(root: Path) -> list[ProfileArtifact]:
    out = []
    for path in sorted((root / _PKG).glob("tuned_profile_*.json")):
        backend = path.stem[len("tuned_profile_"):]
        record: "dict | None" = None
        error: "str | None" = None
        try:
            parsed = json.loads(path.read_text(encoding="utf-8"))
            if isinstance(parsed, dict):
                record = parsed
            else:
                error = "top-level JSON value is not an object"
        except (OSError, json.JSONDecodeError) as exc:
            error = str(exc)
        out.append(ProfileArtifact(relpath=f"{_PKG}/{path.name}", backend=backend,
                                   record=record, error=error))
    return out


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------


def _check_contract(contract: ProfileContract, sink: _Sink) -> None:
    """TUNED_KNOBS vs TUNABLE_DEFAULTS vs ENTRY_POINTS, both directions."""
    ctx = contract.registry_ctx
    if ctx is None:
        return
    seen: set[str] = set()
    for knob, domain, entries in contract.knobs:
        if knob in seen:
            sink.add(ctx, "profile-drift", None,
                     f"TUNED_KNOBS declares {knob!r} twice",
                     line=contract.knobs_line)
        seen.add(knob)
        if knob not in contract.defaults:
            sink.add(ctx, "profile-drift", None,
                     f"TUNED_KNOBS declares {knob!r} but utils/config.py "
                     "TUNABLE_DEFAULTS has no such default — the search "
                     "space and the fallback ladder drifted apart",
                     line=contract.knobs_line)
        if not domain:
            sink.add(ctx, "profile-drift", None,
                     f"TUNED_KNOBS declares {knob!r} with an empty (or "
                     "non-numeric) candidate domain",
                     line=contract.knobs_line)
        if not entries:
            sink.add(ctx, "profile-drift", None,
                     f"TUNED_KNOBS declares {knob!r} with no affected "
                     "registry entries — nothing prunes or scores it",
                     line=contract.knobs_line)
        for entry in entries:
            if contract.entry_names and entry not in contract.entry_names:
                sink.add(ctx, "profile-drift", None,
                         f"TUNED_KNOBS maps {knob!r} to registry entry "
                         f"{entry!r}, which ENTRY_POINTS does not define",
                         line=contract.knobs_line)
    cfg_ctx = contract.config_ctx
    if cfg_ctx is not None:
        for name in contract.defaults:
            if name not in seen:
                sink.add(cfg_ctx, "profile-drift", None,
                         f"TUNABLE_DEFAULTS entry {name!r} has no "
                         "TUNED_KNOBS row — a tunable with no declared "
                         "search space can never be re-tuned",
                         line=contract.defaults_line)


def _check_profile(contract: ProfileContract, prof: ProfileArtifact,
                   sink: _Sink) -> None:
    """One committed artifact vs the declared space."""
    ctx = contract.registry_ctx
    if ctx is None:
        return
    if prof.record is None:
        sink.add(ctx, "profile-drift", None,
                 f"{prof.relpath}: unreadable profile artifact "
                 f"({prof.error})",
                 path=prof.relpath, line=1)
        return
    stamped = prof.record.get("backend")
    if stamped is None:
        sink.add(ctx, "profile-drift", None,
                 f"{prof.relpath}: missing backend stamp — the provenance "
                 "guard cannot protect an unstamped artifact",
                 path=prof.relpath, line=1)
    elif str(stamped) != prof.backend:
        sink.add(ctx, "profile-drift", None,
                 f"{prof.relpath}: stamped backend {stamped!r} does not "
                 f"match the filename backend {prof.backend!r}",
                 path=prof.relpath, line=1)
    knobs = prof.record.get("knobs")
    if not isinstance(knobs, dict):
        sink.add(ctx, "profile-drift", None,
                 f"{prof.relpath}: no 'knobs' mapping",
                 path=prof.relpath, line=1)
        return
    declared = {row[0]: row[1] for row in contract.knobs}
    for name, value in sorted(knobs.items()):
        if name not in declared:
            sink.add(ctx, "profile-drift", None,
                     f"{prof.relpath}: stale knob {name!r} — not declared "
                     "in TUNED_KNOBS (remove it or re-declare the knob)",
                     path=prof.relpath, line=1)
            continue
        domain = declared[name]
        default = contract.defaults.get(name)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            sink.add(ctx, "profile-drift", None,
                     f"{prof.relpath}: knob {name!r} value {value!r} is "
                     "not a number",
                     path=prof.relpath, line=1)
        elif value not in domain and value != default:
            sink.add(ctx, "profile-drift", None,
                     f"{prof.relpath}: knob {name!r}={value!r} is outside "
                     f"its declared domain {list(domain)!r} (and is not "
                     "the TUNABLE_DEFAULTS value) — domain mismatch",
                     path=prof.relpath, line=1)
    for name in declared:
        if name not in knobs:
            sink.add(ctx, "profile-drift", None,
                     f"{prof.relpath}: declared tunable {name!r} is "
                     "untuned (absent from the profile) — the tuner "
                     "writes every declared knob, so an absence means "
                     "the artifact predates the declaration",
                     path=prof.relpath, line=1)


def _iter_defaults(fn: ast.AST):
    """(param name, default expr) pairs of a function definition."""
    args = fn.args
    pos = list(getattr(args, "posonlyargs", [])) + list(args.args)
    for param, default in zip(pos[len(pos) - len(args.defaults):],
                              args.defaults):
        yield param.arg, default
    for param, default in zip(args.kwonlyargs, args.kw_defaults):
        if default is not None:
            yield param.arg, default


def _check_knob_reads(contract: ProfileContract, ctx: FileContext,
                      sink: _Sink) -> None:
    """untuned-knob-read over one scanned file."""
    knob_names = set(contract.defaults) | {row[0] for row in contract.knobs}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for name, default in _iter_defaults(node):
                if name in knob_names and _num(default) is not None:
                    sink.add(
                        ctx, "untuned-knob-read", default,
                        f"tunable {name!r} defaults to the bare literal "
                        f"{_num(default)!r} here — read utils/config."
                        "TUNABLE_DEFAULTS (and resolve runs through "
                        "load_tuned_profile/tuned_config) so the default "
                        "cannot drift and a tuned profile can reach it",
                    )
        elif isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name) and \
                        stmt.target.id in knob_names and \
                        stmt.value is not None and \
                        _num(stmt.value) is not None:
                    sink.add(
                        ctx, "untuned-knob-read", stmt.value,
                        f"tunable field {stmt.target.id!r} defaults to the "
                        f"bare literal {_num(stmt.value)!r} — read "
                        "utils/config.TUNABLE_DEFAULTS so the dataclass "
                        "default and the tuner's table cannot drift",
                    )
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in knob_names:
                    val = _num(kw.value)
                    if val is not None and \
                            val == contract.defaults.get(kw.arg):
                        sink.add(
                            ctx, "untuned-knob-read", kw.value,
                            f"call re-states tunable {kw.arg!r}="
                            f"{val!r}, duplicating its TUNABLE_DEFAULTS "
                            "value as a literal — read the table (or omit "
                            "the argument) so a re-tune reaches this site",
                        )


# --------------------------------------------------------------------------
# report + runner
# --------------------------------------------------------------------------


def build_report(contract: "ProfileContract | None",
                 profiles: list[ProfileArtifact]) -> dict:
    """Declared-vs-tuned-vs-default, per knob per backend — what
    ``--profile-report`` renders."""
    if contract is None:
        return {}
    tuned: dict = {}
    meta: dict = {}
    for prof in profiles:
        knobs = (prof.record or {}).get("knobs")
        tuned[prof.backend] = knobs if isinstance(knobs, dict) else {}
        meta[prof.backend] = {
            "path": prof.relpath,
            "git_sha": (prof.record or {}).get("git_sha"),
            "created_wall": (prof.record or {}).get("created_wall"),
            "error": prof.error,
        }
    knob_rows = {}
    for knob, domain, entries in contract.knobs:
        knob_rows[knob] = {
            "default": contract.defaults.get(knob),
            "domain": list(domain),
            "entries": list(entries),
            "tuned": {b: tuned[b].get(knob) for b in sorted(tuned)},
        }
    return {"knobs": knob_rows, "profiles": meta}


@dataclasses.dataclass
class ProfileResult:
    findings: list
    report: dict

    @property
    def ok(self) -> bool:
        return not self.findings


def run_profile(
    root: "Path | None" = None,
    paths: "list[Path] | None" = None,
    only_modules: "set[str] | None" = None,
    contract: "ProfileContract | None" = None,
    profiles: "list[ProfileArtifact] | None" = None,
) -> ProfileResult:
    """Run the tier-3 profile-contract checks.

    Like tiers 4/5 the contract is always validated whole — a restricted
    run (``only_modules``) only filters which files may report findings.
    ``contract``/``profiles`` injection exists for synthetic-fixture
    tests."""
    root = root or repo_root()
    if contract is None:
        contract = profile_contract(root)
    if contract is None:
        return ProfileResult(findings=[], report={})
    if profiles is None:
        profiles = discover_profiles(root)

    sink = _Sink()
    _check_contract(contract, sink)
    for prof in profiles:
        _check_profile(contract, prof, sink)

    targets = paths if paths is not None else [root / _PKG]
    for f in iter_python_files(targets):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        if not rel.startswith(_SCAN_PREFIXES):
            continue
        ctx = _load_ctx(root, rel)
        if ctx is not None:
            _check_knob_reads(contract, ctx, sink)

    findings = sink.findings
    if only_modules is not None:
        findings = [f for f in findings if f.path in only_modules]
    return ProfileResult(findings=assign_fingerprints(findings),
                         report=build_report(contract, profiles))
