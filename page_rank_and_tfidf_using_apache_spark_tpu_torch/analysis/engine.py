"""The port's linter engine: file discovery, rule dispatch, ratchet baseline.

A copy of the JAX package's ``analysis/engine.py``; it differs in the scan
surface (:func:`default_targets`: this package, its own ``tools/``
included, and the root ``chip_smoke.py``, the one script that times the
port) and in skipping ``_build/``, the kernels' build directory.

The ratchet contract: ``analysis/baseline.json`` freezes the
findings that existed when a rule landed, each with a one-line
justification.  A lint run fails (exit 1) only on findings *not* in the
baseline, so the count can only ratchet down: fixing code lets baseline
entries be deleted; new violations can never ship silently.  Stale
baseline entries (fixed code) are reported so they get pruned.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Iterable, Sequence

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.context import FileContext
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    Finding,
    assign_fingerprints,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.rules import RULES

# Directories never worth scanning.
_SKIP_DIRS = {"__pycache__", ".git", "build", ".pytest_cache", "node_modules",
              "_build"}


def repo_root() -> Path:
    """The repository root: parent of the installed package directory."""
    return Path(__file__).resolve().parents[2]


def default_targets(root: Path | None = None) -> list[Path]:
    """The tier-1 scan surface: the package (its tools/ included) and the
    root chip_smoke.py, the port's counterpart of bench.py."""
    root = root or repo_root()
    targets = [root / "page_rank_and_tfidf_using_apache_spark_tpu_torch"]
    smoke = root / "chip_smoke.py"
    if smoke.exists():
        targets.append(smoke)
    return targets


def iter_python_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    yield f


def changed_python_files(root: Path, base: str = "HEAD") -> list[Path]:
    """Python files changed vs ``base`` (worktree diff + untracked), for
    ``--changed-only``.  Raises ``RuntimeError`` when git cannot answer —
    the caller should fall back to a full scan, never silently lint
    nothing."""
    import subprocess

    names: set[str] = set()
    for cmd in (
        ["git", "-C", str(root), "diff", "--name-only", base, "--"],
        ["git", "-C", str(root), "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"git failed ({' '.join(cmd)}): {proc.stderr.strip()}"
            )
        names.update(n for n in proc.stdout.splitlines() if n.endswith(".py"))
    return sorted(root / n for n in names if (root / n).exists())


def lint_file(path: Path, root: Path) -> list[Finding]:
    source = path.read_text(encoding="utf-8")
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        return [
            Finding(
                rule="parse-error",
                path=rel,
                line=exc.lineno or 1,
                col=(exc.offset or 1) - 1,
                message=f"file does not parse: {exc.msg}",
                snippet="",
            )
        ]

    ctx = FileContext(rel, source, tree, root=root)
    findings: list[Finding] = []
    for rule in RULES.values():
        for node, message in rule.check(ctx):
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
            if ctx.is_suppressed(rule.id, line):
                continue
            findings.append(
                Finding(
                    rule=rule.id,
                    path=rel,
                    line=line,
                    col=col,
                    message=message,
                    snippet=ctx.snippet(line),
                )
            )
    return findings


def run_lint(paths: Sequence[Path], root: Path | None = None) -> list[Finding]:
    root = root or repo_root()
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f, root))
    return assign_fingerprints(findings)


# ----------------------------------------------------------------- baseline


@dataclasses.dataclass
class RatchetResult:
    new: list[Finding]
    known: list[Finding]
    stale: list[dict]  # baseline entries whose finding no longer exists

    @property
    def ok(self) -> bool:
        return not self.new


def baseline_path(root: Path | None = None) -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Path) -> dict[str, dict]:
    """fingerprint -> entry.  Missing file means an empty baseline."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    entries = data.get("entries", [])
    return {e["fingerprint"]: e for e in entries}


def apply_ratchet(findings: list[Finding], baseline: dict[str, dict]) -> RatchetResult:
    new: list[Finding] = []
    known: list[Finding] = []
    seen: set[str] = set()
    for f in findings:
        if f.fingerprint in baseline:
            known.append(f)
            seen.add(f.fingerprint)
        else:
            new.append(f)
    stale = [e for fp, e in baseline.items() if fp not in seen]
    return RatchetResult(new=new, known=known, stale=stale)


def write_baseline(
    path: Path,
    findings: list[Finding],
    justifications: dict[str, str] | None = None,
    scanned_paths: set[str] | None = None,
) -> None:
    """Write/refresh the ratchet file.  Re-uses justifications from an
    existing baseline for unchanged fingerprints; new entries get a
    placeholder that code review is expected to replace.

    ``scanned_paths`` (repo-relative) limits the refresh to files this run
    actually analyzed: existing entries for *other* files are carried over
    untouched, so a partial ``--write-baseline some_file.py`` cannot wipe
    the rest of the ratchet."""
    old = load_baseline(path)
    justifications = justifications or {}
    entries = []
    if scanned_paths is not None:
        entries.extend(
            e for e in old.values() if e.get("path") not in scanned_paths
        )
    for f in findings:
        just = (
            justifications.get(f.fingerprint)
            or old.get(f.fingerprint, {}).get("justification")
            or "UNREVIEWED — replace with a one-line justification"
        )
        entries.append(
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "path": f.path,
                "line": f.line,
                "snippet": f.snippet,
                "justification": just,
            }
        )
    doc = {
        "version": 1,
        "comment": (
            "graftlint ratchet baseline: pre-existing findings frozen with "
            "justifications. New findings FAIL lint. Fix code -> delete the "
            "entry. Never add entries for ops/ or parallel/ without a "
            "reviewed justification."
        ),
        "entries": entries,
    }
    path.write_text(json.dumps(doc, indent=2) + "\n")
