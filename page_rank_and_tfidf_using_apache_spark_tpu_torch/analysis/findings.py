"""Finding data model for the port's linter (a copy of the JAX package's
``analysis/findings.py``).

A ``Finding`` is one rule violation at one source location.  Findings are
identified across commits by a *fingerprint* — a hash of (rule, path,
normalized source line, occurrence index) that is stable under pure
line-number shifts — which is what the ratchet baseline
(``analysis/baseline.json``) stores.  Everything here is stdlib-only: the
analyzer must run (and fail CI) even when torch itself is broken or absent.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Iterable


@dataclasses.dataclass
class Finding:
    """One rule violation."""

    rule: str  # rule id, e.g. "host-sync-in-loop"
    path: str  # repo-root-relative posix path
    line: int  # 1-based
    col: int  # 0-based
    message: str
    snippet: str  # stripped source line text
    fingerprint: str = ""  # assigned by assign_fingerprints()

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: [{self.rule}] {self.message}"


def _normalize(snippet: str) -> str:
    """Whitespace-insensitive form of the flagged line, so re-indenting a
    block does not invalidate baseline entries."""
    return " ".join(snippet.split())


def assign_fingerprints(findings: Iterable[Finding]) -> list[Finding]:
    """Assign stable fingerprints, disambiguating identical (rule, path,
    line-text) triples by occurrence order top-to-bottom."""
    out = sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))
    seen: dict[tuple[str, str, str], int] = {}
    for f in out:
        key = (f.rule, f.path, _normalize(f.snippet))
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        raw = "\0".join([key[0], key[1], key[2], str(idx)])
        f.fingerprint = hashlib.sha256(raw.encode()).hexdigest()[:16]
    return out


def render_human(findings: list[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def render_json(findings: list[Finding], **extra: Any) -> str:
    return json.dumps(
        {"findings": [f.to_dict() for f in findings], **extra}, indent=2
    )
