"""Tier 5 of the port's linter: persistence & crash-consistency analysis.

A copy of the JAX package's ``analysis/persistence.py``; its ``_PKG``,
and with it the commit sequences of ``CRASH_ENTRIES``, name the port's
``serving/segments.py``, ``serving/artifact.py``, ``utils/checkpoint.py``
and ``serving/fabric.commit_floor``, and its contracts are read from the
port's ``analysis/registry.py``.

Spark delegates its durability discipline to HDFS rename semantics and
write-ahead logs: a task commits by renaming a completed attempt
directory into place, and the streaming receiver's WAL makes a committed
batch survive any executor death.  This runtime owns that discipline
itself — versioned array-dirs, segment manifests, atomic LATEST flips,
generation-deferred GC — and the disk state is load-bearing for
*serving*: a torn commit is not a failed batch job, it
is a corrupted live index.  Tier 5 is the static gate for the
crash-window defect class.  Like tiers 1 and 4 it is stdlib-only — pure
AST, no torch import, whole-repo well under the declared
``GRAFT_PERSIST_BUDGET_S`` budget — and builds ONE repo-wide model of
every on-disk protocol (tempfile staging, fsyncs, ``os.replace``
renames, pointer flips, deletions, commit locks, the declared artifact
schemas) with same-file call propagation:

- **atomic-write-drift** — a file write that lands at its final name
  (no tempfile staging + atomic rename) tears under SIGKILL; and a raw
  ``os.replace`` on a *pointer-visible* path (the enclosing function
  flips — or is — a LATEST/manifest pointer) must instead go through the
  blessed ``utils/checkpoint.durable_replace`` idiom, which fsyncs the
  payload (file, or staged dir plus members) before the rename and the
  parent directory after it: a pointer must never be able to name
  unsynced data.  Append-mode writes (the JSONL event log) are exempt —
  append-only is the other crash-safe idiom.
- **pointer-flip-order** — a pointer flip may only name payloads whose
  commits precede it: any payload rename *after* a flip in the same
  protocol function means a reader resolving the new pointer races the
  payload landing (the flip must be the LAST durable act of a commit).
- **gc-before-flip** — deleting a non-staged path (``shutil.rmtree`` /
  ``os.unlink`` of a versioned dir, a snapshot, a replaced segment)
  before a later pointer flip in the same function destroys state the
  *current* generation still names; GC must be generation-deferred,
  reachable only after the flip that unnames its target (the
  SegmentMerger/commit_replace discipline).
- **schema-pair-drift** — ``analysis/registry.py ARTIFACT_SCHEMAS``
  declares each artifact family's key space (array members + META/JSON
  document keys) with its writer and reader functions; the lexical
  surface is validated both directions, the ``DONATED_CALLEES`` contract
  style: a declared key no writer stores, a non-aux key no reader loads
  (saved-but-never-loaded), and any write/read of an undeclared key are
  all findings — writer/reader schema drift is the "new build cannot
  load yesterday's index" class.
- **commit-lock-drift** — ``analysis/registry.py COMMIT_LOCKS`` declares
  the lock that serializes each protocol's read-modify-write commit
  (the segment manifest's ``_COMMIT_LOCK``); every lexical call to a
  protected mutator must sit under ``with <lock>``, and the declaration
  itself must not go stale.

The model also *derives* dynamic fixtures: :func:`enumerate_crash_points`
walks a commit function (expanding same-file and cross-protocol callees)
and lists every write boundary — payload writes, fsyncs, renames,
pointer flips, deletions — in execution order; the reader-visible ones
(``replace``/``delete``) are exactly the SIGKILL points
``tools/crash_harness.py`` replays, so new persistence code is
crash-tested by construction (``--crash-points`` on the CLI prints the
enumeration).

Findings flow through the same suppression (``# graftlint:
disable=<rule>``) and fingerprint/baseline/ratchet machinery as every
other tier.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterator

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.concurrency import (
    _Sink,
    _walk_own,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.context import (
    FileContext,
    FuncNode,
    call_name,
    dotted_name,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import (
    default_targets,
    iter_python_files,
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    Finding,
    assign_fingerprints,
)

PERSIST_RULES: dict[str, str] = {
    "atomic-write-drift": (
        "a file write landing at its final name (no tempfile staging + "
        "atomic rename), or a raw os.replace on a pointer-visible path "
        "instead of the blessed durable_replace (fsync payload + parent "
        "dir) — a SIGKILL mid-write tears the artifact, or the pointer "
        "names unsynced data"
    ),
    "pointer-flip-order": (
        "a LATEST/manifest pointer flip precedes a payload commit in the "
        "same protocol function — a reader resolving the new pointer "
        "races the payload rename; the flip must be the last durable act"
    ),
    "gc-before-flip": (
        "a non-staged path is deleted before a later pointer flip in the "
        "same function — GC must be generation-deferred, reachable only "
        "after the flip that unnames its target"
    ),
    "schema-pair-drift": (
        "writer/reader drift against the declared ARTIFACT_SCHEMAS "
        "contract: a declared key nobody stores, a non-aux key nobody "
        "loads back, or a lexical write/read of an undeclared key"
    ),
    "commit-lock-drift": (
        "a declared commit-path mutator called without holding its "
        "COMMIT_LOCKS lock (manifest read-modify-write unserialized), or "
        "a stale lock/mutator declaration"
    ),
}

_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"

_POINTER_FLIP_LEAVES = frozenset({"_write_pointer"})
_DURABLE_LEAVES = frozenset({"durable_replace"})
_FSYNC_LEAVES = frozenset({"fsync", "_fsync_path", "fsync_dir"})
_TMP_FACTORY_LEAVES = frozenset(
    {"mkstemp", "mkdtemp", "NamedTemporaryFile", "TemporaryDirectory"}
)
_DELETE_LEAVES = frozenset({"rmtree", "unlink", "remove", "rmdir"})
_DELETE_ROOTS = frozenset({"os", "shutil"})
# open()/os.fdopen() modes that create/truncate (append is exempt: an
# append-only log is the *other* crash-safe idiom)
_CREATE_MODE_CHARS = ("w", "x")

# Default crash-sequence entries for --crash-points: the commit paths
# whose write boundaries the harness replays.
CRASH_ENTRIES: tuple[str, ...] = (
    f"{_PKG}/serving/segments.py::commit_append",
    f"{_PKG}/serving/segments.py::commit_replace",
    f"{_PKG}/serving/segments.py::merge_segments",
    f"{_PKG}/serving/artifact.py::save_index",
    f"{_PKG}/utils/checkpoint.py::save_checkpoint",
    f"{_PKG}/serving/fabric.py::commit_floor",
)


# --------------------------------------------------------------------------
# the declared persistence contract (parsed lexically from the registry)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PersistContract:
    schemas: tuple  # rows (family, writers, readers, keys, aux_keys)
    locks: tuple  # rows (module, lock name, protected callee leaves)
    relpath: str | None  # registry path when under the scanned root
    schemas_line: int
    locks_line: int


def _resolve_str(node: ast.AST, consts: dict[str, str]) -> str | None:
    """A string literal, a name bound to a module-level string constant,
    or an f-string over those (the registry's ``f"{_PKG}/..."`` idiom)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue):
                inner = _resolve_str(v.value, consts)
                if inner is None:
                    return None
                parts.append(inner)
            else:
                return None
        return "".join(parts)
    return None


def _literal_strings(node: ast.AST, consts: dict[str, str]) -> tuple:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            s = _resolve_str(e, consts)
            if s is not None:
                out.append(s)
        return tuple(out)
    return ()


def _parse_contract_file(path: Path) -> tuple | None:
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    consts: dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Constant) and \
                isinstance(stmt.value.value, str):
            consts[stmt.targets[0].id] = stmt.value.value
    schemas: tuple = ()
    locks: tuple = ()
    schemas_line = 1
    locks_line = 1
    for node in ast.walk(tree):
        value: ast.expr | None = None
        name: str | None = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.target, ast.Name):
            name, value = node.target.id, node.value
        if value is None or not isinstance(value, (ast.Tuple, ast.List)):
            continue
        if name == "ARTIFACT_SCHEMAS":
            schemas_line = node.lineno
            rows = []
            for row in value.elts:
                if not isinstance(row, (ast.Tuple, ast.List)) or \
                        len(row.elts) != 5:
                    continue
                fam = _resolve_str(row.elts[0], consts)
                if fam is None:
                    continue
                rows.append((
                    fam,
                    _literal_strings(row.elts[1], consts),
                    _literal_strings(row.elts[2], consts),
                    _literal_strings(row.elts[3], consts),
                    _literal_strings(row.elts[4], consts),
                ))
            schemas = tuple(rows)
        elif name == "COMMIT_LOCKS":
            locks_line = node.lineno
            rows = []
            for row in value.elts:
                if not isinstance(row, (ast.Tuple, ast.List)) or \
                        len(row.elts) != 3:
                    continue
                mod = _resolve_str(row.elts[0], consts)
                lock = _resolve_str(row.elts[1], consts)
                if mod is None or lock is None:
                    continue
                rows.append((mod, lock,
                             _literal_strings(row.elts[2], consts)))
            locks = tuple(rows)
    return schemas, locks, schemas_line, locks_line


_contract_cache: dict[str, PersistContract | None] = {}


def persist_contract(root: Path) -> PersistContract | None:
    key = str(root)
    if key in _contract_cache:
        return _contract_cache[key]
    candidates = [
        (root / f"{_PKG}/analysis/registry.py", True),
        (root / "analysis/registry.py", True),
        (Path(__file__).resolve().parent / "registry.py", False),
    ]
    contract = None
    for path, in_root in candidates:
        if path.exists():
            parsed = _parse_contract_file(path)
            if parsed is None:
                continue
            schemas, locks, schemas_line, locks_line = parsed
            relpath = None
            if in_root:
                try:
                    relpath = path.resolve().relative_to(
                        root.resolve()).as_posix()
                except ValueError:
                    relpath = path.as_posix()
            contract = PersistContract(
                schemas=schemas, locks=locks, relpath=relpath,
                schemas_line=schemas_line, locks_line=locks_line,
            )
            break
    _contract_cache[key] = contract
    return contract


# --------------------------------------------------------------------------
# per-file model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Event:
    kind: str  # write | replace | durable | flip | fsync | delete | stage
    node: ast.AST
    line: int
    tainted: bool  # target derives from a tempfile staging name
    detail: str = ""


def _expr_mentions(expr: ast.AST | None, names: set[str]) -> bool:
    if expr is None:
        return False
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and sub.id in names:
            return True
    return False


def _target_names(tgt: ast.expr) -> Iterator[str]:
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for e in tgt.elts:
            yield from _target_names(e)
    elif isinstance(tgt, ast.Starred):
        yield from _target_names(tgt.value)


class _PFile:
    """Per-file persistence facts."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.relpath = ctx.relpath
        self.defs: dict[str, list[FuncNode]] = {}
        self.def_class: dict[int, str | None] = {}  # id(fn) -> class name
        self.funcs: list[FuncNode] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
                self.funcs.append(node)
                cls = None
                cur = ctx.parents.get(node)
                while cur is not None:
                    if isinstance(cur, ast.ClassDef):
                        cls = cur.name
                        break
                    cur = ctx.parents.get(cur)
                self.def_class[id(node)] = cls
        # lazily-filled per-function caches
        self._taint: dict[int, set[str]] = {}
        self._handles: dict[int, set[str]] = {}
        self._events: dict[int, list[_Event]] = {}
        self.flipping: set[int] = set()
        self.deleting: set[int] = set()
        self._classify_functions()

    # ------------------------------------------------------------- helpers

    def resolve_def(self, funcpart: str) -> FuncNode | None:
        """Resolve ``name`` or ``Class.method`` to a def in this file."""
        cls = None
        name = funcpart
        if "." in funcpart:
            cls, name = funcpart.split(".", 1)
        for fn in self.defs.get(name, []):
            if cls is None or self.def_class.get(id(fn)) == cls:
                return fn
        return None

    def body_of(self, fn: FuncNode | None) -> list[ast.AST]:
        if fn is None:  # module level
            return list(self.ctx.tree.body)
        return fn.body if isinstance(fn.body, list) else [fn.body]

    def iter_scope(self, fn: FuncNode | None) -> Iterator[ast.AST]:
        """All nodes lexically in ``fn``'s own scope: the body statements,
        without descending into (or through) nested function definitions
        — those are scopes of their own and get their own pass."""
        for stmt in self.body_of(fn):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield from _walk_own(stmt)

    def tainted_names(self, fn: FuncNode | None) -> set[str]:
        key = id(fn)
        if key in self._taint:
            return self._taint[key]
        tainted: set[str] = set()
        nodes: list[ast.AST] = list(self.iter_scope(fn))
        for _ in range(2):  # fixpoint for straight-line chains
            for node in nodes:
                if isinstance(node, ast.Assign):
                    value, targets = node.value, node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    value, targets = node.value, [node.target]
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        ce = item.context_expr
                        hit = _expr_mentions(ce, tainted) or (
                            isinstance(ce, ast.Call)
                            and self._is_tmp_factory(ce)
                        )
                        if hit and item.optional_vars is not None:
                            tainted.update(_target_names(item.optional_vars))
                    continue
                else:
                    continue
                hit = _expr_mentions(value, tainted) or (
                    isinstance(value, ast.Call)
                    and self._is_tmp_factory(value)
                )
                if hit:
                    for t in targets:
                        tainted.update(_target_names(t))
        self._taint[key] = tainted
        return tainted

    @staticmethod
    def _is_tmp_factory(call: ast.Call) -> bool:
        cname = call_name(call) or ""
        leaf = cname.rsplit(".", 1)[-1]
        root = cname[: -len(leaf) - 1] if "." in cname else ""
        return leaf in _TMP_FACTORY_LEAVES and root in ("", "tempfile", "tf")

    def handle_names(self, fn: FuncNode | None) -> set[str]:
        """Names bound as ``with open(...)/os.fdopen(...) as f`` in this
        scope — stream writes through them (json.dump, np.savez, .write)
        are covered by the classification of the open itself, so they are
        not reported a second time."""
        key = id(fn)
        cached = self._handles.get(key)
        if cached is not None:
            return cached
        handles: set[str] = set()
        for node in self.iter_scope(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Call) and item.optional_vars is not None:
                        cname = call_name(ce) or ""
                        if cname.rsplit(".", 1)[-1] in ("open", "fdopen"):
                            handles.update(_target_names(item.optional_vars))
        self._handles[key] = handles
        return handles

    # ----------------------------------------------------------- event scan

    def _classify_call(self, node: ast.Call, tainted: set[str],
                       handles: "set[str] | None" = None) -> _Event | None:
        cname = call_name(node)
        leaf = cname.rsplit(".", 1)[-1] if cname else (
            node.func.attr if isinstance(node.func, ast.Attribute) else None
        )
        if leaf is None:
            return None
        root = ""
        if cname is not None and "." in cname:
            root = cname[: -len(leaf) - 1]

        def ev(kind: str, target: ast.AST | None, detail: str = "") -> _Event:
            return _Event(kind=kind, node=node, line=node.lineno,
                          tainted=_expr_mentions(target, tainted),
                          detail=detail)

        if cname == "os.replace":
            return ev("replace", node.args[0] if node.args else None,
                      "os.replace")
        if leaf in _DURABLE_LEAVES:
            return ev("durable", node.args[0] if node.args else None,
                      "durable_replace")
        if leaf in _POINTER_FLIP_LEAVES:
            return ev("flip", None, "_write_pointer")
        if leaf in _FSYNC_LEAVES and root in ("", "os", "ckpt",
                                              "checkpoint"):
            return ev("fsync", None, leaf)
        if leaf in _DELETE_LEAVES and root in _DELETE_ROOTS | {""}:
            # a bare leaf must really be the os/shutil function, not a
            # list/set method: require a dotted os./shutil. spelling for
            # `remove`, allow bare rmtree/unlink (from-imports)
            if root == "" and leaf in ("remove", "rmdir"):
                return None
            return ev("delete", node.args[0] if node.args else None,
                      f"{cname or leaf}")
        if leaf in ("open", "fdopen"):
            if leaf == "fdopen" and root not in ("os", ""):
                return None
            if leaf == "open" and root not in ("", "io"):
                return None
            mode = None
            if len(node.args) >= 2:
                mode = node.args[1]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if not (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)):
                return None  # default "r" or dynamic: not a create-write
            if not any(c in mode.value for c in _CREATE_MODE_CHARS):
                return None
            return ev("write", node.args[0] if node.args else None,
                      f"{leaf}(mode={mode.value!r})")
        if leaf in ("write_text", "write_bytes") and \
                isinstance(node.func, ast.Attribute):
            return ev("write", node.func.value, leaf)
        if leaf in ("save", "savez", "savez_compressed") and \
                root in ("np", "numpy", "jnp"):
            target = node.args[0] if node.args else None
            if isinstance(target, ast.Name) and handles and \
                    target.id in handles:
                return None  # stream write: the open() carries the event
            return ev("write", target, f"{root}.{leaf}")
        if cname in ("json.dump",) and len(node.args) >= 2:
            target = node.args[1]
            if isinstance(target, ast.Name) and handles and \
                    target.id in handles:
                return None  # stream write: the open() carries the event
            return ev("write", target, "json.dump")
        if leaf in _TMP_FACTORY_LEAVES:
            return _Event(kind="stage", node=node, line=node.lineno,
                          tainted=True, detail=leaf)
        return None

    def events_of(self, fn: FuncNode | None) -> list[_Event]:
        key = id(fn)
        if key in self._events:
            return self._events[key]
        tainted = self.tainted_names(fn)
        handles = self.handle_names(fn)
        out: list[_Event] = []
        for node in self.iter_scope(fn):
            if isinstance(node, ast.Call):
                ev = self._classify_call(node, tainted, handles)
                if ev is not None:
                    out.append(ev)
        out.sort(key=lambda e: (e.line, getattr(e.node, "col_offset", 0)))
        self._events[key] = out
        return out

    def _classify_functions(self) -> None:
        """Fixpoint: a function that flips (or deletes) directly, or calls
        a same-file function that does, is flip-ish (delete-ish)."""
        direct_flip: set[int] = set()
        direct_del: set[int] = set()
        for fn in self.funcs:
            for ev in self.events_of(fn):
                if ev.kind == "flip":
                    direct_flip.add(id(fn))
                elif ev.kind == "delete" and not ev.tainted:
                    direct_del.add(id(fn))
        self.flipping = set(direct_flip)
        self.deleting = set(direct_del)
        changed = True
        while changed:
            changed = False
            for fn in self.funcs:
                if id(fn) in self.flipping and id(fn) in self.deleting:
                    continue
                for node in self.iter_scope(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    cname = call_name(node)
                    leaf = cname.rsplit(".", 1)[-1] if cname else None
                    if leaf is None:
                        continue
                    for callee in self.defs.get(leaf, []):
                            if id(callee) in self.flipping and \
                                    id(fn) not in self.flipping:
                                self.flipping.add(id(fn))
                                changed = True
                            if id(callee) in self.deleting and \
                                    id(fn) not in self.deleting:
                                self.deleting.add(id(fn))
                                changed = True

    def flip_points(self, fn: FuncNode | None) -> list[_Event]:
        """Direct flips plus calls to same-file flip-ish functions, as
        events in lexical order."""
        out = [e for e in self.events_of(fn) if e.kind == "flip"]
        for node in self.iter_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            leaf = cname.rsplit(".", 1)[-1] if cname else None
            if leaf is None:
                continue
            for callee in self.defs.get(leaf, []):
                if id(callee) in self.flipping:
                    out.append(_Event(kind="flip", node=node,
                                      line=node.lineno, tainted=False,
                                      detail=f"{leaf}()"))
                    break
        out.sort(key=lambda e: (e.line, getattr(e.node, "col_offset", 0)))
        return out


# --------------------------------------------------------------------------
# monitored-module selection
# --------------------------------------------------------------------------


def _auto_persist(tree: ast.Module) -> bool:
    """A module is an on-disk protocol module when it renames into place
    or participates in the pointer-flip idiom — declared schema/lock
    modules are always included regardless."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            cname = call_name(node) or ""
            leaf = cname.rsplit(".", 1)[-1]
            if cname == "os.replace" or leaf in _POINTER_FLIP_LEAVES \
                    or leaf in _DURABLE_LEAVES:
                return True
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in _POINTER_FLIP_LEAVES | _DURABLE_LEAVES:
                return True
    return False


# --------------------------------------------------------------------------
# checks A-C: write/flip/GC discipline
# --------------------------------------------------------------------------


def _check_write_discipline(model: _PFile, sink: _Sink) -> None:
    ctx = model.ctx
    scopes: list[FuncNode | None] = [None, *model.funcs]
    for fn in scopes:
        fname = getattr(fn, "name", "<module>")
        blessed = fname in _DURABLE_LEAVES | _FSYNC_LEAVES
        events = model.events_of(fn)
        flipish = model.flip_points(fn)
        flip_lines = [e.line for e in flipish]
        fn_flips = bool(flipish) or fname in _POINTER_FLIP_LEAVES

        for ev in events:
            # A1: write landing at its final name
            if ev.kind == "write" and not ev.tainted:
                sink.add(
                    ctx, "atomic-write-drift", ev.node,
                    f"{ev.detail} lands at its final name — a SIGKILL "
                    "mid-write leaves a torn artifact a reader may open; "
                    "stage in a tempfile (mkstemp/mkdtemp) and "
                    "os.replace/durable_replace it into place",
                )
            # A2: raw rename on a pointer-visible path
            if ev.kind == "replace" and not blessed and fn_flips:
                sink.add(
                    ctx, "atomic-write-drift", ev.node,
                    "raw os.replace on a pointer-visible path (this "
                    "function participates in a pointer flip) — use "
                    "utils/checkpoint.durable_replace so the payload and "
                    "the parent directory are fsync'd before any pointer "
                    "can name them",
                )

        # B: flip before a later payload commit
        commits = [e for e in events if e.kind in ("replace", "durable")]
        for flip in flipish:
            late = [c for c in commits if c.line > flip.line]
            if late:
                sink.add(
                    ctx, "pointer-flip-order", flip.node,
                    f"pointer flip precedes a payload commit at line "
                    f"{late[0].line} — a reader resolving the new pointer "
                    "races the payload rename; commit every payload first, "
                    "flip last",
                )

        # C: deletion before a later flip
        deletes = [e for e in events if e.kind == "delete" and not e.tainted]
        for node in model.iter_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            leaf = cname.rsplit(".", 1)[-1] if cname else None
            if leaf is None:
                continue
            for callee in model.defs.get(leaf, []):
                if id(callee) in model.deleting:
                    deletes.append(_Event(
                        kind="delete", node=node, line=node.lineno,
                        tainted=False, detail=f"{leaf}()"))
                    break
        for d in deletes:
            later_flips = [ln for ln in flip_lines if ln > d.line]
            if later_flips:
                sink.add(
                    ctx, "gc-before-flip", d.node,
                    f"deletion ({d.detail}) precedes the pointer flip at "
                    f"line {later_flips[0]} — the current generation may "
                    "still name the target; defer GC until after the flip "
                    "that unnames it (the commit_replace discipline)",
                )


# --------------------------------------------------------------------------
# check D: schema-pair-drift
# --------------------------------------------------------------------------


def _split_spec(spec: str) -> tuple[str, str, str | None]:
    parts = spec.split("::")
    if len(parts) == 2:
        return parts[0], parts[1], None
    if len(parts) == 3:
        return parts[0], parts[1], parts[2]
    return spec, "", None


def _collect_written(model: _PFile, fn: FuncNode) -> dict[str, ast.AST]:
    out: dict[str, ast.AST] = {}
    for node in model.iter_scope(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.setdefault(k.value, k)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str):
                    out.setdefault(t.slice.value, t)
    return out


def _collect_read(model: _PFile, fn: FuncNode,
                  recv: str | None) -> dict[str, ast.AST]:
    out: dict[str, ast.AST] = {}
    for node in model.iter_scope(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            if recv is None or dotted_name(node.value) == recv:
                out.setdefault(node.slice.value, node)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            if recv is None or dotted_name(node.func.value) == recv:
                out.setdefault(node.args[0].value, node)
    return out


def _check_schemas(contract: PersistContract, models: dict[str, _PFile],
                   sink: _Sink) -> None:
    reg_model = models.get(contract.relpath) if contract.relpath else None

    def reg_finding(message: str, line: int) -> None:
        if reg_model is not None:
            sink.add(reg_model.ctx, "schema-pair-drift", None, message,
                     line=line)

    for family, writers, readers, keys, aux in contract.schemas:
        keyset = set(keys)
        for a in aux:
            if a not in keyset:
                reg_finding(
                    f"family {family!r}: aux key {a!r} is not in the "
                    "declared key space — stale aux entry",
                    contract.schemas_line,
                )
        written: dict[str, tuple[_PFile, ast.AST]] = {}
        read: dict[str, tuple[_PFile, ast.AST]] = {}
        for spec_list, collect, store in (
            (writers, _collect_written, written),
            (readers, _collect_read, read),
        ):
            for spec in spec_list:
                path, funcpart, recv = _split_spec(spec)
                model = models.get(path)
                fn = model.resolve_def(funcpart) if model else None
                if model is None or fn is None:
                    reg_finding(
                        f"family {family!r}: declared "
                        f"{'writer' if collect is _collect_written else 'reader'} "
                        f"{spec!r} does not resolve to a function on the "
                        "scan surface — stale contract row",
                        contract.schemas_line,
                    )
                    continue
                if collect is _collect_written:
                    got = _collect_written(model, fn)
                else:
                    got = _collect_read(model, fn, recv)
                for k, node in got.items():
                    store.setdefault(k, (model, node))
        if not written and not read:
            continue  # nothing resolved (restricted fixture tree)
        for k in keys:
            if k not in written:
                reg_finding(
                    f"family {family!r}: declared key {k!r} is stored by "
                    "no declared writer — the schema promises a member "
                    "the artifact never carries",
                    contract.schemas_line,
                )
            if k not in read and k not in aux:
                reg_finding(
                    f"family {family!r}: key {k!r} is saved but never "
                    "loaded by any declared reader — dead weight in every "
                    "artifact, or a reader lost a member it needs; mark "
                    "it aux (write-only forensics) or wire the reader",
                    contract.schemas_line,
                )
        for k, (model, node) in sorted(written.items()):
            if k not in keyset:
                sink.add(
                    model.ctx, "schema-pair-drift", node,
                    f"writer stores key {k!r} which family {family!r} "
                    "does not declare — add it to ARTIFACT_SCHEMAS (and a "
                    "reader, or mark it aux) before shipping it to disk",
                )
        for k, (model, node) in sorted(read.items()):
            if k not in keyset:
                sink.add(
                    model.ctx, "schema-pair-drift", node,
                    f"reader loads key {k!r} which family {family!r} does "
                    "not declare — a writer-side rename would break this "
                    "load path silently; declare the key",
                )


# --------------------------------------------------------------------------
# check E: commit-lock-drift
# --------------------------------------------------------------------------


def _lock_declared(model: _PFile, lockname: str) -> bool:
    for node in ast.walk(model.ctx.tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == lockname
            for t in node.targets
        ) and isinstance(node.value, ast.Call):
            cname = call_name(node.value) or ""
            if cname.rsplit(".", 1)[-1] in ("Lock", "RLock"):
                return True
    return False


def _held_lock(ctx: FileContext, node: ast.AST, lockname: str) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                name = dotted_name(item.context_expr)
                if name is not None and (
                    name == lockname or name.endswith("." + lockname)
                ):
                    return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break
        cur = ctx.parents.get(cur)
    return False


def _check_commit_locks(contract: PersistContract,
                        models: dict[str, _PFile], sink: _Sink) -> None:
    reg_model = models.get(contract.relpath) if contract.relpath else None
    for module, lockname, callees in contract.locks:
        model = models.get(module)
        if model is None:
            if reg_model is not None:
                sink.add(
                    reg_model.ctx, "commit-lock-drift", None,
                    f"COMMIT_LOCKS names module {module!r} which is not "
                    "on the scan surface — stale declaration",
                    line=contract.locks_line,
                )
            continue
        if not _lock_declared(model, lockname):
            sink.add(
                model.ctx, "commit-lock-drift", None,
                f"COMMIT_LOCKS declares lock {lockname!r} for {module} "
                "but no threading.Lock/RLock of that name is defined "
                "there — stale declaration",
                line=1,
            )
        for callee in callees:
            if callee not in model.defs:
                if reg_model is not None:
                    sink.add(
                        reg_model.ctx, "commit-lock-drift", None,
                        f"COMMIT_LOCKS protects callee {callee!r} which "
                        f"{module} does not define — stale declaration",
                        line=contract.locks_line,
                    )
        callee_set = set(callees)
        for node in ast.walk(model.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            leaf = cname.rsplit(".", 1)[-1] if cname else None
            if leaf not in callee_set:
                continue
            if not _held_lock(model.ctx, node, lockname):
                sink.add(
                    model.ctx, "commit-lock-drift", node,
                    f"{leaf}() mutates commit state but is called without "
                    f"holding {lockname} — manifest read-modify-write "
                    "races another committer (an ingest seal and a merge "
                    "can resurrect each other's replaced segments); take "
                    "the declared commit lock",
                )


# --------------------------------------------------------------------------
# crash-point enumeration (the derived dynamic fixture set)
# --------------------------------------------------------------------------


def _leaf_index(models: dict[str, _PFile]) -> dict[str, tuple[_PFile, FuncNode]]:
    out: dict[str, tuple[_PFile, FuncNode]] = {}
    for rel in sorted(models):
        model = models[rel]
        for name, fns in model.defs.items():
            out.setdefault(name, (model, fns[0]))
    return out


def _enumerate_fn(model: _PFile, fn: FuncNode,
                  index: dict[str, tuple[_PFile, FuncNode]],
                  chain: tuple[str, ...], out: list[dict],
                  stack: set[str]) -> None:
    if len(chain) > 8:
        return
    tainted = model.tainted_names(fn)
    handles = model.handle_names(fn)
    calls: list[ast.Call] = [
        node for node in model.iter_scope(fn) if isinstance(node, ast.Call)
    ]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    for node in calls:
        ev = model._classify_call(node, tainted, handles)
        cname = call_name(node)
        leaf = cname.rsplit(".", 1)[-1] if cname else None
        resolvable = (
            leaf in index and leaf is not None
            and not (isinstance(node.func, ast.Attribute)
                     and leaf in ("get", "put"))
        )
        if ev is not None and ev.kind in ("durable", "flip") and resolvable:
            ev = None  # expand the helper instead: its body holds the ops
        if ev is not None and ev.kind == "delete" and ev.tainted:
            # staging cleanup (the finally-block unlink of a tmp already
            # renamed away): guarded by exists(), never runs on the happy
            # path — not a reader-visible mutation, not a kill point
            ev = None
        if ev is not None and ev.kind != "stage":
            op = {"durable": "replace", "flip": "replace"}.get(ev.kind,
                                                               ev.kind)
            out.append({
                "seq": len(out),
                "op": op,
                "boundary": op in ("replace", "delete"),
                "path": model.relpath,
                "line": node.lineno,
                "via": " -> ".join(chain),
                "detail": ev.detail,
            })
            continue
        if resolvable:
            cmodel, cfn = index[leaf]
            key = f"{cmodel.relpath}::{leaf}"
            if key in stack:
                continue
            stack.add(key)
            _enumerate_fn(cmodel, cfn, index,
                          chain + (f"{leaf}()",), out, stack)
            stack.discard(key)


def build_models(root: Path,
                 paths: "list[Path] | None" = None) -> dict[str, _PFile]:
    """Parse the scan surface into per-file persistence models (all files
    are parsed — schema readers may live anywhere — but only protocol
    modules get the write-discipline checks)."""
    targets = paths if paths is not None else default_targets(root)
    models: dict[str, _PFile] = {}
    for f in iter_python_files(targets):
        try:
            source = f.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=str(f))
        except (OSError, SyntaxError):
            continue  # tier 1 reports parse errors
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        models[rel] = _PFile(FileContext(rel, source, tree, root=root))
    return models


def monitored_modules(contract: PersistContract | None,
                      models: dict[str, _PFile]) -> set[str]:
    monitored: set[str] = set()
    if contract is not None:
        for _family, writers, _readers, _keys, _aux in contract.schemas:
            for spec in writers:
                monitored.add(_split_spec(spec)[0])
        for module, _lock, _callees in contract.locks:
            monitored.add(module)
    for rel, model in models.items():
        if _auto_persist(model.ctx.tree):
            monitored.add(rel)
    return {m for m in monitored if m in models}


def enumerate_crash_points(
    root: Path | None = None,
    entry: str | None = None,
    models: "dict[str, _PFile] | None" = None,
) -> list[dict]:
    """Every write boundary of one commit sequence (``"<relpath>::<func>"``,
    default the first CRASH_ENTRIES entry), in execution order, with
    same-file and cross-protocol callees expanded.  Entries with
    ``boundary: true`` (renames and deletions — the reader-visible
    mutations) are the SIGKILL points ``tools/crash_harness.py`` replays."""
    root = root or repo_root()
    entry = entry or CRASH_ENTRIES[0]
    if models is None:
        models = build_models(root)
    contract = persist_contract(root)
    mon = monitored_modules(contract, models)
    index = _leaf_index({m: models[m] for m in mon})
    path, funcpart, _recv = _split_spec(entry)
    model = models.get(path)
    fn = model.resolve_def(funcpart) if model is not None else None
    if model is None or fn is None:
        raise ValueError(f"unknown crash entry {entry!r}")
    out: list[dict] = []
    _enumerate_fn(model, fn, index, (funcpart + "()",), out,
                  {f"{path}::{funcpart}"})
    return out


def crash_point_report(root: Path | None = None,
                       models: "dict[str, _PFile] | None" = None) -> dict:
    """{entry: [crash points]} for every default commit sequence —
    what ``--crash-points`` prints.  Pass ``models`` to reuse an
    already-built surface (the CLI shares one build with the findings
    pass, which is what the GRAFT_PERSIST_BUDGET_S gate times)."""
    root = root or repo_root()
    if models is None:
        models = build_models(root)
    report = {}
    for entry in CRASH_ENTRIES:
        try:
            report[entry] = enumerate_crash_points(root, entry, models)
        except ValueError:
            report[entry] = None  # entry not on this surface
    return report


# --------------------------------------------------------------------------
# the tier-5 runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PersistResult:
    findings: list[Finding]
    monitored: list[str]

    @property
    def ok(self) -> bool:
        return not self.findings


def run_persistence(
    root: Path | None = None,
    paths: "list[Path] | None" = None,
    only_modules: "set[str] | None" = None,
    models: "dict[str, _PFile] | None" = None,
) -> PersistResult:
    """Run the tier-5 persistence analysis.

    Like tier 4, the repo-wide model is always built over the full scan
    surface — a schema has writers and readers in different files — and
    ``only_modules`` only filters which files may report findings (the
    ``--changed-only`` fast path).  ``models`` reuses a pre-built
    surface (see :func:`build_models`)."""
    root = root or repo_root()
    if models is None:
        models = build_models(root, paths)
    contract = persist_contract(root)
    mon = monitored_modules(contract, models)

    sink = _Sink()
    for rel in sorted(mon):
        _check_write_discipline(models[rel], sink)
    if contract is not None:
        _check_schemas(contract, models, sink)
        _check_commit_locks(contract, models, sink)

    findings = sink.findings
    if only_modules is not None:
        findings = [f for f in findings if f.path in only_modules]
    return PersistResult(findings=assign_fingerprints(findings),
                         monitored=sorted(mon))
