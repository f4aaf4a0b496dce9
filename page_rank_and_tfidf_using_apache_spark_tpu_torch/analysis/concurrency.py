"""Tier 4 of the port's linter: interprocedural concurrency &
buffer-lifetime analysis of the threaded runtime.

A copy of the JAX package's ``analysis/concurrency.py`` over the port's
code and contracts.  It differs in three spellings only: the host reads
that touch a consumed buffer are the PyTorch ones (``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``float/int/bool()``,
``np.asarray``, the guarded ``device_get``); the device syncs that block
under a lock are ``torch.cuda.synchronize()`` and an argument-less
``.synchronize()`` / ``.cpu()`` beside the guarded wrappers; and the
contracts are read from the port's ``analysis/registry.py`` and
``utils/config.py``.

The runtime packs Spark's separate JVMs (executors, the driver, the block
manager) into threads of one process (ingest tokenize/H2D stages, the
server drain thread, the soak supervisor + closed-loop clients +
prior-refresh thread, the metrics hub, the HTTP exporter), plus device
buffers that a callee overwrites in place.  Tier 4 is the static gate for
that defect class.  Like tier 1 it is stdlib-only — pure AST over the scan
surface, no torch import, a whole-repo run in well under the declared
``GRAFT_CONC_BUDGET_S`` budget — but unlike tier 1 it builds ONE repo-wide
model (locks, threads, guarded sites, donation contracts) and checks
cross-cutting invariants over it:

- **lock-order-cycle** — the lock-acquisition graph across every
  ``threading.Lock``/``RLock`` site (module- and instance-scoped), with
  same-file call propagation (a function called while a lock is held
  contributes its own acquisitions as edges), must be cycle-free.  A
  cycle is a potential deadlock the GIL will not save you from.  The
  graph itself is exported as DOT/JSON via ``--lock-graph``.
- **blocking-under-lock** — a blocking call (``queue.get/put`` on a
  bounded queue, ``Future.result``, thread ``join``, ``Event.wait``,
  ``time.sleep``, HTTP I/O, subprocess, or any device sync) reachable
  while a lock is held serializes every other thread that needs the lock
  behind an unbounded wait.
- **use-after-donate** — operands passed at a declared position of a
  callee that takes or overwrites their storage in place
  (``analysis/registry.py DONATED_CALLEES``: the streaming DF carry, the
  staging ring's slots) are *consumed*: any later host-side read of that
  binding, any re-dispatch of it, and any such call inside a retry
  closure (``run_guarded``/``retry_transient`` re-invoke their fn, so a
  retry would apply the in-place update twice) is flagged.  The safe
  idiom — ``counts, carry = kernel(..., carry)`` rebinding in the
  consuming statement — stays quiet.  The contract's cross-check against
  ``EntryPoint.donate`` declarations runs whenever the registry declares
  entry points.
- **chaos-coverage-drift** — every guarded site name in models//parallel/
  /dataflow//serving/ (``run_guarded`` / ``retry_transient`` /
  ``attempt_once`` / guarded ``device_get`` / ``block_until_ready``) is
  cross-referenced against the chaos plans tests and ``tools/chaos.sh``
  actually inject (named sites only — a ``*`` wildcard proves nothing
  about a specific site's recovery path), so a new guarded site cannot
  land without a fault-injection test.  F-string sites resolve to their
  literal suffix (``f"{prefix}_step"`` is covered once any named chaos
  site ends in ``_step``).
- **thread-lock-drift** — every declared thread's target (plus same-file
  callees) may acquire only the locks its ``utils/config.py
  THREAD_REGISTRY`` row declares; the name-side validation lives in tier
  1 (``thread-registry-drift``).

Findings flow through the same suppression (``# graftlint:
disable=<rule>``) and fingerprint/baseline/ratchet machinery as every
other tier.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Any, Iterator

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
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.rules import (
    _names_match,
    resolve_thread_name,
    thread_registry_rows,
)

CONC_RULES: dict[str, str] = {
    "lock-order-cycle": (
        "cycle in the repo-wide lock-acquisition graph (nested with-blocks "
        "plus same-file call propagation) — two threads taking the locks "
        "in opposite orders deadlock"
    ),
    "blocking-under-lock": (
        "blocking call (queue get/put, Future.result, join, Event.wait, "
        "sleep, HTTP/subprocess, guarded device sync) reachable while a "
        "lock is held — every peer needing the lock stalls behind it"
    ),
    "use-after-donate": (
        "a binding passed at a donated position of a declared donating "
        "callee is read host-side or re-dispatched after the consuming "
        "call (or dispatched from inside a retry closure) — donated "
        "buffers are dead after dispatch; also contract drift between "
        "DONATED_CALLEES and the registry donate declarations"
    ),
    "chaos-coverage-drift": (
        "a guarded site in models//parallel//dataflow//serving/ is named "
        "by no chaos-injection test or tools/chaos.sh scenario — its "
        "retry/recovery path ships unexercised"
    ),
    "thread-lock-drift": (
        "a registered thread's target acquires a lock outside its "
        "THREAD_REGISTRY declaration — the declared thread/lock inventory "
        "and the code must not drift"
    ),
}

_GUARDED_TREE_DIRS = frozenset({"models", "parallel", "dataflow", "serving"})

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "Lock": "Lock",
    "RLock": "RLock",
}
_QUEUE_CTOR_LEAVES = frozenset(
    {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
)
_EVENT_CTOR_LEAVES = frozenset({"Event", "Condition", "Semaphore", "Barrier"})
_THREAD_CTOR_LEAVES = frozenset({"Thread"})

_RETRY_FAMILY = frozenset({"run_guarded", "retry_transient", "attempt_once"})
_GUARDED_WRAPPER_LEAVES = frozenset({"device_get", "block_until_ready"})
_GUARDED_WRAPPER_ROOTS = frozenset({"", "rx", "executor", "resilience.executor"})

# host-side reads that touch a (possibly consumed) device buffer
_HOST_READ_CALLS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "rx.device_get", "executor.device_get", "device_get",
    "float", "int", "bool",
})
_HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

# argument-less tensor/event/stream methods that wait for the device
_SYNC_METHODS = frozenset({"synchronize", "cpu"})

_CHAOS_TOKEN_RE = re.compile(
    r"([A-Za-z_][A-Za-z0-9_]*)"
    r":(?:fail|lost|hang|device_lost|proc_kill|net_partition|net_hang)@"
)


# --------------------------------------------------------------------------
# per-file model
# --------------------------------------------------------------------------


def _walk_own(node: ast.AST, *, include_self: bool = True) -> Iterator[ast.AST]:
    """Walk without descending into nested function definitions."""
    if include_self:
        yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _walk_own(child)


class _FileModel:
    """Per-file facts the repo-wide checks consume."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.relpath = ctx.relpath
        self.defs_by_name: dict[str, list[FuncNode]] = {}
        self.all_funcs: list[FuncNode] = []
        self.enclosing_class_cache: dict[ast.AST, str | None] = {}
        self.module_str_consts: dict[str, str] = {}
        self.lock_decls: dict[str, str] = {}  # lock id -> "Lock" | "RLock"
        self.queue_names: set[str] = set()
        self.event_names: set[str] = set()
        self.thread_names: set[str] = set()

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs_by_name.setdefault(node.name, []).append(node)
                self.all_funcs.append(node)
            elif isinstance(node, ast.Lambda):
                self.all_funcs.append(node)

        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    isinstance(stmt.value, ast.Constant) and \
                    isinstance(stmt.value.value, str):
                self.module_str_consts[stmt.targets[0].id] = stmt.value.value

        self._collect_decls_and_taints()

    # -------------------------------------------------------------- helpers

    def enclosing_class(self, node: ast.AST) -> str | None:
        if node in self.enclosing_class_cache:
            return self.enclosing_class_cache[node]
        cur = self.ctx.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                self.enclosing_class_cache[node] = cur.name
                return cur.name
            cur = self.ctx.parents.get(cur)
        self.enclosing_class_cache[node] = None
        return None

    def _collect_decls_and_taints(self) -> None:
        for node in ast.walk(self.ctx.tree):
            targets: list[ast.expr] = []
            value: ast.expr | None = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign):
                targets, value = [node.target], node.value
            if value is None:
                continue
            ctor = self._ctor_kind(value)
            if ctor is None:
                continue
            kind, leaf = ctor
            for t in targets:
                spelled: str | None = None
                is_self_attr = False
                if isinstance(t, ast.Name):
                    spelled = t.id
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    spelled = t.attr
                    is_self_attr = True
                if spelled is None:
                    continue
                if kind == "lock":
                    # the id mirrors the acquisition spelling: self attrs
                    # (and class-body field declarations, the dataclass
                    # idiom) scope to their class, bare names to the module
                    class_body_decl = (
                        not is_self_attr
                        and self.ctx.enclosing_function(node) is None
                        and self.enclosing_class(node) is not None
                    )
                    cls = (self.enclosing_class(node)
                           if (is_self_attr or class_body_decl) else None)
                    lid = (f"{self.relpath}::{cls}.{spelled}" if cls
                           else f"{self.relpath}::{spelled}")
                    self.lock_decls[lid] = leaf
                elif kind == "queue":
                    self.queue_names.add(spelled)
                elif kind == "event":
                    self.event_names.add(spelled)
                elif kind == "thread":
                    self.thread_names.add(spelled)

    def _ctor_kind(self, value: ast.expr) -> tuple[str, str] | None:
        """Classify an assignment RHS as a lock/queue/event/thread ctor.
        Also sees through ``dataclasses.field(default_factory=threading.
        Lock)`` (the MetricsRecorder idiom)."""
        if not isinstance(value, ast.Call):
            return None
        cname = call_name(value)
        if cname in _LOCK_CTORS:
            return ("lock", _LOCK_CTORS[cname])
        if cname is not None:
            leaf = cname.rsplit(".", 1)[-1]
            if leaf in _QUEUE_CTOR_LEAVES and (
                cname == leaf or cname.startswith("queue.")
            ):
                return ("queue", leaf)
            if leaf in _EVENT_CTOR_LEAVES and (
                cname == leaf or cname.startswith("threading.")
            ):
                return ("event", leaf)
            if leaf in _THREAD_CTOR_LEAVES and (
                cname == leaf or cname.startswith("threading.")
            ):
                return ("thread", leaf)
            if leaf == "field":
                for kw in value.keywords:
                    if kw.arg == "default_factory":
                        inner = dotted_name(kw.value)
                        if inner in _LOCK_CTORS:
                            return ("lock", _LOCK_CTORS[inner])
        return None

    def lock_id_for(self, expr: ast.AST, node: ast.AST) -> str | None:
        """Lock identity of a ``with <expr>:`` context expression, or None
        when the expression is not lock-flavored (same lexical heuristic
        as tier 1's ``_is_lockish``: the dotted spelling mentions "lock")."""
        name = dotted_name(expr)
        if name is None or "lock" not in name.lower():
            return None
        if name.startswith("self."):
            cls = self.enclosing_class(node)
            rest = name[5:]
            return (f"{self.relpath}::{cls}.{rest}" if cls
                    else f"{self.relpath}::{rest}")
        return f"{self.relpath}::{name}"

    def same_file_callees(self, call: ast.Call) -> list[FuncNode]:
        f = call.func
        if isinstance(f, ast.Name):
            return self.defs_by_name.get(f.id, [])
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self":
            return self.defs_by_name.get(f.attr, [])
        return []


# --------------------------------------------------------------------------
# the lock graph
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LockGraph:
    """Repo-wide lock-acquisition graph: nodes are lock identities
    (``<module>::<scope>.<attr>``), an edge A -> B means code acquires B
    while holding A (directly nested or through a same-file call chain)."""

    nodes: dict[str, dict] = dataclasses.field(default_factory=dict)
    edges: dict[tuple[str, str], dict] = dataclasses.field(default_factory=dict)
    threads: list[dict] = dataclasses.field(default_factory=list)

    def add_node(self, lid: str, kind: str | None, path: str, line: int) -> None:
        self.nodes.setdefault(
            lid, {"kind": kind or "unknown", "path": path, "line": line}
        )

    def add_edge(self, src: str, dst: str, path: str, line: int,
                 via: str) -> None:
        self.edges.setdefault(
            (src, dst), {"path": path, "line": line, "via": via}
        )

    def to_json(self) -> dict:
        return {
            "nodes": {
                lid: dict(meta) for lid, meta in sorted(self.nodes.items())
            },
            "edges": [
                {"src": a, "dst": b, **meta}
                for (a, b), meta in sorted(self.edges.items())
            ],
            "threads": list(self.threads),
        }

    def to_dot(self) -> str:
        def q(s: str) -> str:
            return '"' + s.replace('"', '\\"') + '"'

        lines = ["digraph lock_graph {", "  rankdir=LR;",
                 "  node [shape=box, fontsize=10];"]
        for lid, meta in sorted(self.nodes.items()):
            label = f"{lid}\\n({meta['kind']})"
            lines.append(f"  {q(lid)} [label={q(label)}];")
        for (a, b), meta in sorted(self.edges.items()):
            lines.append(
                f"  {q(a)} -> {q(b)} "
                f"[label={q(meta['path'] + ':' + str(meta['line']))}];"
            )
        for t in self.threads:
            tid = f"thread:{t['name']}"
            lines.append(f"  {q(tid)} [shape=ellipse, label={q(tid)}];")
            for lid in t.get("locks", []):
                lines.append(f"  {q(tid)} -> {q(lid)} [style=dashed];")
        lines.append("}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# blocking-call classification
# --------------------------------------------------------------------------


def _receiver_spelling(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Attribute):
        return dotted_name(call.func.value)
    return None


def _receiver_attr(call: ast.Call) -> str | None:
    """Last attribute/name component of the receiver (``self._q`` -> _q)."""
    if not isinstance(call.func, ast.Attribute):
        return None
    recv = call.func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Name):
        return recv.id
    return None


def _blocking_kind(model: _FileModel, node: ast.Call) -> str | None:
    cname = call_name(node)
    leaf = None
    if cname is not None:
        leaf = cname.rsplit(".", 1)[-1]
    elif isinstance(node.func, ast.Attribute):
        leaf = node.func.attr
    if leaf is None:
        return None
    root = ""
    if cname is not None and "." in cname:
        root = cname[: -len(leaf) - 1]

    if cname == "time.sleep":
        return "time.sleep"
    if leaf == "urlopen" and root in ("urllib.request", "request", ""):
        return "HTTP I/O (urlopen)"
    if root == "subprocess" and leaf in ("run", "call", "check_call",
                                         "check_output"):
        return f"subprocess.{leaf}"
    if leaf in _RETRY_FAMILY:
        return f"guarded call ({leaf})"
    if leaf in _GUARDED_WRAPPER_LEAVES and root in _GUARDED_WRAPPER_ROOTS:
        return f"device sync ({leaf})"
    if cname == "torch.cuda.synchronize":
        return "device sync (torch.cuda.synchronize)"
    if leaf in _SYNC_METHODS and isinstance(node.func, ast.Attribute) \
            and not node.args:
        return f"device sync (.{leaf}())"
    if leaf == "result" and len(node.args) <= 1 and not node.keywords \
            and isinstance(node.func, ast.Attribute) \
            and not isinstance(node.func.value, ast.Constant):
        return "Future.result"
    attr = _receiver_attr(node)
    if leaf in ("get", "put") and attr is not None and (
        attr in model.queue_names or "queue" in attr.lower()
    ):
        return f"queue.{leaf}"
    if leaf == "join":
        spelled = (_receiver_spelling(node) or "").lower()
        if (attr is not None and attr in model.thread_names) \
                or "thread" in spelled:
            return "thread join"
    if leaf == "wait" and attr is not None and attr in model.event_names:
        return "Event.wait"
    return None


# --------------------------------------------------------------------------
# the under-lock walker (blocking-under-lock + lock-graph edges)
# --------------------------------------------------------------------------


class _WalkState:
    def __init__(self, graph: LockGraph, findings: "_Sink"):
        self.graph = graph
        self.findings = findings
        self.visited: set[tuple[int, frozenset]] = set()
        self.blocked_seen: set[tuple[str, int, str]] = set()


def _scan_under_locks(
    model: _FileModel,
    fn: FuncNode,
    node: ast.AST,
    held: tuple[str, ...],
    state: _WalkState,
    chain: tuple[str, ...],
) -> None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) \
            and node is not fn:
        return  # nested definitions execute later, not under this lock

    if isinstance(node, (ast.With, ast.AsyncWith)):
        acquired: list[str] = []
        for item in node.items:
            lid = model.lock_id_for(item.context_expr, node)
            if lid is not None:
                kind = model.lock_decls.get(lid)
                state.graph.add_node(lid, kind, model.relpath, node.lineno)
                for h in held:
                    state.graph.add_edge(
                        h, lid, model.relpath, node.lineno,
                        via=" -> ".join(chain) if chain else "direct",
                    )
                acquired.append(lid)
            else:
                _scan_under_locks(model, fn, item.context_expr, held, state,
                                  chain)
        new_held = held + tuple(acquired)
        for stmt in node.body:
            _scan_under_locks(model, fn, stmt, new_held, state, chain)
        return

    if isinstance(node, ast.Call):
        if held:
            kind = _blocking_kind(model, node)
            if kind is not None:
                key = (model.relpath, node.lineno, kind)
                if key not in state.blocked_seen:
                    state.blocked_seen.add(key)
                    via = (f" (reached via {' -> '.join(chain)})"
                           if chain else "")
                    state.findings.add(
                        model.ctx, "blocking-under-lock", node,
                        f"blocking call {kind} while holding "
                        f"{', '.join(held)}{via} — every thread needing the "
                        "lock stalls behind this wait; move the blocking "
                        "call outside the critical section or bound it",
                    )
            for callee in model.same_file_callees(node):
                vkey = (id(callee), frozenset(held))
                if vkey not in state.visited:
                    state.visited.add(vkey)
                    fname = getattr(callee, "name", "<lambda>")
                    body = callee.body if isinstance(callee.body, list) \
                        else [callee.body]
                    for stmt in body:
                        _scan_under_locks(
                            model, callee, stmt, held, state,
                            chain + (f"{fname}()",),
                        )

    for child in ast.iter_child_nodes(node):
        _scan_under_locks(model, fn, child, held, state, chain)


def _reachable_acquisitions(model: _FileModel,
                            roots: list[FuncNode]) -> set[str]:
    """Every lock id acquired by ``roots`` or their same-file callees
    (thread-target reachability — like tier 1's ``_thread_targets`` but
    also resolving ``self.method()`` calls)."""
    acquired: set[str] = set()
    seen: set[int] = set()
    stack = list(roots)
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in _walk_own(stmt):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lid = model.lock_id_for(item.context_expr, node)
                        if lid is not None:
                            acquired.add(lid)
                elif isinstance(node, ast.Call):
                    stack.extend(model.same_file_callees(node))
    return acquired


# --------------------------------------------------------------------------
# finding sink (suppression-aware)
# --------------------------------------------------------------------------


class _Sink:
    def __init__(self) -> None:
        self.findings: list[Finding] = []
        self._seen: set[tuple] = set()

    def add(self, ctx: FileContext, rule: str, node: ast.AST | None,
            message: str, *, path: str | None = None,
            line: int | None = None) -> None:
        path = path or ctx.relpath
        line = line if line is not None else getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) if node is not None else 0
        if ctx.is_suppressed(rule, line):
            return
        key = (rule, path, line, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(
            Finding(rule=rule, path=path, line=line, col=col,
                    message=message, snippet=ctx.snippet(line))
        )


# --------------------------------------------------------------------------
# lock-order cycles
# --------------------------------------------------------------------------


def _find_cycles(graph: LockGraph) -> list[list[str]]:
    """Strongly connected components of size > 1, plus self-loops on
    non-reentrant locks."""
    adj: dict[str, set[str]] = {}
    for (a, b) in graph.edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                out.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    for (a, b) in graph.edges:
        if a == b and graph.nodes.get(a, {}).get("kind") == "Lock":
            out.append([a])
    return out


def _check_lock_cycles(graph: LockGraph, models: dict[str, _FileModel],
                       sink: _Sink) -> None:
    for comp in _find_cycles(graph):
        comp_set = set(comp)
        cyc_edges = [
            ((a, b), meta) for (a, b), meta in graph.edges.items()
            if a in comp_set and b in comp_set
        ]
        if not cyc_edges:
            continue
        (a, b), meta = min(
            cyc_edges, key=lambda e: (e[1]["path"], e[1]["line"])
        )
        model = models.get(meta["path"])
        if model is None:
            continue
        if len(comp) == 1:
            msg = (
                f"non-reentrant lock {comp[0]} is re-acquired while already "
                "held — self-deadlock; use an RLock or restructure the "
                "critical section"
            )
        else:
            msg = (
                "lock-order cycle: " + " -> ".join(comp + [comp[0]]) +
                " — threads taking these locks in different orders can "
                "deadlock; impose one global acquisition order"
            )
        sink.add(model.ctx, "lock-order-cycle", None, msg,
                 path=meta["path"], line=meta["line"])


# --------------------------------------------------------------------------
# use-after-donate
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _DonationContract:
    rows: tuple  # (leaf, argnums, entries)
    entries: dict  # entry name -> donate argnums (non-empty only)
    path: Path | None  # the registry file resolved
    relpath: str | None  # repo-relative, when under the scanned root
    row_line: int  # lineno of the DONATED_CALLEES assignment
    entry_lines: dict  # entry name -> lineno of its EntryPoint(...) call


_contract_cache: dict[str, _DonationContract | None] = {}


def _parse_contract(path: Path) -> tuple | None:
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    rows: tuple = ()
    row_line = 1
    entries: dict = {}
    entry_lines: dict = {}
    for node in ast.walk(tree):
        dc_value: ast.expr | None = None
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "DONATED_CALLEES"
            for t in node.targets
        ):
            dc_value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.target, ast.Name) and \
                node.target.id == "DONATED_CALLEES":
            dc_value = node.value
        if dc_value is not None:
            row_line = node.lineno
            parsed = []
            if isinstance(dc_value, (ast.Tuple, ast.List)):
                for row in dc_value.elts:
                    if not isinstance(row, (ast.Tuple, ast.List)) \
                            or len(row.elts) != 3:
                        continue
                    leaf_n, argn_n, ents_n = row.elts
                    if not (isinstance(leaf_n, ast.Constant)
                            and isinstance(leaf_n.value, str)):
                        continue
                    argnums = tuple(
                        e.value for e in getattr(argn_n, "elts", [])
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, int)
                    )
                    ents = tuple(
                        e.value for e in getattr(ents_n, "elts", [])
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    )
                    parsed.append((leaf_n.value, argnums, ents))
            rows = tuple(parsed)
        elif isinstance(node, ast.Call):
            cname = call_name(node) or ""
            if cname.rsplit(".", 1)[-1] != "EntryPoint":
                continue
            name = None
            donate: tuple | None = None
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    name = kw.value.value
                elif kw.arg == "donate" and isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    donate = tuple(
                        e.value for e in kw.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, int)
                    )
            if name and donate:
                entries[name] = donate
                entry_lines[name] = node.lineno
    return rows, entries, row_line, entry_lines


def _donation_contract(root: Path) -> _DonationContract | None:
    key = str(root)
    if key in _contract_cache:
        return _contract_cache[key]
    candidates = [
        (root / "page_rank_and_tfidf_using_apache_spark_tpu_torch/analysis/registry.py",
         True),
        (root / "analysis/registry.py", True),
        (Path(__file__).resolve().parent / "registry.py", False),
    ]
    contract = None
    for path, in_root in candidates:
        if path.exists():
            parsed = _parse_contract(path)
            if parsed is None:
                continue
            rows, entries, row_line, entry_lines = parsed
            relpath = None
            if in_root:
                try:
                    relpath = path.resolve().relative_to(
                        root.resolve()
                    ).as_posix()
                except ValueError:
                    relpath = path.as_posix()
            contract = _DonationContract(
                rows=rows, entries=entries, path=path, relpath=relpath,
                row_line=row_line, entry_lines=entry_lines,
            )
            break
    _contract_cache[key] = contract
    return contract


def _validate_contract(contract: _DonationContract,
                       models: dict[str, _FileModel], sink: _Sink) -> None:
    """Both directions: every donating entry served by a row; every row
    entry real and argnum-consistent.  Anchored at the registry file —
    only when it lives under the scanned root."""
    if contract.relpath is None:
        return
    model = models.get(contract.relpath)
    if model is None:
        return
    served: dict[str, tuple] = {}
    for leaf, argnums, ents in contract.rows:
        for e in ents:
            served[e] = argnums
    for name, donate in sorted(contract.entries.items()):
        if name not in served:
            sink.add(
                model.ctx, "use-after-donate", None,
                f"registry entry {name!r} declares donate={list(donate)} "
                "but no DONATED_CALLEES row serves it — the tier-4 "
                "liveness analyzer cannot see its call sites; add the "
                "callee-leaf convention to the contract",
                line=contract.entry_lines.get(name, contract.row_line),
            )
        elif served[name] != donate:
            sink.add(
                model.ctx, "use-after-donate", None,
                f"DONATED_CALLEES serves entry {name!r} with argnums "
                f"{list(served[name])} but the registry declares "
                f"donate={list(donate)} — the lexical contract drifted",
                line=contract.row_line,
            )
    for leaf, argnums, ents in contract.rows:
        for e in ents:
            if e not in contract.entries:
                sink.add(
                    model.ctx, "use-after-donate", None,
                    f"DONATED_CALLEES row {leaf!r} names entry {e!r} which "
                    "no EntryPoint declares with a non-empty donate — "
                    "stale contract row; fix or drop it",
                    line=contract.row_line,
                )


def _stmt_binds(node: ast.AST) -> set[str]:
    names: set[str] = set()

    def targets_of(t: ast.expr) -> Iterator[str]:
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from targets_of(e)
        elif isinstance(t, ast.Starred):
            yield from targets_of(t.value)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            names.update(targets_of(t))
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        names.update(targets_of(node.target))
    elif isinstance(node, (ast.For, ast.AsyncFor)):
        names.update(targets_of(node.target))
    return names


def _enclosing_stmt(ctx: FileContext, node: ast.AST) -> ast.AST:
    cur: ast.AST = node
    while True:
        parent = ctx.parents.get(cur)
        if parent is None or isinstance(parent, (
            ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module,
        )):
            return cur
        if isinstance(cur, ast.stmt):
            return cur
        cur = parent


def _check_use_after_donate_fn(model: _FileModel, fn: FuncNode,
                               leaf_map: dict, sink: _Sink) -> None:
    ctx = model.ctx
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    nodes = []
    for stmt in body:
        nodes.extend(_walk_own(stmt))
    nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                              getattr(n, "col_offset", 0)))

    consumed: dict[str, tuple[int, str]] = {}  # name -> (line, callee leaf)
    # A rebind kills the taint only for STRICTLY LATER lines: the
    # rebinding statement's own RHS still reads the old (dead) binding —
    # ``carry = np.asarray(carry)`` after a consume must flag — so the
    # kill is deferred past the binding line instead of applied in place.
    kill_line: dict[str, int] = {}

    for node in nodes:
        line = getattr(node, "lineno", 0)

        for name, kl in list(kill_line.items()):
            if line > kl:
                consumed.pop(name, None)
                del kill_line[name]

        binds = _stmt_binds(node)
        for name in list(consumed):
            if name in binds and line > consumed[name][0]:
                kill_line[name] = min(kill_line.get(name, line), line)

        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        leaf = cname.rsplit(".", 1)[-1] if cname else (
            node.func.attr if isinstance(node.func, ast.Attribute) else None
        )

        # host-side read of a consumed binding
        read_names: set[str] = set()
        if cname in _HOST_READ_CALLS:
            for a in node.args:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.Name):
                        read_names.add(sub.id)
        elif leaf in _HOST_READ_METHODS and not node.args and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name):
            read_names.add(node.func.value.id)
        for name in read_names:
            if name in consumed and line > consumed[name][0]:
                cline, cleaf = consumed[name]
                sink.add(
                    ctx, "use-after-donate", node,
                    f"host-side read of {name!r} after {cleaf}() consumed "
                    f"it at line {cline} (donated operand) — the buffer is "
                    "dead after dispatch; read the kernel's OUTPUT binding "
                    "or pull before donating",
                )

        if leaf not in leaf_map:
            continue
        argnums = leaf_map[leaf]
        stmt = _enclosing_stmt(ctx, node)
        stmt_rebinds = _stmt_binds(stmt)
        for i in argnums:
            if i >= len(node.args):
                continue
            arg = node.args[i]
            if not isinstance(arg, ast.Name):
                continue
            name = arg.id
            if name in consumed and line > consumed[name][0]:
                cline, cleaf = consumed[name]
                sink.add(
                    ctx, "use-after-donate", node,
                    f"re-dispatch of {name!r} into {leaf}() after "
                    f"{cleaf}() already consumed it at line {cline} — the "
                    "donated buffer is dead; thread the kernel's returned "
                    "carry instead",
                )
            elif name not in stmt_rebinds:
                # consumed and NOT rebound by this statement: track it
                consumed[name] = (line, leaf)


def _check_retry_closures(model: _FileModel, leaf_map: dict,
                          sink: _Sink) -> None:
    """The ``pagerank_delta_sync`` hazard shape: a donating call
    inside a closure handed to the retry machinery — every retry
    re-dispatches into the buffer the first attempt already consumed."""
    ctx = model.ctx
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        if cname is None or cname.rsplit(".", 1)[-1] not in _RETRY_FAMILY:
            continue
        if not node.args:
            continue
        closure = node.args[0]
        bodies: list[FuncNode] = []
        if isinstance(closure, ast.Lambda):
            bodies = [closure]
        elif isinstance(closure, ast.Name):
            bodies = model.defs_by_name.get(closure.id, [])
        for fn in bodies:
            fn_body = fn.body if isinstance(fn.body, list) else [fn.body]
            assigned_before: set[str] = set()
            flat: list[ast.AST] = []
            for stmt in fn_body:
                flat.extend(_walk_own(stmt))
            flat.sort(key=lambda n: (getattr(n, "lineno", 0),
                                     getattr(n, "col_offset", 0)))
            for sub in flat:
                if isinstance(sub, ast.Call):
                    scname = call_name(sub)
                    sleaf = scname.rsplit(".", 1)[-1] if scname else None
                    if sleaf in leaf_map:
                        for i in leaf_map[sleaf]:
                            if i >= len(sub.args):
                                continue
                            arg = sub.args[i]
                            if isinstance(arg, ast.Name) and \
                                    arg.id not in assigned_before:
                                sink.add(
                                    ctx, "use-after-donate", sub,
                                    f"donating call {sleaf}() inside a "
                                    f"closure passed to {cname} consumes "
                                    f"captured binding {arg.id!r} — a "
                                    "retry re-dispatches into the buffer "
                                    "the first attempt donated (the "
                                    "pagerank_delta_sync hazard); fetch "
                                    "results via their own guarded site "
                                    "and rebuild the carry per attempt",
                                )
                assigned_before |= _stmt_binds(sub)


# --------------------------------------------------------------------------
# chaos-coverage-drift
# --------------------------------------------------------------------------


def _chaos_coverage_tokens(root: Path) -> set[str]:
    names: set[str] = set()
    tests_dir = root / "tests"
    if tests_dir.is_dir():
        for p in sorted(tests_dir.rglob("*.py")):
            try:
                names.update(_CHAOS_TOKEN_RE.findall(
                    p.read_text(encoding="utf-8")))
            except OSError:
                continue
    chaos_sh = root / "tools" / "chaos.sh"
    if chaos_sh.exists():
        try:
            names.update(_CHAOS_TOKEN_RE.findall(
                chaos_sh.read_text(encoding="utf-8")))
        except OSError:
            pass
    return names


def _resolve_site(model: _FileModel, expr: ast.AST,
                  node: ast.AST) -> tuple[str, str] | None:
    """("exact", name) / ("suffix", tail) / None (unresolvable)."""
    ctx = model.ctx
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return ("exact", expr.value)
    if isinstance(expr, ast.JoinedStr):
        last = expr.values[-1] if expr.values else None
        if isinstance(last, ast.Constant) and isinstance(last.value, str) \
                and last.value:
            return ("suffix", last.value)
        return None
    if isinstance(expr, ast.Name):
        if expr.id in model.module_str_consts:
            return ("exact", model.module_str_consts[expr.id])
        fn = ctx.enclosing_function(node)
        if fn is not None and not isinstance(fn, ast.Lambda):
            a = fn.args
            params = a.posonlyargs + a.args
            for p, d in zip(params[len(params) - len(a.defaults):],
                            a.defaults):
                if p.arg == expr.id and isinstance(d, ast.Constant) \
                        and isinstance(d.value, str):
                    return ("exact", d.value)
            for p, d in zip(a.kwonlyargs, a.kw_defaults):
                if p.arg == expr.id and isinstance(d, ast.Constant) \
                        and isinstance(d.value, str):
                    return ("exact", d.value)
            for sub in _walk_own(fn, include_self=False):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name) \
                        and sub.targets[0].id == expr.id:
                    return _resolve_site(model, sub.value, sub)
    return None


def _check_chaos_coverage(models: dict[str, _FileModel], root: Path,
                          sink: _Sink) -> None:
    tokens = _chaos_coverage_tokens(root)
    for relpath, model in sorted(models.items()):
        parts = relpath.split("/")
        if not (set(parts[:-1]) & _GUARDED_TREE_DIRS):
            continue
        for node in ast.walk(model.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            if cname is None:
                continue
            leaf = cname.rsplit(".", 1)[-1]
            root_part = cname[: -len(leaf) - 1] if "." in cname else ""
            guarded = leaf in _RETRY_FAMILY or (
                leaf in _GUARDED_WRAPPER_LEAVES
                and root_part in _GUARDED_WRAPPER_ROOTS
            )
            if not guarded:
                continue
            site_expr = next(
                (kw.value for kw in node.keywords if kw.arg == "site"), None
            )
            if site_expr is None:
                if leaf in _GUARDED_WRAPPER_LEAVES:
                    resolved: tuple[str, str] | None = ("exact", leaf)
                else:
                    resolved = None
            else:
                resolved = _resolve_site(model, site_expr, node)
            if resolved is None:
                sink.add(
                    model.ctx, "chaos-coverage-drift", node,
                    f"guarded call {cname} has no statically-resolvable "
                    "site name — spell the site as a literal (or an "
                    "f-string with a literal suffix) so chaos coverage "
                    "can be cross-referenced",
                )
                continue
            mode, value = resolved
            if mode == "exact":
                covered = value in tokens
                want = value
            else:
                covered = any(t.endswith(value) for t in tokens)
                want = f"*{value}"
            if not covered:
                sink.add(
                    model.ctx, "chaos-coverage-drift", node,
                    f"guarded site {want!r} is exercised by no chaos-"
                    "injection test or tools/chaos.sh scenario — add a "
                    f"fault-injection test (chaos.inject(\"{want}:fail"
                    "@1\")-style) proving its retry/recovery path, or "
                    "suppress with a justification",
                )


# --------------------------------------------------------------------------
# thread-lock-drift
# --------------------------------------------------------------------------


def _canon_lock(declared: str, module: str) -> str:
    return declared if "::" in declared else f"{module}::{declared}"


def _check_thread_locks(models: dict[str, _FileModel], root: Path,
                        graph: LockGraph, sink: _Sink) -> None:
    rows = thread_registry_rows(root)
    for relpath, model in sorted(models.items()):
        ctx = model.ctx
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in ("threading.Thread", "Thread"):
                continue
            name_expr = next(
                (kw.value for kw in node.keywords if kw.arg == "name"), None
            )
            resolved = resolve_thread_name(ctx, name_expr, node)
            target_expr = next(
                (kw.value for kw in node.keywords if kw.arg == "target"), None
            )
            targets: list[FuncNode] = []
            if isinstance(target_expr, ast.Lambda):
                targets = [target_expr]
            elif isinstance(target_expr, ast.Name):
                targets = model.defs_by_name.get(target_expr.id, [])
            elif isinstance(target_expr, ast.Attribute) and \
                    isinstance(target_expr.value, ast.Name) and \
                    target_expr.value.id == "self":
                targets = model.defs_by_name.get(target_expr.attr, [])
            if not targets:
                continue
            acquired = _reachable_acquisitions(model, targets)
            if resolved is not None:
                graph.threads.append({
                    "name": resolved, "module": relpath,
                    "line": node.lineno, "locks": sorted(acquired),
                })
            if resolved is None or rows is None:
                continue  # tier 1's thread-registry-drift owns naming
            matched = [
                r for r in rows
                if len(r) >= 2 and _names_match(resolved, r[0])
                and r[1] == relpath
            ]
            if not matched:
                continue
            declared: set[str] = set()
            for r in matched:
                locks = r[2] if len(r) >= 3 else ()
                declared |= {_canon_lock(l, relpath) for l in locks}
            for lid in sorted(acquired - declared):
                sink.add(
                    ctx, "thread-lock-drift", node,
                    f"thread {resolved!r} acquires lock {lid} which its "
                    "THREAD_REGISTRY row does not declare — add the lock "
                    "to the declaration (and review the ordering) or "
                    "confine it away from this thread",
                )


# --------------------------------------------------------------------------
# the tier-4 runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ConcResult:
    findings: list[Finding]
    graph: LockGraph

    @property
    def ok(self) -> bool:
        return not self.findings


def run_concurrency(
    root: Path | None = None,
    paths: "list[Path] | None" = None,
    only_modules: "set[str] | None" = None,
) -> ConcResult:
    """Run the tier-4 concurrency analysis.

    The repo-wide model is always built over the full ``paths`` surface
    (defaults to the tier-1 surface) — interprocedural facts do not
    restrict — but with ``only_modules`` given, findings are filtered to
    those repo-relative paths (the ``--changed-only`` fast path; the
    model build is pure AST and costs well under a second).
    """
    root = root or repo_root()
    targets = paths if paths is not None else default_targets(root)

    models: dict[str, _FileModel] = {}
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
        ctx = FileContext(rel, source, tree, root=root)
        models[rel] = _FileModel(ctx)

    sink = _Sink()
    graph = LockGraph()

    # declared locks are graph nodes even when never acquired under another
    for model in models.values():
        for lid, kind in model.lock_decls.items():
            graph.add_node(lid, kind, model.relpath, 1)

    # blocking-under-lock + edge collection
    for model in models.values():
        state = _WalkState(graph, sink)
        for fn in model.all_funcs:
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                _scan_under_locks(model, fn, stmt, (), state, ())
        # module-level with-blocks
        for stmt in model.ctx.tree.body:
            _scan_under_locks(model, model.ctx.tree, stmt, (),  # type: ignore[arg-type]
                              state, ())

    _check_lock_cycles(graph, models, sink)

    # use-after-donate
    contract = _donation_contract(root)
    if contract is not None:
        _validate_contract(contract, models, sink)
        leaf_map = {leaf: argnums for leaf, argnums, _ in contract.rows}
        if leaf_map:
            for model in models.values():
                for fn in model.all_funcs:
                    _check_use_after_donate_fn(model, fn, leaf_map, sink)
                _check_retry_closures(model, leaf_map, sink)

    _check_chaos_coverage(models, root, sink)
    _check_thread_locks(models, root, graph, sink)

    findings = sink.findings
    if only_modules is not None:
        findings = [f for f in findings if f.path in only_modules]
    return ConcResult(findings=assign_fingerprints(findings), graph=graph)
