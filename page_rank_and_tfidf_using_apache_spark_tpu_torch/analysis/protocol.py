"""Tier 6 of the port's linter: distributed wire-protocol analysis.

A copy of the JAX package's ``analysis/protocol.py``; its ``_PKG``, and
with it ``SCAN_MODULES``, names the port's ``serving/fabric.py``,
``obs/export.py`` and ``cli/serve.py``, and its contract is the port's
``analysis/registry.py WIRE_SCHEMAS``.

Spark's RPC layer is a *checked* contract: every message class is a
serializable case class both endpoints compile against, and
``TransportConf`` pins the retry/timeout policy next to the transport —
an executor cannot invent a status its driver does not classify.  The
serving fabric re-created that surface as an informal
convention spread across ``serving/fabric.py``: endpoints, status codes,
request-id replay, and the generation floor are conventions the router
and replica merely *agree* on.  A drifted status code is a
dropped-request class — the router's retry loop can only classify what
it knows about — and a side effect ahead of the request-id dedup guard
silently breaks the dropped=0 / double_served=0 audit the fleet is built
on.

Tier 6 is the static gate for that defect class.  Like tiers 1, 4 and 5
it is stdlib-only — pure AST over the wire surface (``serving/fabric.py``,
``obs/export.py``, ``cli/serve.py``), no torch import, whole-repo well
under the declared ``GRAFT_PROTO_BUDGET_S`` budget — driven by the
``analysis/registry.py WIRE_SCHEMAS`` contract and validated BOTH
directions, the ``DONATED_CALLEES``/``ARTIFACT_SCHEMAS`` style:

- **endpoint-contract-drift** — a handler returns a status code or
  writes a response key the contract does not declare; the router reads
  an undeclared response key or posts an undeclared request key; a
  declared code/key no code emits/reads; a ``routes=`` registration
  missing from the contract or a contract row naming no real route.
- **status-class-drift** — every declared status code must carry a
  router-side class (``success``/``terminal``/``retryable``/``suspect``)
  consistent with the router's lexical retry logic: a code the router
  raises on must be declared terminal, a retryable code must not be
  raised on, and 503 (replica below the generation floor / shutting
  down) MUST be retryable — the poll loop catches the replica up, a
  terminal 503 would drop the request.
- **retry-unsafe-effect** — any side effect lexically reachable from a
  replayed route's handler (counter mutation, latency append, cache
  write, a seal/commit call; same-file call propagation as in tier 4)
  must sit *behind* the request-id dedup guard — an effect ahead of the
  guard executes twice when the router re-dispatches a rid.
- **floor-monotonicity** — the floor writer (``commit_floor``) must
  stage + ``durable_replace`` (never a raw rename), and every store to a
  ``.floor`` attribute outside ``__init__`` must be guarded by an upward
  comparison (or a ``max(...)``): the generation floor only ratchets up.

The model also *derives* the tier's dynamic proof:
:func:`enumerate_message_space` walks the contract plus the handler's
lexical request parse (subscript = required key, ``.get`` = optional)
and lists every malformed / out-of-contract / duplicate-rid /
stale-floor probe ``tools/protocol_harness.py`` replays at a live
replica, asserting typed rejection — never a hang, never a second
execution.  :func:`wire_fingerprint` hashes the parsed contract so a
measurement can stamp which protocol generation its fabric numbers were
taken against.

Findings flow through the same suppression (``# graftlint:
disable=<rule>``) and fingerprint/baseline/ratchet machinery as every
other tier.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
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
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import (
    Finding,
    assign_fingerprints,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.persistence import (
    _collect_read,
    _collect_written,
    _literal_strings,
    _resolve_str,
    _split_spec,
)

PROTO_RULES: dict[str, str] = {
    "endpoint-contract-drift": (
        "handler/router wire surface drifted from the declared "
        "WIRE_SCHEMAS contract: an undeclared status code or "
        "request/response key is emitted or read, a declared one is "
        "dead, or a registered route and the contract disagree"
    ),
    "status-class-drift": (
        "a declared status code's retry class contradicts the router's "
        "lexical retry logic (or is missing/unknown) — an unclassified "
        "or misclassified code is a dropped-request class; 503-below-"
        "floor must be retryable"
    ),
    "retry-unsafe-effect": (
        "a side effect reachable from a replayed route sits ahead of "
        "the request-id dedup guard — a router re-dispatch would "
        "execute it twice (double-serve / double-count)"
    ),
    "floor-monotonicity": (
        "the generation-floor writer bypasses durable_replace, or a "
        ".floor store is not guarded by an upward comparison — the "
        "floor only ratchets up, and never through a torn write"
    ),
}

_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"

# The wire surface this tier always parses, contract rows aside.
SCAN_MODULES: tuple[str, ...] = (
    f"{_PKG}/serving/fabric.py",
    f"{_PKG}/obs/export.py",
    f"{_PKG}/cli/serve.py",
)

_STATUS_CLASSES = frozenset({"success", "terminal", "retryable", "suspect"})

# The request-id dedup guard attribute(s): a replayed route's handler must
# consult one of these before any side effect executes.
_DEDUP_GUARDS = frozenset({"_rid_cache"})

# Floor-protocol leaves (shared convention with tier 5's fabric_floor
# ARTIFACT_SCHEMAS row and the crash harness's 'floor' scenario).
_FLOOR_WRITERS = frozenset({"commit_floor"})
_DURABLE_LEAVES = frozenset({"durable_replace"})

# Mutating-call leaves that count as side effects inside a replay handler
# (receiver-attribute mutations), and commit-protocol leaves that always do.
_MUTATOR_LEAVES = frozenset({"append", "appendleft", "add", "update",
                             "extend", "insert", "setdefault"})
_COMMIT_LEAVES = frozenset({"commit_append", "commit_replace",
                            "commit_floor", "seal_segment",
                            "merge_segments"})


# --------------------------------------------------------------------------
# the declared wire contract (parsed lexically from the registry)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireRow:
    endpoint: str
    method: str
    path: str
    handler: str
    readers: tuple
    request_keys: tuple
    response_keys: tuple
    aux_keys: tuple
    status_classes: tuple  # ((code:int, class:str), ...)


@dataclasses.dataclass(frozen=True)
class WireContract:
    rows: tuple  # WireRow rows
    relpath: str | None  # registry path when under the scanned root
    line: int


def _literal_status_pairs(node: ast.AST, consts: dict[str, str]) -> tuple:
    """``((200, "success"), ...)`` rows: int-literal code + class string."""
    out = []
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            if not isinstance(e, (ast.Tuple, ast.List)) or len(e.elts) != 2:
                continue
            code_node, cls_node = e.elts
            cls = _resolve_str(cls_node, consts)
            if isinstance(code_node, ast.Constant) and \
                    isinstance(code_node.value, int) and cls is not None:
                out.append((code_node.value, cls))
    return tuple(out)


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
    for node in ast.walk(tree):
        value: ast.expr | None = None
        name: str | None = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.target, ast.Name):
            name, value = node.target.id, node.value
        if name != "WIRE_SCHEMAS" or \
                not isinstance(value, (ast.Tuple, ast.List)):
            continue
        rows = []
        for row in value.elts:
            if not isinstance(row, (ast.Tuple, ast.List)) or \
                    len(row.elts) != 9:
                continue
            endpoint = _resolve_str(row.elts[0], consts)
            method = _resolve_str(row.elts[1], consts)
            rpath = _resolve_str(row.elts[2], consts)
            handler = _resolve_str(row.elts[3], consts)
            if None in (endpoint, method, rpath, handler):
                continue
            rows.append(WireRow(
                endpoint=endpoint,
                method=method,
                path=rpath,
                handler=handler,
                readers=_literal_strings(row.elts[4], consts),
                request_keys=_literal_strings(row.elts[5], consts),
                response_keys=_literal_strings(row.elts[6], consts),
                aux_keys=_literal_strings(row.elts[7], consts),
                status_classes=_literal_status_pairs(row.elts[8], consts),
            ))
        return tuple(rows), node.lineno
    return None


_contract_cache: dict[str, WireContract | None] = {}


def wire_contract(root: Path) -> WireContract | None:
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
            rows, line = parsed
            relpath = None
            if in_root:
                try:
                    relpath = path.resolve().relative_to(
                        root.resolve()).as_posix()
                except ValueError:
                    relpath = path.as_posix()
            contract = WireContract(rows=rows, relpath=relpath, line=line)
            break
    _contract_cache[key] = contract
    return contract


def wire_fingerprint(root: Path | None = None) -> str | None:
    """A stable hash of the *parsed* wire contract — the protocol
    generation a measurement's fabric numbers were taken against.
    Formatting-independent: two registries declaring the same rows hash
    identically."""
    root = root or repo_root()
    contract = wire_contract(root)
    if contract is None:
        return None
    doc = json.dumps([dataclasses.astuple(r) for r in contract.rows],
                     sort_keys=True)
    return hashlib.sha256(doc.encode("utf-8")).hexdigest()[:16]


# --------------------------------------------------------------------------
# per-file model
# --------------------------------------------------------------------------


class _WFile:
    """Per-file wire-surface facts (duck-compatible with the tier-5
    collectors: exposes ``iter_scope``/``resolve_def``/``ctx``)."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.relpath = ctx.relpath
        self.defs: dict[str, list[FuncNode]] = {}
        self.def_class: dict[int, str | None] = {}
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

    def resolve_def(self, funcpart: str) -> FuncNode | None:
        cls = None
        name = funcpart
        if "." in funcpart:
            cls, name = funcpart.split(".", 1)
        for fn in self.defs.get(name, []):
            if cls is None or self.def_class.get(id(fn)) == cls:
                return fn
        return None

    def body_of(self, fn: FuncNode | None) -> list[ast.AST]:
        if fn is None:
            return list(self.ctx.tree.body)
        return fn.body if isinstance(fn.body, list) else [fn.body]

    def iter_scope(self, fn: FuncNode | None) -> Iterator[ast.AST]:
        """Nodes lexically in ``fn``'s own scope — without descending
        into nested defs, but *including* lambdas: the router posts its
        request doc through ``attempt_once(lambda: self._post_json(...))``
        and that body executes inline per request, so its keys and
        effects belong to the enclosing function."""

        def walk(node: ast.AST) -> Iterator[ast.AST]:
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                yield from walk(child)

        for stmt in self.body_of(fn):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield from walk(stmt)

    def same_file_callees(self, fn: FuncNode) -> list[tuple[ast.Call, FuncNode]]:
        """(call site, callee def) pairs for bare-name and self-method
        calls resolving inside this file — tier 4's propagation idiom."""
        out: list[tuple[ast.Call, FuncNode]] = []
        for node in self.iter_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            leaf = cname.rsplit(".", 1)[-1] if cname else None
            if leaf is None:
                continue
            if cname != leaf and not (cname == f"self.{leaf}"):
                continue
            for callee in self.defs.get(leaf, []):
                out.append((node, callee))
                break
        return out


def build_models(root: Path,
                 extra: "tuple[str, ...] | None" = None) -> dict[str, _WFile]:
    """Parse the wire surface (SCAN_MODULES + contract-named modules +
    the registry itself) into per-file models.  Tier 6 deliberately does
    NOT model the whole repo: the wire protocol lives on a declared
    surface, and a bounded parse keeps the gate far under its budget."""
    contract = wire_contract(root)
    rels: set[str] = set(SCAN_MODULES)
    if contract is not None:
        if contract.relpath:
            rels.add(contract.relpath)
        for row in contract.rows:
            rels.add(_split_spec(row.handler)[0])
            for spec in row.readers:
                rels.add(_split_spec(spec)[0])
    rels.update(extra or ())
    models: dict[str, _WFile] = {}
    for rel in sorted(rels):
        f = root / rel
        try:
            source = f.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=str(f))
        except (OSError, SyntaxError):
            continue  # tier 1 reports parse errors
        models[rel] = _WFile(FileContext(rel, source, tree, root=root))
    return models


# --------------------------------------------------------------------------
# lexical extraction helpers
# --------------------------------------------------------------------------


def _emitted_codes(model: _WFile, fn: FuncNode) -> dict[int, ast.AST]:
    """Status codes ``fn`` can emit: the int-literal first element of a
    ``(code, ctype, body)`` response tuple (returned directly or staged
    through a local like handle_query's cached ``resp``), or the
    int-literal first argument of a ``_send(code, ...)`` dispatch."""
    out: dict[int, ast.AST] = {}
    for node in model.iter_scope(fn):
        if isinstance(node, ast.Tuple) and \
                isinstance(getattr(node, "ctx", None), ast.Load) and \
                2 <= len(node.elts) <= 3:
            first = node.elts[0]
            if isinstance(first, ast.Constant) and \
                    isinstance(first.value, int) and \
                    100 <= first.value <= 599:
                out.setdefault(first.value, node)
        elif isinstance(node, ast.Call):
            cname = call_name(node) or ""
            if cname.rsplit(".", 1)[-1] == "_send" and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) and \
                        isinstance(first.value, int):
                    out.setdefault(first.value, node)
    return out


def _scope_str_consts(model: _WFile, fn: FuncNode) -> set[str]:
    return {
        n.value for n in model.iter_scope(fn)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def _required_request_keys(model: _WFile, fn: FuncNode,
                           recv: str) -> tuple[set[str], set[str]]:
    """(required, optional) request keys as the handler lexically parses
    them: a ``recv["k"]`` subscript raises KeyError when absent
    (required); a ``recv.get("k", ...)`` carries a default (optional)."""
    required: set[str] = set()
    optional: set[str] = set()
    for node in model.iter_scope(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str) and \
                dotted_name(node.value) == recv:
            required.add(node.slice.value)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                dotted_name(node.func.value) == recv:
            optional.add(node.args[0].value)
    return required, optional


def _registered_routes(models: dict[str, _WFile]) -> dict[tuple, tuple]:
    """``(method, path) -> (model relpath, node)`` for every route
    registered through a ``routes={(method, path): handler}`` literal."""
    out: dict[tuple, tuple] = {}
    for rel in sorted(models):
        model = models[rel]
        for node in ast.walk(model.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg != "routes" or not isinstance(kw.value, ast.Dict):
                    continue
                for k in kw.value.keys:
                    if isinstance(k, ast.Tuple) and len(k.elts) == 2 and \
                            all(isinstance(e, ast.Constant)
                                and isinstance(e.value, str)
                                for e in k.elts):
                        out.setdefault(
                            (k.elts[0].value, k.elts[1].value),
                            (rel, k),
                        )
    return out


def _resolve_spec(models: dict[str, _WFile],
                  spec: str) -> "tuple[_WFile, FuncNode, str | None] | None":
    path, funcpart, recv = _split_spec(spec)
    model = models.get(path)
    fn = model.resolve_def(funcpart) if model is not None else None
    if model is None or fn is None:
        return None
    return model, fn, recv


# --------------------------------------------------------------------------
# check A+B: endpoint-contract-drift / status-class-drift
# --------------------------------------------------------------------------


def _find_router(models: dict[str, _WFile],
                 contract: WireContract) -> "tuple[_WFile, FuncNode] | None":
    """The router function: the first declared reader containing an
    ``except HTTPError`` handler — the retry-classification seat."""
    for row in contract.rows:
        for spec in row.readers:
            resolved = _resolve_spec(models, spec)
            if resolved is None:
                continue
            model, fn, _recv = resolved
            for node in model.iter_scope(fn):
                if isinstance(node, ast.ExceptHandler) and \
                        node.type is not None and \
                        "HTTPError" in ast.dump(node.type):
                    return model, fn
    return None


def _router_terminal_codes(model: _WFile,
                           fn: FuncNode) -> tuple[set[int], bool]:
    """(codes the router raises on, whether a retry fall-through exists)
    extracted from the ``except HTTPError`` handler's lexical shape:
    ``if exc.code == N: ... raise`` marks N terminal; a ``continue``
    anywhere else in the handler is the sibling-retry fall-through."""
    terminal: set[int] = set()
    fallthrough = False
    for node in model.iter_scope(fn):
        if not (isinstance(node, ast.ExceptHandler) and node.type is not None
                and "HTTPError" in ast.dump(node.type)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.If):
                codes = set()
                for cmp_node in ast.walk(sub.test):
                    if isinstance(cmp_node, ast.Compare) and \
                            len(cmp_node.ops) == 1 and \
                            isinstance(cmp_node.ops[0], ast.Eq):
                        for side in (cmp_node.left, *cmp_node.comparators):
                            if isinstance(side, ast.Constant) and \
                                    isinstance(side.value, int):
                                codes.add(side.value)
                if codes and any(isinstance(s, ast.Raise)
                                 for b in sub.body for s in ast.walk(b)):
                    terminal.update(codes)
            elif isinstance(sub, ast.Continue):
                fallthrough = True
    return terminal, fallthrough


def _check_contract(contract: WireContract, models: dict[str, _WFile],
                    sink: _Sink) -> None:
    reg_model = models.get(contract.relpath) if contract.relpath else None

    def reg_finding(rule: str, message: str) -> None:
        if reg_model is not None:
            sink.add(reg_model.ctx, rule, None, message, line=contract.line)

    # ---- per-handler code surfaces (a handler may serve several rows)
    handler_rows: dict[str, list[WireRow]] = {}
    for row in contract.rows:
        hpath, hfunc, _ = _split_spec(row.handler)
        handler_rows.setdefault(f"{hpath}::{hfunc}", []).append(row)

    registered = _registered_routes(models)
    declared_routes = {(r.method, r.path) for r in contract.rows}

    # routes registered in code but missing from the contract
    for (method, rpath), (rel, node) in sorted(registered.items()):
        if (method, rpath) not in declared_routes:
            sink.add(
                models[rel].ctx, "endpoint-contract-drift", node,
                f"route ({method} {rpath}) is registered on the wire "
                "surface but WIRE_SCHEMAS does not declare it — the "
                "router/harness cannot classify its codes; add a row",
            )

    router = _find_router(models, contract)
    terminal_codes: set[int] = set()
    fallthrough = False
    router_fn_id = None
    if router is not None:
        terminal_codes, fallthrough = _router_terminal_codes(*router)
        router_fn_id = id(router[1])

    for hkey, rows in sorted(handler_rows.items()):
        resolved = _resolve_spec(models, rows[0].handler)
        if resolved is None:
            reg_finding(
                "endpoint-contract-drift",
                f"WIRE_SCHEMAS handler {rows[0].handler!r} does not "
                "resolve to a function on the wire surface — stale "
                "contract row",
            )
            continue
        model, fn, recv = resolved

        # declared route must exist: registered, or a path literal the
        # handler itself dispatches on
        consts = _scope_str_consts(model, fn)
        for row in rows:
            if (row.method, row.path) not in registered and \
                    row.path not in consts:
                reg_finding(
                    "endpoint-contract-drift",
                    f"WIRE_SCHEMAS declares {row.method} {row.path} for "
                    f"endpoint {row.endpoint!r} but no routes= "
                    "registration or handler path literal serves it — "
                    "stale contract row",
                )

        # ---- status codes, both directions (unioned across the
        # handler's rows: the dispatcher serves several endpoints)
        declared_codes = {c for row in rows
                          for c, _cls in row.status_classes}
        emitted = _emitted_codes(model, fn)
        for code, node in sorted(emitted.items()):
            if code not in declared_codes:
                sink.add(
                    model.ctx, "endpoint-contract-drift", node,
                    f"handler {hkey.split('::')[-1]}() can emit HTTP "
                    f"{code} which no WIRE_SCHEMAS row declares — an "
                    "unclassified code is a dropped-request class; "
                    "declare it with its retry class",
                )
        for code in sorted(declared_codes - set(emitted)):
            reg_finding(
                "endpoint-contract-drift",
                f"WIRE_SCHEMAS declares HTTP {code} for handler "
                f"{hkey!r} which its code never emits — stale "
                "declaration",
            )

        # ---- status classes vs the router's lexical retry logic
        seen_pairs: set[tuple] = set()
        for row in rows:
            routed = any(
                (r := _resolve_spec(models, spec)) is not None
                and id(r[1]) == router_fn_id
                for spec in row.readers
            )
            for code, cls in row.status_classes:
                if (code, cls) in seen_pairs:
                    continue
                seen_pairs.add((code, cls))
                if cls not in _STATUS_CLASSES:
                    reg_finding(
                        "status-class-drift",
                        f"endpoint {row.endpoint!r}: HTTP {code} carries "
                        f"unknown class {cls!r} (expected one of "
                        f"{sorted(_STATUS_CLASSES)})",
                    )
                    continue
                if code == 503 and cls != "retryable":
                    reg_finding(
                        "status-class-drift",
                        f"endpoint {row.endpoint!r}: HTTP 503 declared "
                        f"{cls!r} — a replica below the generation floor "
                        "catches up via its poll loop; 503 must be "
                        "retryable or floor catch-up becomes a dropped "
                        "request",
                    )
                if not routed:
                    continue
                if cls == "terminal" and code not in terminal_codes:
                    reg_finding(
                        "status-class-drift",
                        f"endpoint {row.endpoint!r}: HTTP {code} is "
                        "declared terminal but the router's HTTPError "
                        "handler never raises on it — it would be "
                        "retried into the retry budget and dropped",
                    )
                if cls == "retryable" and code in terminal_codes:
                    reg_finding(
                        "status-class-drift",
                        f"endpoint {row.endpoint!r}: HTTP {code} is "
                        "declared retryable but the router raises on it "
                        "— a transient refusal becomes a caller-visible "
                        "failure",
                    )
                if cls == "retryable" and not fallthrough:
                    reg_finding(
                        "status-class-drift",
                        f"endpoint {row.endpoint!r}: HTTP {code} is "
                        "declared retryable but the router's HTTPError "
                        "handler has no retry fall-through",
                    )

        # ---- request keys: handler reads vs router writes
        for row in rows:
            if recv is not None and row.request_keys:
                required, optional = _required_request_keys(model, fn, recv)
                reads = required | optional
                keyset = set(row.request_keys)
                for k in sorted(reads - keyset):
                    sink.add(
                        model.ctx, "endpoint-contract-drift", fn,
                        f"handler reads request key {k!r} which endpoint "
                        f"{row.endpoint!r} does not declare — a router "
                        "that never sends it breaks this parse silently",
                        line=fn.lineno,
                    )
                for k in sorted(keyset - reads):
                    reg_finding(
                        "endpoint-contract-drift",
                        f"endpoint {row.endpoint!r}: declared request "
                        f"key {k!r} is read by no handler parse — stale "
                        "declaration",
                    )
            if row.method == "POST" and row.request_keys and row.readers:
                written: dict[str, tuple] = {}
                any_resolved = False
                for spec in row.readers:
                    r = _resolve_spec(models, spec)
                    if r is None:
                        reg_finding(
                            "endpoint-contract-drift",
                            f"endpoint {row.endpoint!r}: declared reader "
                            f"{spec!r} does not resolve on the wire "
                            "surface — stale contract row",
                        )
                        continue
                    any_resolved = True
                    rmodel, rfn, _rrecv = r
                    for k, node in _collect_written(rmodel, rfn).items():
                        written.setdefault(k, (rmodel, node))
                keyset = set(row.request_keys)
                for k, (rmodel, node) in sorted(written.items()):
                    if k not in keyset:
                        sink.add(
                            rmodel.ctx, "endpoint-contract-drift", node,
                            f"router posts request key {k!r} which "
                            f"endpoint {row.endpoint!r} does not declare "
                            "— the handler will silently drop it",
                        )
                if any_resolved:
                    for k in sorted(keyset - set(written)):
                        reg_finding(
                            "endpoint-contract-drift",
                            f"endpoint {row.endpoint!r}: declared "
                            f"request key {k!r} is posted by no declared "
                            "reader — stale declaration",
                        )

        # ---- response keys: handler writes vs reader reads
        for row in rows:
            keyset = set(row.response_keys)
            written = _collect_written(model, fn)
            for k, node in sorted(written.items()):
                if k not in keyset:
                    sink.add(
                        model.ctx, "endpoint-contract-drift", node,
                        f"handler writes response key {k!r} which "
                        f"endpoint {row.endpoint!r} does not declare — "
                        "add it to WIRE_SCHEMAS (and a reader, or mark "
                        "it aux) before shipping it on the wire",
                    )
            if row.response_keys:
                for k in sorted(keyset - set(written)):
                    reg_finding(
                        "endpoint-contract-drift",
                        f"endpoint {row.endpoint!r}: declared response "
                        f"key {k!r} is written by no handler — the "
                        "contract promises a member the wire never "
                        "carries",
                    )
            read: dict[str, tuple] = {}
            any_reader = False
            for spec in row.readers:
                r = _resolve_spec(models, spec)
                if r is None:
                    continue  # stale-reader finding emitted above
                any_reader = True
                rmodel, rfn, rrecv = r
                for k, node in _collect_read(rmodel, rfn, rrecv).items():
                    read.setdefault(k, (rmodel, node))
            for k, (rmodel, node) in sorted(read.items()):
                if k not in keyset:
                    sink.add(
                        rmodel.ctx, "endpoint-contract-drift", node,
                        f"reader loads response key {k!r} which endpoint "
                        f"{row.endpoint!r} does not declare — a handler-"
                        "side rename would break this load path "
                        "silently; declare the key",
                    )
            if any_reader and row.response_keys:
                aux = set(row.aux_keys)
                for k in sorted(keyset - set(read) - aux):
                    reg_finding(
                        "endpoint-contract-drift",
                        f"endpoint {row.endpoint!r}: response key {k!r} "
                        "is served but read by no declared reader — "
                        "dead wire weight, or a reader lost a member it "
                        "needs; mark it aux or wire the reader",
                    )
        for row in rows:
            for a in row.aux_keys:
                if a not in row.response_keys:
                    reg_finding(
                        "endpoint-contract-drift",
                        f"endpoint {row.endpoint!r}: aux key {a!r} is "
                        "not in the declared response key space — stale "
                        "aux entry",
                    )


# --------------------------------------------------------------------------
# check C: retry-unsafe-effect
# --------------------------------------------------------------------------


def _attr_leaf(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return _attr_leaf(node.value)
    return None


def _guard_line(model: _WFile, fn: FuncNode) -> int | None:
    """First lexical consult of a dedup-guard attribute in ``fn``."""
    best: int | None = None
    for node in model.iter_scope(fn):
        if isinstance(node, ast.Attribute) and node.attr in _DEDUP_GUARDS:
            if best is None or node.lineno < best:
                best = node.lineno
    return best


def _effects(model: _WFile, fn: FuncNode,
             depth: int = 0,
             seen: "set[int] | None" = None) -> list[tuple[ast.AST, int, str]]:
    """(node, line-at-call-site, detail) side effects lexically reachable
    from ``fn``: attribute counter mutations, container mutations through
    an attribute receiver, cache writes, commit/seal calls — with
    same-file call propagation (effects in a callee count at the CALL's
    line, tier 4's idiom)."""
    if seen is None:
        seen = set()
    if id(fn) in seen or depth > 3:
        return []
    seen.add(id(fn))
    out: list[tuple[ast.AST, int, str]] = []
    for node in model.iter_scope(fn):
        if isinstance(node, ast.AugAssign):
            leaf = _attr_leaf(node.target)
            if leaf is not None and leaf not in _DEDUP_GUARDS:
                out.append((node, node.lineno, f"{leaf} mutation"))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    leaf = _attr_leaf(t)
                    if leaf is not None and leaf not in _DEDUP_GUARDS:
                        out.append((node, node.lineno, f"{leaf}[...] write"))
        elif isinstance(node, ast.Call):
            cname = call_name(node) or ""
            leaf = cname.rsplit(".", 1)[-1]
            if leaf in _COMMIT_LEAVES:
                out.append((node, node.lineno, f"{leaf}() commit"))
            elif leaf in _MUTATOR_LEAVES and \
                    isinstance(node.func, ast.Attribute):
                recv_leaf = _attr_leaf(node.func.value)
                if recv_leaf is not None and recv_leaf not in _DEDUP_GUARDS:
                    out.append((node, node.lineno, f"{recv_leaf}.{leaf}()"))
    for call, callee in model.same_file_callees(fn):
        for _node, _line, detail in _effects(model, callee, depth + 1, seen):
            out.append((call, call.lineno, f"{detail} via "
                                           f"{callee.name}()"))
    return out


def _check_retry_safety(contract: WireContract, models: dict[str, _WFile],
                        sink: _Sink) -> None:
    for row in contract.rows:
        if "rid" not in row.request_keys:
            continue  # not a replayed route
        resolved = _resolve_spec(models, row.handler)
        if resolved is None:
            continue  # stale-handler finding already emitted
        model, fn, _recv = resolved
        guard = _guard_line(model, fn)
        for node, line, detail in _effects(model, fn):
            if guard is None:
                sink.add(
                    model.ctx, "retry-unsafe-effect", node,
                    f"side effect ({detail}) in replayed endpoint "
                    f"{row.endpoint!r} whose handler never consults a "
                    "request-id dedup guard — a router re-dispatch "
                    "executes it twice",
                )
            elif line < guard:
                sink.add(
                    model.ctx, "retry-unsafe-effect", node,
                    f"side effect ({detail}) executes BEFORE the "
                    f"request-id dedup guard (line {guard}) in replayed "
                    f"endpoint {row.endpoint!r} — a duplicate rid "
                    "double-counts it; move it behind the replay check",
                )


# --------------------------------------------------------------------------
# check D: floor-monotonicity
# --------------------------------------------------------------------------


def _check_floor(models: dict[str, _WFile], sink: _Sink) -> None:
    for rel in sorted(models):
        model = models[rel]
        for name in sorted(_FLOOR_WRITERS):
            for fn in model.defs.get(name, []):
                calls = {
                    (call_name(n) or "").rsplit(".", 1)[-1]
                    for n in model.iter_scope(fn)
                    if isinstance(n, ast.Call)
                }
                if not (calls & _DURABLE_LEAVES):
                    sink.add(
                        model.ctx, "floor-monotonicity", fn,
                        f"{name}() writes the generation floor without "
                        "durable_replace — a torn floor file reads as 0 "
                        "and un-fences every pre-floor replica",
                        line=fn.lineno,
                    )
                for n in model.iter_scope(fn):
                    if isinstance(n, ast.Call) and \
                            call_name(n) == "os.replace":
                        sink.add(
                            model.ctx, "floor-monotonicity", n,
                            f"{name}() uses raw os.replace — the floor "
                            "is pointer-visible state; use "
                            "utils/checkpoint.durable_replace so no "
                            "replica can read an unsynced floor",
                        )
        # every `.floor` attribute store outside __init__ must ratchet up
        for node in ast.walk(model.ctx.tree):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "floor"):
                continue
            encl = model.ctx.enclosing_function(node)
            if encl is not None and encl.name == "__init__":
                continue  # initial load, not a ratchet step
            if _floor_store_guarded(model, node):
                continue
            sink.add(
                model.ctx, "floor-monotonicity", node,
                "store to a .floor attribute without an upward-"
                "comparison guard (if new > current, or max(...)) — the "
                "generation floor only ratchets up; a downward store "
                "re-admits pre-floor artifacts mid-roll",
            )


def _floor_store_guarded(model: _WFile, node: ast.Assign) -> bool:
    if isinstance(node.value, ast.Call):
        cname = call_name(node.value) or ""
        if cname.rsplit(".", 1)[-1] == "max":
            for arg in node.value.args:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Attribute) and \
                            sub.attr == "floor":
                        return True
    cur = model.ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.If, ast.While)):
            for sub in ast.walk(cur.test):
                if isinstance(sub, ast.Compare) and any(
                    isinstance(op, (ast.Gt, ast.GtE, ast.Lt, ast.LtE))
                    for op in sub.ops
                ):
                    mentions_floor = any(
                        isinstance(s, ast.Attribute) and s.attr == "floor"
                        for side in (sub.left, *sub.comparators)
                        for s in ast.walk(side)
                    )
                    if mentions_floor:
                        return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break
        cur = model.ctx.parents.get(cur)
    return False


# --------------------------------------------------------------------------
# message-space enumeration (the derived dynamic fixture set)
# --------------------------------------------------------------------------


def enumerate_message_space(
    root: Path | None = None,
    models: "dict[str, _WFile] | None" = None,
) -> list[dict]:
    """Every probe the conformance harness replays, derived from the
    declared contract plus the handler's lexical request parse: malformed
    syntax/shape, each required key dropped, an out-of-contract path and
    method, a duplicate request id, and a stale-generation floor.  Each
    probe lists the status codes a conforming endpoint may answer with
    (the dispatcher's 404/500 catch-alls are always admissible)."""
    root = root or repo_root()
    if models is None:
        models = build_models(root)
    contract = wire_contract(root)
    if contract is None:
        return []
    probes: list[dict] = []
    declared_paths = set()
    for row in contract.rows:
        declared_paths.add(row.path)
        codes = sorted(c for c, _cls in row.status_classes)
        success = sorted(c for c, cls in row.status_classes
                         if cls == "success")
        base = {"endpoint": row.endpoint, "method": row.method,
                "path": row.path}
        required: set[str] = set()
        optional: set[str] = set()
        resolved = _resolve_spec(models, row.handler)
        if resolved is not None and resolved[2] is not None:
            required, optional = _required_request_keys(
                resolved[0], resolved[1], resolved[2])
        if row.method == "POST" and row.request_keys:
            probes.append({**base, "kind": "malformed-syntax",
                           "body": "{not json", "expect": [400]})
            probes.append({**base, "kind": "malformed-shape",
                           "body": "[]", "expect": [400]})
            for k in sorted(required & set(row.request_keys)):
                probes.append({**base, "kind": f"missing-{k}",
                               "drop_key": k, "expect": [400]})
            for k in sorted(optional & set(row.request_keys)):
                probes.append({**base, "kind": f"optional-{k}",
                               "drop_key": k, "expect": success or codes})
            probes.append({**base, "kind": "undeclared-key",
                           "extra_key": "__undeclared__",
                           "expect": success or codes})
        # method flip: the (method, path) route vanishes -> dispatcher 404
        flip = "GET" if row.method == "POST" else "POST"
        probes.append({**base, "kind": "wrong-method", "method": flip,
                       "expect": [404]})
        if "rid" in row.request_keys:
            probes.append({**base, "kind": "duplicate-rid",
                           "expect": success or codes})
            # unconditional: every replayed route sits behind the
            # generation floor.  The answer must ALSO be in the row's
            # declared code set — so a contract that forgets to declare
            # 503 fails the harness here, not just the static check.
            probes.append({**base, "kind": "stale-floor",
                           "expect": [503]})
        probes.append({**base, "kind": "declared-codes", "codes": codes})
    probes.append({"endpoint": None, "method": "GET",
                   "path": "/__out_of_contract__", "kind": "unknown-path",
                   "expect": [404]})
    return probes


# --------------------------------------------------------------------------
# the tier-6 runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ProtoResult:
    findings: list[Finding]
    monitored: list[str]

    @property
    def ok(self) -> bool:
        return not self.findings


def run_protocol(
    root: Path | None = None,
    only_modules: "set[str] | None" = None,
    models: "dict[str, _WFile] | None" = None,
) -> ProtoResult:
    """Run the tier-6 wire-protocol analysis.

    The model is always built over the full declared wire surface — a
    contract has handlers and readers in different files — and
    ``only_modules`` only filters which files may report findings (the
    ``--changed-only`` fast path)."""
    root = root or repo_root()
    if models is None:
        models = build_models(root)
    contract = wire_contract(root)

    sink = _Sink()
    if contract is not None:
        _check_contract(contract, models, sink)
        _check_retry_safety(contract, models, sink)
    _check_floor(models, sink)

    findings = sink.findings
    if only_modules is not None:
        findings = [f for f in findings if f.path in only_modules]
    return ProtoResult(findings=assign_fingerprints(findings),
                       monitored=sorted(models))
