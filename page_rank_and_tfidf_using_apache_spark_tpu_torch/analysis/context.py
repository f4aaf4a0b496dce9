"""Per-file AST context shared by every rule of the port's linter.

Counterpart of the JAX package's ``analysis/context.py``.  The rules all
need the same structural facts about a module:

- which function bodies are *step contexts* — the functions the port hands
  to its loop driver ``dataflow/fixpoint.iterate`` as ``step`` (its first
  argument, or ``step=``) and ``delta_fn=``, plus (same-file,
  call-by-name) functions reachable from those — because the driver runs
  them once a step, so a host sync there stalls the device every step.
  The JAX package's counterparts are functions under ``jax.jit`` and the
  bodies handed to the ``lax`` loop combinators;
- which names inside a step context hold *tensors* (a light forward taint
  from the step's parameters that have no default — the carries the
  driver passes in — sanitized through ``.shape`` / ``.ndim`` /
  ``.dtype`` / ``.device``, ``len()`` and the metadata methods
  ``.numel()`` / ``.size()`` / ``.dim()``, which read no device memory);
- where ``# graftlint: disable=...`` suppression comments sit.

Everything is lexical + same-file by design: the linter is a ratchet, not a
verifier, and a cheap analysis that never imports the code under scan (so
it runs even when torch is broken or absent) beats a precise one that
cannot.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator

FuncNode = ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda

# Attribute accesses that read a tensor's metadata, never its memory.
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda"})
# Builtins whose result is static regardless of argument tracedness.
STATIC_CALLS = frozenset({"len", "isinstance", "type", "id", "repr", "str"})
# Tensor methods that read metadata only.
STATIC_METHODS = frozenset({
    "numel", "nelement", "size", "dim", "ndimension", "stride",
    "element_size", "is_floating_point", "is_contiguous", "get_device",
    "data_ptr",
})

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable(?P<file>-file)?(?:=(?P<ids>[A-Za-z0-9_,\- ]+))?"
)

# The port's loop drivers: callee leaf -> (positional index, keyword) of
# each argument that is a callable the driver runs once a step (every
# parameter of those callables without a default receives a carry).
LOOP_DRIVERS: dict[str, tuple[tuple[int | None, str], ...]] = {
    "iterate": ((0, "step"), (None, "delta_fn")),
}


def dotted_name(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def param_names(fn: FuncNode) -> list[str]:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def carry_param_names(fn: FuncNode) -> list[str]:
    """The parameters a loop driver fills: positional ones without a
    default (a default binds a host constant, ``lambda r, dg=dg: ...``)."""
    a = fn.args
    params = a.posonlyargs + a.args
    n_plain = len(params) - len(a.defaults)
    return [p.arg for p in params[:n_plain]]


class FileContext:
    """All the per-file facts rules consume."""

    def __init__(
        self,
        relpath: str,
        source: str,
        tree: ast.Module,
        root: "Path | None" = None,
    ):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # Repository root of the scanned tree, for the few rules that need
        # one cross-file fact (e.g. env-knob-drift reads the declared knob
        # set out of utils/config.py).  None for bare snippet lints.
        self.root = root

        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

        # suppressions
        self.line_suppressions: dict[int, set[str]] = {}
        self.file_suppressions: set[str] = set()
        for lineno, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            ids = (
                {s.strip() for s in m.group("ids").split(",") if s.strip()}
                if m.group("ids")
                else {"all"}
            )
            if m.group("file"):
                self.file_suppressions |= ids
            else:
                self.line_suppressions.setdefault(lineno, set()).update(ids)

        # step contexts
        self.step_bodies: set[FuncNode] = set()
        self._find_step_bodies()
        self.step_context_funcs: set[FuncNode] = set(self.step_bodies)
        self._propagate_reachability()

        # names whose calls run a step: a driver's own step callables
        # (``step(carry)`` inside ``def iterate(step, ...)``) and the
        # same-file defs handed to a driver
        self.step_value_names: set[str] = {
            fn.name for fn in self.step_bodies
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for fn in self._functions():
            if isinstance(fn, ast.Lambda) or fn.name not in LOOP_DRIVERS:
                continue
            params = set(param_names(fn))
            for _pos, kw in LOOP_DRIVERS[fn.name]:
                if kw in params:
                    self.step_value_names.add(kw)

    # ------------------------------------------------------------------ build

    def _functions(self) -> Iterator[FuncNode]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                yield node

    def _defs_by_name(self) -> dict[str, list[FuncNode]]:
        defs_by_name: dict[str, list[FuncNode]] = {}
        for fn in self._functions():
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(fn.name, []).append(fn)
        return defs_by_name

    def _find_step_bodies(self) -> None:
        defs_by_name = self._defs_by_name()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node)
            if cname is None:
                continue
            leaf = cname.rsplit(".", 1)[-1]
            if leaf not in LOOP_DRIVERS:
                continue
            args: list[ast.expr] = []
            for pos, kw in LOOP_DRIVERS[leaf]:
                if pos is not None and pos < len(node.args):
                    args.append(node.args[pos])
                args.extend(k.value for k in node.keywords if k.arg == kw)
            for arg in args:
                if isinstance(arg, ast.Lambda):
                    self.step_bodies.add(arg)
                elif isinstance(arg, ast.Name):
                    for fn in defs_by_name.get(arg.id, []):
                        self.step_bodies.add(fn)

    def _propagate_reachability(self) -> None:
        """Same-file call-by-name reachability: a def called from a step
        context is itself a step context (its body runs once a step)."""
        defs_by_name = self._defs_by_name()
        changed = True
        while changed:
            changed = False
            for ctx_fn in list(self.step_context_funcs):
                for node in ast.walk(ctx_fn):
                    if not isinstance(node, ast.Call):
                        continue
                    cname = call_name(node)
                    if cname is None or "." in cname:
                        continue  # same-file plain names only
                    for fn in defs_by_name.get(cname, []):
                        if fn not in self.step_context_funcs:
                            self.step_context_funcs.add(fn)
                            changed = True

    # ------------------------------------------------------------------ query

    def enclosing_function(self, node: ast.AST) -> FuncNode | None:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def in_step_context(self, node: ast.AST) -> bool:
        fn = self.enclosing_function(node)
        while fn is not None:
            if fn in self.step_context_funcs:
                return True
            fn = self.enclosing_function(fn)
        return False

    def enclosing_loops(self, node: ast.AST) -> list[ast.For | ast.While]:
        """Python for/while statements lexically containing ``node``."""
        out: list[ast.For | ast.While] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                out.append(cur)
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break  # don't escape into the enclosing function's loops
            cur = self.parents.get(cur)
        return out

    def is_suppressed(self, rule_id: str, lineno: int) -> bool:
        if {"all", rule_id} & self.file_suppressions:
            return True
        ids = self.line_suppressions.get(lineno, set())
        return bool({"all", rule_id} & ids)

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # ------------------------------------------------------------- taint pass

    def traced_names(self, fn: FuncNode) -> set[str]:
        """Names holding tensors inside ``fn``.

        Seeds: the carry parameters of a step body (the driver's callables
        handed ``iterate``).  For plain defs merely *reachable* from a step
        context the seed is empty: whether their params are tensors depends
        on call sites, and guessing produces false tracer-branch positives
        (e.g. static ``impl=`` mode strings threaded through helpers).
        Propagates through assignments; ``.shape``/``.ndim``/``.dtype``/
        ``len()``/``.numel()`` sanitize.
        """
        traced: set[str] = set()
        if fn in self.step_bodies:
            traced |= set(carry_param_names(fn))

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for _ in range(2):  # two passes reach a fixpoint for straight-line use
            for stmt in body:
                for node in _walk_skipping_nested_functions(stmt):
                    targets: list[ast.expr] = []
                    if isinstance(node, ast.Assign):
                        targets, value = node.targets, node.value
                    elif isinstance(node, ast.AugAssign):
                        targets, value = [node.target], node.value
                    elif isinstance(node, ast.AnnAssign) and node.value is not None:
                        targets, value = [node.target], node.value
                    else:
                        continue
                    if self.expr_is_traced(value, traced):
                        for tgt in targets:
                            for name in _target_names(tgt):
                                traced.add(name)
        return traced

    def expr_is_traced(self, expr: ast.AST, traced: set[str]) -> bool:
        """Does ``expr`` (evaluated inside a step context) yield a tensor,
        given the currently-known tensor names?"""
        if isinstance(expr, ast.Name):
            return expr.id in traced
        if isinstance(expr, ast.Constant):
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False  # x.shape et al. read no device memory
            return self.expr_is_traced(expr.value, traced)
        if isinstance(expr, ast.Call):
            cname = call_name(expr)
            if cname in STATIC_CALLS:
                return False
            if isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr in STATIC_METHODS:
                return False
            args = list(expr.args) + [kw.value for kw in expr.keywords]
            if any(self.expr_is_traced(a, traced) for a in args):
                return True
            # method call on a tensor: x.to(...), x.sum(), ...
            if isinstance(expr.func, ast.Attribute):
                return self.expr_is_traced(expr.func.value, traced)
            return False
        if isinstance(expr, ast.Subscript):
            return self.expr_is_traced(expr.value, traced) or self.expr_is_traced(
                expr.slice, traced
            )
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_is_traced(e, traced) for e in expr.elts)
        if isinstance(expr, ast.Slice):
            return any(
                self.expr_is_traced(e, traced)
                for e in (expr.lower, expr.upper, expr.step)
                if e is not None
            )
        if isinstance(expr, ast.BoolOp):
            return any(self.expr_is_traced(v, traced) for v in expr.values)
        if isinstance(expr, ast.BinOp):
            return self.expr_is_traced(expr.left, traced) or self.expr_is_traced(
                expr.right, traced
            )
        if isinstance(expr, ast.UnaryOp):
            return self.expr_is_traced(expr.operand, traced)
        if isinstance(expr, ast.Compare):
            return self.expr_is_traced(expr.left, traced) or any(
                self.expr_is_traced(c, traced) for c in expr.comparators
            )
        if isinstance(expr, ast.IfExp):
            return any(
                self.expr_is_traced(e, traced)
                for e in (expr.test, expr.body, expr.orelse)
            )
        return False


def _target_names(tgt: ast.expr) -> Iterator[str]:
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for e in tgt.elts:
            yield from _target_names(e)
    elif isinstance(tgt, ast.Starred):
        yield from _target_names(tgt.value)


def _walk_skipping_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk, but do not descend into nested function definitions (they
    get their own taint pass)."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _walk_skipping_nested_functions(child)
