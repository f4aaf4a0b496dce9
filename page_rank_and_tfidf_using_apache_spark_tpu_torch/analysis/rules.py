"""The port's lexical rule set: the thirteen tier-1 rules of the JAX
package's ``analysis/rules.py``, by the same ids, over the port's own code.

Each rule is a function ``check(ctx: FileContext) -> Iterator[(node, msg)]``
registered in ``RULES``.  Rules are lexical AST checks — deliberately cheap
and import-free.  The JAX idioms of the reference become the PyTorch ones:
a *host sync* is ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
``.synchronize()`` / ``torch.cuda.synchronize()`` / ``np.asarray`` /
``float()``-``int()``-``bool()`` of a tensor; *device work* is a ``torch.*``
call, a method of a tensor, a kernel wrapper (``ops/segment_kernels.py``,
``ops/pallas_kernels.py``, ``ops/gather_kernels.py``) or a loop driver's
step; a *step context* (``context.py``) takes the place of a jit context.
The rules that read the declared contracts (threads, knobs, metrics,
ladder rungs) keep the reference's logic and read the port's
``utils/config.py`` and ``analysis/registry.py``.

Suppress a finding with a trailing ``# graftlint: disable=<rule-id>``
comment (comma-separate several ids, omit ``=...`` to disable all rules on
that line), or file-wide with ``# graftlint: disable-file=<rule-id>``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Iterator

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.context import (
    FileContext,
    FuncNode,
    call_name,
    dotted_name,
)

Hit = tuple[ast.AST, str]
CheckFn = Callable[[FileContext], Iterator[Hit]]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    check: CheckFn


RULES: dict[str, Rule] = {}


def rule(rule_id: str, summary: str) -> Callable[[CheckFn], CheckFn]:
    def register(fn: CheckFn) -> CheckFn:
        RULES[rule_id] = Rule(rule_id, summary, fn)
        return fn

    return register


# --------------------------------------------------------------------------
# shared predicates
# --------------------------------------------------------------------------

# Argument-less methods that wait for the device or pull a tensor to the
# host (``.synchronize()`` of a CUDA event or stream included).
_SYNC_METHOD_NAMES = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
_SYNC_CALL_NAMES = frozenset(
    {
        "torch.cuda.synchronize",
        "np.asarray",
        "np.array",
        "numpy.asarray",
        "numpy.array",
    }
)
_SCALAR_CASTS = ("float", "int", "bool")

# The hand-written kernels' wrappers: each launches one CUDA kernel (and
# counts it in its module's LAUNCHES).
KERNEL_WRAPPERS = frozenset({
    "segment_sum_kernel",
    "cumsum_kernel",
    "rowsum_kernel",
    "spmv_pallas",
    "take_along_rows_kernel",
})

# torch.* calls that only query or configure the host side — they return
# host objects, never device tensors, so they neither dispatch nor taint.
_NON_DISPATCH_TORCH_PREFIXES = (
    "torch.cuda.", "torch.profiler.", "torch.utils.", "torch.backends.",
    "torch.autograd.",
)
_NON_DISPATCH_TORCH = frozenset(
    {
        "torch.device",
        "torch.dtype",
        "torch.Size",
        "torch.Generator",
        "torch.is_tensor",
        "torch.no_grad",
        "torch.inference_mode",
        "torch.manual_seed",
        "torch.finfo",
        "torch.iinfo",
        "torch.set_num_threads",
        "torch.get_num_threads",
        "torch.get_default_dtype",
        "torch.from_numpy",
        "torch.use_deterministic_algorithms",
        "torch.distributed.init_process_group",
        "torch.distributed.destroy_process_group",
        "torch.distributed.is_available",
        "torch.distributed.is_initialized",
        "torch.distributed.get_rank",
        "torch.distributed.get_world_size",
        "torch.distributed.get_backend",
    }
)


def _is_torch_dispatch_name(cname: str) -> bool:
    return (
        cname.startswith("torch.")
        and not cname.startswith(_NON_DISPATCH_TORCH_PREFIXES)
        and cname not in _NON_DISPATCH_TORCH
    )


def _is_sync_call(node: ast.Call) -> bool:
    cname = call_name(node)
    if cname in _SYNC_CALL_NAMES:
        return True
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _SYNC_METHOD_NAMES
        and not node.args
    )


def _sync_kind(
    node: ast.Call,
    ctx: FileContext,
    traced: set[str] | None,
    bound: set[str] | None = None,
) -> str | None:
    """Classify a call as a host-sync construct, or None.

    ``float()``/``int()``/``bool()`` only count when the argument is
    device-flavored: a tensor name (when taint is known), a name bound
    from device work in the enclosing function, or an expression
    containing a torch call — ``float("inf")`` and config parsing stay
    quiet.
    """
    cname = call_name(node)
    if cname in _SYNC_CALL_NAMES:
        return cname
    if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHOD_NAMES:
        if node.args:
            return None  # dict.item(...)-style lookalikes take arguments
        return f".{node.func.attr}()"
    if cname in _SCALAR_CASTS and len(node.args) == 1:
        arg = node.args[0]
        if traced is not None and ctx.expr_is_traced(arg, traced):
            return f"{cname}()"
        if _contains_device_call(arg):
            return f"{cname}()"
        if bound and isinstance(arg, ast.Name) and arg.id in bound:
            return f"{cname}()"
    return None


def _contains_device_call(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            cname = call_name(node)
            if cname is None:
                continue
            if _is_torch_dispatch_name(cname) or \
                    cname.rsplit(".", 1)[-1] in KERNEL_WRAPPERS:
                return True
    return False


def _is_device_dispatch(
    node: ast.Call, ctx: FileContext, bound: set[str] | None = None
) -> bool:
    """A call that launches/transfers device work: torch.* calls (minus the
    sync constructs and host queries), the kernel wrappers, a loop driver's
    step callables, or a method of a name bound from device work."""
    if _is_sync_call(node):
        return False
    cname = call_name(node)
    if cname is not None:
        if _is_torch_dispatch_name(cname):
            return True
        if cname.rsplit(".", 1)[-1] in KERNEL_WRAPPERS:
            return True
        if cname in ctx.step_value_names:
            return True
    if bound and isinstance(node.func, ast.Attribute):
        recv = dotted_name(node.func.value)
        if recv is not None and recv.split(".")[0] in bound:
            return True
    return False


def _walk_own_body(fn: FuncNode) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs/lambdas."""
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def _device_bound_names(fn: FuncNode | None, ctx: FileContext) -> set[str]:
    """Names assigned from an expression containing a torch dispatch or a
    kernel wrapper, within ``fn``'s own body (module scope when fn is None)
    — the light taint that makes ``float(delta)`` and ``np.asarray(ranks)``
    detectable."""
    scope: list[ast.stmt]
    if fn is None:
        scope = ctx.tree.body
    else:
        scope = fn.body if isinstance(fn.body, list) else []
    out: set[str] = set()
    for stmt in scope:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Assign):
                continue
            if not _contains_device_call(node.value):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    out.update(
                        e.id for e in tgt.elts if isinstance(e, ast.Name)
                    )
    return out


class _BoundCache:
    """Per-function ``_device_bound_names``, keyed by the enclosing def."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self._cache: dict[FuncNode | None, set[str]] = {}

    def for_node(self, node: ast.AST) -> set[str]:
        fn = self.ctx.enclosing_function(node)
        if fn not in self._cache:
            self._cache[fn] = _device_bound_names(fn, self.ctx)
        return self._cache[fn]


# --------------------------------------------------------------------------
# 1. host-sync-in-loop
# --------------------------------------------------------------------------


@rule(
    "host-sync-in-loop",
    "host round-trip (.item / .tolist / .cpu / .numpy / .synchronize / "
    "torch.cuda.synchronize / np.asarray / float-int-bool of a tensor) "
    "inside a step context or a device-dispatching Python loop",
)
def check_host_sync(ctx: FileContext) -> Iterator[Hit]:
    taint_cache: dict[FuncNode, set[str]] = {}
    bound = _BoundCache(ctx)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        in_step = ctx.in_step_context(node)
        traced: set[str] | None = None
        if in_step:
            fn = ctx.enclosing_function(node)
            if fn is not None:
                if fn not in taint_cache:
                    taint_cache[fn] = ctx.traced_names(fn)
                traced = taint_cache[fn]
        names = bound.for_node(node)
        kind = _sync_kind(node, ctx, traced, names)
        if kind is None:
            continue

        if in_step:
            yield (
                node,
                f"host sync {kind} inside a step context — the loop driver "
                "runs this once a step, so every step waits for the device; "
                "hoist the transfer out of the step",
            )
            continue

        # outside a step: a sync is hot-loop poison when the same Python
        # loop also dispatches device work — every iteration then pays a
        # device round-trip (the pattern that serializes the streaming path).
        for loop in ctx.enclosing_loops(node):
            dispatches = any(
                isinstance(n, ast.Call)
                and n is not node
                and _is_device_dispatch(n, ctx, names)
                for n in ast.walk(loop)
            )
            if dispatches:
                yield (
                    node,
                    f"host sync {kind} inside a Python loop that also "
                    "dispatches device work — each iteration pays a "
                    "host<->device round-trip; batch the transfer or keep "
                    "the values on the device",
                )
                break


# --------------------------------------------------------------------------
# 2. tracer-branch
# --------------------------------------------------------------------------


@rule(
    "tracer-branch",
    "Python if/while on a tensor value inside a step context — a hidden "
    "host sync every step",
)
def check_tracer_branch(ctx: FileContext) -> Iterator[Hit]:
    for fn in ctx.step_context_funcs:
        traced = ctx.traced_names(fn)
        if not traced:
            continue
        for node in _walk_own_body(fn):
            if isinstance(node, (ast.If, ast.While)):
                test = node.test
            elif isinstance(node, ast.IfExp):
                test = node.test
            else:
                continue
            if ctx.expr_is_traced(test, traced):
                kw = {
                    ast.If: "if",
                    ast.While: "while",
                    ast.IfExp: "conditional expression",
                }[type(node)]
                yield (
                    node,
                    f"Python `{kw}` on a tensor value inside a step context "
                    "— bool() of a tensor waits for the device every step; "
                    "use torch.where or keep the decision on the device",
                )


# --------------------------------------------------------------------------
# 3. dtype-drift
# --------------------------------------------------------------------------

_FLOAT_DEFAULT_CTORS = frozenset({"zeros", "ones", "empty", "full", "linspace"})
_TENSOR_FROM_DATA = frozenset({"tensor", "as_tensor"})
_NP_ROOTS = ("np.", "numpy.")


def _has_np_dtype_arg(node: ast.Call, ctor: str) -> bool:
    if any(kw.arg == "dtype" for kw in node.keywords):
        return True
    if ctor == "linspace":
        return False  # dtype sits after retstep/axis — kwarg-only in practice
    # positional dtype: zeros/ones/empty take it 2nd, full 3rd
    pos = {"full": 2}.get(ctor, 1)
    return len(node.args) > pos


def _has_dtype_kw(node: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in node.keywords)


def _is_float_literal(expr: ast.AST) -> bool:
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, (ast.USub, ast.UAdd)):
        expr = expr.operand
    return isinstance(expr, ast.Constant) and isinstance(expr.value, float)


def _holds_float_literal(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.List, ast.Tuple)):
        return any(_holds_float_literal(e) for e in expr.elts)
    return _is_float_literal(expr)


@rule(
    "dtype-drift",
    "a torch tensor built with the float default (zeros/ones/empty/full/"
    "linspace/float arange, torch.tensor of a float literal, or a numpy "
    "float64 default passed straight to torch) and no dtype= — its dtype "
    "then follows torch.get_default_dtype() instead of the run's",
)
def check_dtype_drift(ctx: FileContext) -> Iterator[Hit]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        if cname is None:
            continue
        leaf = cname.rsplit(".", 1)[-1]
        if cname.startswith("torch.") and cname.count(".") == 1:
            if leaf in _FLOAT_DEFAULT_CTORS and not _has_dtype_kw(node):
                yield (
                    node,
                    f"torch.{leaf} without dtype= — takes the float default "
                    "(torch.get_default_dtype()), so the run's dtype and "
                    "this tensor's can drift; pass dtype explicitly",
                )
            elif leaf == "arange" and not _has_dtype_kw(node) and any(
                _is_float_literal(a) for a in node.args
            ):
                yield (
                    node,
                    "torch.arange over a float bound without dtype= — takes "
                    "the float default; pass dtype explicitly",
                )
            elif leaf in _TENSOR_FROM_DATA and node.args and \
                    not _has_dtype_kw(node) and \
                    _holds_float_literal(node.args[0]):
                yield (
                    node,
                    f"torch.{leaf} of a float literal without dtype= — takes "
                    "the float default; pass dtype explicitly",
                )
        elif leaf in _FLOAT_DEFAULT_CTORS and cname.startswith(_NP_ROOTS):
            # np float64 default flowing straight into a torch call
            parent = ctx.parents.get(node)
            feeding_device = (
                isinstance(parent, ast.Call)
                and (call_name(parent) or "").startswith("torch.")
            )
            if feeding_device and not _has_np_dtype_arg(node, leaf):
                yield (
                    node,
                    f"np.{leaf} (float64 default) passed straight into a "
                    "torch call — the tensor silently becomes float64; pass "
                    "dtype=",
                )


# --------------------------------------------------------------------------
# 4. nonstatic-shape
# --------------------------------------------------------------------------

_DATA_DEPENDENT_CALLS = frozenset(
    {"nonzero", "flatnonzero", "argwhere", "unique", "unique_consecutive",
     "masked_select", "compress"}
)


def _is_boolean_mask(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _is_boolean_mask(expr.operand)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitAnd, ast.BitOr)):
        return _is_boolean_mask(expr.left) or _is_boolean_mask(expr.right)
    return False


@rule(
    "nonstatic-shape",
    "data-dependent output shape inside a step context (boolean-mask "
    "indexing, nonzero/unique/masked_select, repeat_interleave without "
    "output_size, tensor slice bounds) — the host waits for the device to "
    "learn the size, every step",
)
def check_nonstatic_shape(ctx: FileContext) -> Iterator[Hit]:
    taint_cache: dict[FuncNode, set[str]] = {}

    def traced_for(node: ast.AST) -> set[str]:
        fn = ctx.enclosing_function(node)
        if fn is None:
            return set()
        if fn not in taint_cache:
            taint_cache[fn] = ctx.traced_names(fn)
        return taint_cache[fn]

    for node in ast.walk(ctx.tree):
        if not ctx.in_step_context(node):
            continue
        if isinstance(node, ast.Subscript):
            if _is_boolean_mask(node.slice):
                yield (
                    node,
                    "boolean-mask indexing inside a step context — the "
                    "result's size depends on data, so the host syncs; use "
                    "torch.where(mask, x, fill) or a fixed-size layout",
                )
            elif isinstance(node.slice, ast.Slice):
                traced = traced_for(node)
                bounds = [
                    b
                    for b in (node.slice.lower, node.slice.upper, node.slice.step)
                    if b is not None
                ]
                if traced and any(ctx.expr_is_traced(b, traced) for b in bounds):
                    yield (
                        node,
                        "slice bound is a tensor value inside a step context "
                        "— reading it syncs the host; slice by host ints or "
                        "mask instead",
                    )
        elif isinstance(node, ast.Call):
            cname = call_name(node)
            if cname is None:
                continue
            leaf = cname.rsplit(".", 1)[-1]
            if leaf in _DATA_DEPENDENT_CALLS and "." in cname:
                yield (
                    node,
                    f"{leaf}() inside a step context has a data-dependent "
                    "output size — the host waits for it every step; "
                    "restructure to a masked fixed-shape computation",
                )
            elif leaf == "repeat_interleave" and "." in cname:
                if not any(kw.arg == "output_size" for kw in node.keywords) \
                        and not (node.args and isinstance(node.args[0], ast.Constant)):
                    yield (
                        node,
                        "repeat_interleave() by tensor repeats without "
                        "output_size= inside a step context — the host syncs "
                        "to size the result; pass output_size",
                    )
            elif leaf == "where" and cname in ("torch.where",):
                if len(node.args) + len(node.keywords) == 1:
                    yield (
                        node,
                        "single-argument torch.where inside a step context "
                        "returns data-dependent-length indices — use the "
                        "three-argument form",
                    )


# --------------------------------------------------------------------------
# 5. dce-timed-region
# --------------------------------------------------------------------------

_TIME_CALLS = frozenset(
    {"time.perf_counter", "time.time", "time.monotonic", "perf_counter"}
)
_TIMER_NAMES = frozenset({"Timer", "timed"})
_REGION_SYNC_OK = frozenset({"float", "int"})  # float(...) of a result fences
# the guarded executor's pull and fence end a region as the raw ones do
_GUARDED_FENCE_LEAVES = frozenset({"device_get", "block_until_ready"})


def _is_time_call(expr: ast.AST) -> bool:
    return isinstance(expr, ast.Call) and call_name(expr) in _TIME_CALLS


def _region_has_sync(stmts: list[ast.stmt], ctx: FileContext) -> bool:
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                if _sync_kind(node, ctx, None) is not None:
                    return True
                cname = call_name(node)
                if cname in _REGION_SYNC_OK and node.args:
                    return True
                if cname and cname.rsplit(".", 1)[-1] in _GUARDED_FENCE_LEAVES:
                    return True
    return False


def _names_loaded(nodes: Iterator[ast.AST] | list[ast.stmt]) -> set[str]:
    out: set[str] = set()
    seq = nodes if isinstance(nodes, list) else list(nodes)
    for n in seq:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                out.add(sub.id)
    return out


def _audit_timed_region(
    region: list[ast.stmt],
    after: list[ast.stmt],
    ctx: FileContext,
    bound: set[str],
) -> Iterator[Hit]:
    """Flag a timed region whose device results are never fenced — CUDA
    launches are asynchronous, so the clock then times the launch only."""
    if _region_has_sync(region, ctx):
        return
    used_later = _names_loaded(after)
    for stmt in region:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            if _is_device_dispatch(stmt.value, ctx, bound):
                yield (
                    stmt,
                    "timed region discards a device call's result with no "
                    "synchronize/host pull — the launch is asynchronous, so "
                    "the clock stops before the work does",
                )
        elif isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            if not _is_device_dispatch(stmt.value, ctx, bound):
                continue
            targets = {
                t.id for t in stmt.targets if isinstance(t, ast.Name)
            }
            if targets and not (targets & used_later):
                yield (
                    stmt,
                    "timed region computes a device value that is never "
                    "read afterwards and never fenced — the clock times "
                    "the launch, not the work",
                )


@rule(
    "dce-timed-region",
    "a host-clock region that times device work with no synchronize, event "
    "sync or pulled result before the stop, or a step body consuming only "
    "one element of its result — the measurement times the launch, or "
    "work a compiled step would drop",
)
def check_dce_timed(ctx: FileContext) -> Iterator[Hit]:
    bound = _BoundCache(ctx)
    # (a) host-level: t0 = perf_counter() ... perf_counter() - t0 regions
    for parent in ast.walk(ctx.tree):
        body_lists = [
            getattr(parent, field)
            for field in ("body", "orelse", "finalbody")
            if isinstance(getattr(parent, field, None), list)
        ]
        for stmts in body_lists:
            for i, stmt in enumerate(stmts):
                if not (
                    isinstance(stmt, ast.Assign)
                    and _is_time_call(stmt.value)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                ):
                    continue
                t_name = stmt.targets[0].id
                end = None
                for j in range(i + 1, len(stmts)):
                    for sub in ast.walk(stmts[j]):
                        if (
                            isinstance(sub, ast.BinOp)
                            and isinstance(sub.op, ast.Sub)
                            and _is_time_call(sub.left)
                            and isinstance(sub.right, ast.Name)
                            and sub.right.id == t_name
                        ):
                            end = j
                            break
                    if end is not None:
                        break
                if end is None or end == i + 1:
                    continue
                region, after = stmts[i + 1 : end], stmts[end:]
                yield from _audit_timed_region(region, after, ctx,
                                               bound.for_node(stmt))

            # with Timer() as t: blocks
            for stmt in stmts:
                if not isinstance(stmt, (ast.With, ast.AsyncWith)):
                    continue
                timer_like = any(
                    isinstance(item.context_expr, ast.Call)
                    and (call_name(item.context_expr) or "").rsplit(".", 1)[-1]
                    in _TIMER_NAMES
                    for item in stmt.items
                )
                if not timer_like:
                    continue
                idx = stmts.index(stmt)
                yield from _audit_timed_region(stmt.body, stmts[idx + 1 :], ctx,
                                               bound.for_node(stmt))

    # (b) device-level: inside a step body, a computed result consumed only
    # through a constant single-element subscript (the "out.ravel()[0]"
    # chaining bug — the step's carry depends on element 0 alone).
    for fn in ctx.step_bodies:
        body = fn.body if isinstance(fn.body, list) else []
        for stmt in body if isinstance(body, list) else []:
            if not (
                isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Call)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
            ):
                continue
            name = stmt.targets[0].id
            uses = [
                n
                for n in _walk_own_body(fn)
                if isinstance(n, ast.Name)
                and n.id == name
                and isinstance(n.ctx, ast.Load)
            ]
            if uses and all(_use_is_single_element(u, ctx) for u in uses):
                yield (
                    stmt,
                    f"measurement loop consumes only one element of "
                    f"`{name}` — the carried dependency covers one element, "
                    "so a compiled or fused step computes the rest for "
                    "nothing (or drops it); reduce over the whole result "
                    "(e.g. torch.abs(x).min()) to keep it live",
                )


# --------------------------------------------------------------------------
# 6. unguarded-host-sync
# --------------------------------------------------------------------------

# Directory components whose host syncs must route through the resilience
# executor (retry/backoff, sync deadlines, the CPU salvage, and
# ResilienceExhausted-with-checkpoint).  resilience/ itself is exempt — it
# is where the raw calls legitimately live.
_GUARDED_TREE_DIRS = frozenset(
    {"models", "parallel", "io", "serving", "dataflow"}
)
_ASARRAY_CALLS = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
)
# the guarded executor's entry points: a raw sync lexically inside one of
# their arguments (or inside a same-file def handed to one) runs under
# retry, the sync deadline and the salvage
_GUARD_LEAVES = frozenset({
    "device_get", "block_until_ready", "run_guarded", "retry_transient",
    "attempt_once",
})


def _is_cpu_literal(expr: ast.AST | None) -> bool:
    return isinstance(expr, ast.Constant) and expr.value == "cpu"


def _to_device_arg(node: ast.Call) -> ast.AST | None:
    """The device argument of ``x.to(...)``: ``device=``, else the first
    positional argument when it is not a dtype spelling."""
    for kw in node.keywords:
        if kw.arg == "device":
            return kw.value
    if node.args:
        first = node.args[0]
        name = dotted_name(first) or ""
        if name.startswith("torch.") or "dtype" in name.lower():
            return None  # .to(torch.float32) / .to(dtype)
        return first
    return None


def _guarded_defs(ctx: FileContext) -> set[str]:
    """Names of same-file defs handed by name to a guarded entry point."""
    out: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            cname = call_name(node) or ""
            if cname.rsplit(".", 1)[-1] in _GUARD_LEAVES and node.args and \
                    isinstance(node.args[0], ast.Name):
                out.add(node.args[0].id)
    return out


def _under_guard(node: ast.AST, ctx: FileContext, guarded_defs: set[str]) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.Call):
            cname = call_name(cur) or ""
            if cname.rsplit(".", 1)[-1] in _GUARD_LEAVES:
                return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                cur.name in guarded_defs:
            return True
        cur = ctx.parents.get(cur)
    return False


@rule(
    "unguarded-host-sync",
    "raw .cpu() / .item() / .to('cpu') / .synchronize() / "
    "torch.cuda.synchronize() / np.asarray(device value) in models/, "
    "parallel/, io/, serving/ or dataflow/ outside the resilience executor "
    "— host syncs there must route through resilience.executor so retries, "
    "sync deadlines and the CPU salvage apply (ratchet stays at zero: "
    "migrate, don't baseline)",
)
def check_unguarded_sync(ctx: FileContext) -> Iterator[Hit]:
    parts = ctx.relpath.split("/")
    if not (set(parts[:-1]) & _GUARDED_TREE_DIRS):
        return
    bound = _BoundCache(ctx)
    guarded_defs = _guarded_defs(ctx)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None
        kind = None
        if cname == "torch.cuda.synchronize":
            kind = "fence torch.cuda.synchronize()"
        elif method == "synchronize" and not node.args:
            kind = "fence .synchronize()"
        elif method == "cpu" and not node.args:
            kind = "pull .cpu()"
        elif method == "to" and _is_cpu_literal(_to_device_arg(node)):
            kind = "pull .to('cpu')"
        elif method in ("item", "tolist") and not node.args:
            recv = node.func.value
            names = bound.for_node(node)
            if _contains_device_call(recv) or (
                isinstance(recv, ast.Name) and recv.id in names
            ):
                kind = f"pull .{method}()"
        elif cname in _ASARRAY_CALLS and len(node.args) == 1:
            arg = node.args[0]
            devicey = _contains_device_call(arg) or (
                isinstance(arg, ast.Name) and arg.id in bound.for_node(node)
            )
            if devicey:
                kind = f"pull {cname} of a device value"
        if kind is None or _under_guard(node, ctx, guarded_defs):
            continue
        yield (
            node,
            f"raw host {kind} outside the resilience executor — use "
            "resilience.executor.device_get / .block_until_ready (or "
            "run_guarded) so retry, sync-deadline and the CPU salvage apply",
        )


# --------------------------------------------------------------------------
# 7. untraced-guarded-site
# --------------------------------------------------------------------------

# Guarded-executor entry points whose call sites must sit inside an active
# span: the resilience ladder's retry/watchdog/degrade events are only
# attributable when the trace records WHICH phase the guarded call served.
# Matched as a bare name or under the conventional executor aliases; the
# raw spellings (.cpu(), torch.cuda.synchronize()) are unguarded-host-sync
# territory.
_GUARDED_LEAVES = frozenset({"device_get", "block_until_ready"})
_GUARDED_ROOTS = frozenset({"", "rx", "executor", "resilience.executor"})
# with-items that open a span: obs.span(...) / span(...) and the
# profiling.annotate(...) alias (which delegates to obs.span).
_SPAN_LEAVES = frozenset({"span", "annotate"})


def _inside_span(node: ast.AST, ctx: FileContext) -> bool:
    """Is ``node`` lexically inside a ``with obs.span(...)``-style block in
    its own function?  A caller's span is not lexically visible (same
    convention as ``_under_lock``): functions whose bodies run guarded
    calls open their own span."""
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    cname = call_name(expr)
                    if cname and cname.rsplit(".", 1)[-1] in _SPAN_LEAVES:
                        return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
        cur = ctx.parents.get(cur)
    return False


@rule(
    "untraced-guarded-site",
    "run_guarded / guarded device_get / block_until_ready call site in "
    "models/, parallel/, io/, serving/ or dataflow/ outside an active obs.span — the "
    "resilience "
    "ladder's retry/watchdog/degrade events would land in the trace with "
    "no phase to attribute them to",
)
def check_untraced_guarded_site(ctx: FileContext) -> Iterator[Hit]:
    parts = ctx.relpath.split("/")
    if not (set(parts[:-1]) & _GUARDED_TREE_DIRS):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        if cname is None:
            continue
        leaf = cname.rsplit(".", 1)[-1]
        root = cname[: -len(leaf) - 1] if "." in cname else ""
        guarded = leaf == "run_guarded" or (
            leaf in _GUARDED_LEAVES and root in _GUARDED_ROOTS
        )
        if not guarded:
            continue
        if _inside_span(node, ctx):
            continue
        yield (
            node,
            f"guarded call {cname} outside an active span — wrap the "
            "region in `with obs.span(\"<phase>\", ...)` so the trace can "
            "attribute the executor's retry/watchdog/degrade events (and "
            "the wall time) to a phase",
        )


# --------------------------------------------------------------------------
# 8. unsynced-thread-state
# --------------------------------------------------------------------------

# Methods that mutate their receiver in place.
_MUTATOR_METHODS = frozenset(
    {
        "append", "extend", "insert", "add", "update", "setdefault",
        "pop", "popitem", "remove", "discard", "clear",
    }
)


def _stmt_target_names(tgt: ast.expr) -> Iterator[str]:
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for e in tgt.elts:
            yield from _stmt_target_names(e)
    elif isinstance(tgt, ast.Starred):
        yield from _stmt_target_names(tgt.value)


def _module_level_names(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                out.update(_stmt_target_names(t))
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(stmt.target, ast.Name):
                out.add(stmt.target.id)
    return out


def _is_lockish(expr: ast.AST) -> bool:
    """``with <expr>:`` counts as a critical section when the context
    expression's dotted spelling mentions a lock (``self._lock``,
    ``_LOCK``, ``lock.acquire()``, ``threading.RLock()`` ...)."""
    name = dotted_name(expr)
    if name is None and isinstance(expr, ast.Call):
        name = call_name(expr)
    return name is not None and "lock" in name.lower()


def _under_lock(node: ast.AST, ctx: FileContext) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)) and any(
            _is_lockish(item.context_expr) for item in cur.items
        ):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False  # a caller's lock is not lexically visible
        cur = ctx.parents.get(cur)
    return False


def _thread_targets(ctx: FileContext) -> set[FuncNode]:
    """Functions handed to ``threading.Thread(target=...)``, plus same-file
    functions they call *outside* a lock (the body effectively runs on the
    spawned thread too)."""
    defs_by_name: dict[str, list[FuncNode]] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)

    targets: set[FuncNode] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        if cname not in ("threading.Thread", "Thread"):
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Lambda):
                targets.add(v)
            elif isinstance(v, ast.Name):
                targets.update(defs_by_name.get(v.id, []))
            elif isinstance(v, ast.Attribute):  # target=self._run
                targets.update(defs_by_name.get(v.attr, []))

    changed = True
    while changed:
        changed = False
        for fn in list(targets):
            for node in _walk_own_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                cname = call_name(node)
                if cname is None or "." in cname or _under_lock(node, ctx):
                    continue
                for callee in defs_by_name.get(cname, []):
                    if callee not in targets:
                        targets.add(callee)
                        changed = True
    return targets


@rule(
    "unsynced-thread-state",
    "module-level or instance state mutated inside a threading.Thread "
    "target without holding a lock — a data race against the spawning "
    "thread (the watchdog/prefetch bug class)",
)
def check_unsynced_thread_state(ctx: FileContext) -> Iterator[Hit]:
    targets = _thread_targets(ctx)
    if not targets:
        return
    module_names = _module_level_names(ctx.tree)

    for fn in targets:
        global_names: set[str] = set()
        for node in _walk_own_body(fn):
            if isinstance(node, ast.Global):
                global_names.update(node.names)

        for node in _walk_own_body(fn):
            shared: str | None = None
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in tgts:
                    if isinstance(t, ast.Name) and t.id in global_names:
                        shared = f"module global `{t.id}`"
                    elif isinstance(t, (ast.Attribute, ast.Subscript)):
                        base = dotted_name(t.value)
                        root_name = (base or "").split(".")[0]
                        if root_name == "self":
                            shared = f"instance state `{base}...`"
                        elif root_name in module_names or root_name in global_names:
                            shared = f"module-level `{base}`"
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_METHODS
            ):
                base = dotted_name(node.func.value)
                root_name = (base or "").split(".")[0]
                if root_name == "self":
                    shared = f"instance state `{base}.{node.func.attr}(...)`"
                elif root_name in module_names:
                    shared = f"module-level `{base}.{node.func.attr}(...)`"
            if shared is None or _under_lock(node, ctx):
                continue
            yield (
                node,
                f"thread-target function mutates {shared} without holding "
                "a lock — the spawning thread (or another worker) can race "
                "this write; guard it with `with <lock>:` or confine the "
                "state to one thread",
            )


# --------------------------------------------------------------------------
# 8b. thread-registry-drift
# --------------------------------------------------------------------------

# The declared thread inventory (utils/config.py THREAD_REGISTRY): rows of
# (name glob, owning module, locks it may hold).  This rule is the
# name-side validation companion of ``unsynced-thread-state`` — the same
# Thread-construction surface, checked against the declaration both
# directions; the locks-held direction lives in the tier-4 concurrency
# analyzer (``thread-lock-drift``), which shares these helpers.

_thread_registry_cache: dict = {}


def _parse_declared_rows(cfg_path, name: str) -> "tuple | None":
    """Lexically extract a tuple-of-tuples literal assigned to ``name``:
    each row becomes a tuple whose string elements are kept as-is and
    whose nested tuple/list elements become tuples of their string
    constants.  None when the file has no declaration."""
    try:
        tree = ast.parse(cfg_path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == name for t in targets):
            continue
        if not isinstance(value, (ast.Tuple, ast.List)):
            return None
        rows = []
        for row in value.elts:
            if not isinstance(row, (ast.Tuple, ast.List)):
                continue
            fields: list = []
            for elt in row.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    fields.append(elt.value)
                elif isinstance(elt, (ast.Tuple, ast.List)):
                    fields.append(tuple(
                        e.value for e in elt.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    ))
            rows.append(tuple(fields))
        return tuple(rows)
    return None


def thread_registry_rows(root) -> "tuple | None":
    """THREAD_REGISTRY rows for the scanned tree (falling back to this
    package's own utils/config.py for bare snippet lints); cached per
    root.  Each row is ``(name_glob, module, locks)``."""
    from pathlib import Path

    key = str(root) if root is not None else ""
    if key in _thread_registry_cache:
        return _thread_registry_cache[key]
    candidates = []
    if root is not None:
        candidates += [
            Path(root) / "page_rank_and_tfidf_using_apache_spark_tpu_torch/utils/config.py",
            Path(root) / "utils/config.py",
        ]
    candidates.append(Path(__file__).resolve().parents[1] / "utils" / "config.py")
    rows = None
    for c in candidates:
        if c.exists():
            rows = _parse_declared_rows(c, "THREAD_REGISTRY")
            if rows is not None:
                break
    _thread_registry_cache[key] = rows
    return rows


def resolve_thread_name(ctx: FileContext, expr: ast.AST | None,
                        node: ast.AST) -> str | None:
    """Static thread-name resolution: a string literal resolves to itself,
    an f-string to a glob (formatted fields become ``*``), and a bare name
    to the enclosing function parameter's string default.  None = the name
    is not statically resolvable (or absent)."""
    if expr is None:
        return None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        glob = "".join(parts)
        return glob if glob.strip("*") else None
    if isinstance(expr, ast.Name):
        fn = ctx.enclosing_function(node)
        if fn is None or isinstance(fn, ast.Lambda):
            return None
        a = fn.args
        params = a.posonlyargs + a.args
        for p, d in zip(params[len(params) - len(a.defaults):], a.defaults):
            if p.arg == expr.id and isinstance(d, ast.Constant) \
                    and isinstance(d.value, str):
                return d.value
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if p.arg == expr.id and isinstance(d, ast.Constant) \
                    and isinstance(d.value, str):
                return d.value
    return None


def _names_match(resolved: str, declared: str) -> bool:
    import fnmatch

    return resolved == declared or fnmatch.fnmatch(resolved, declared)


@rule(
    "thread-registry-drift",
    "threading.Thread constructed with a name not declared in "
    "utils/config.py THREAD_REGISTRY (or with no statically-resolvable "
    "name at all), or a declared thread no code implements — the one-"
    "process runtime's thread inventory must stay a checked declaration, "
    "not reviewer folklore",
)
def check_thread_registry_drift(ctx: FileContext) -> Iterator[Hit]:
    rows = thread_registry_rows(ctx.root)
    if ctx.relpath.endswith("utils/config.py"):
        # declaration side (the ladder-rung-drift convention): every
        # declared thread must be implemented — its name's literal prefix
        # must appear in the declared module's source.
        if rows is None or ctx.root is None:
            return
        for row in rows:
            if len(row) < 2:
                continue
            name, module = row[0], row[1]
            path = ctx.root / module
            prefix = name.split("*", 1)[0]
            try:
                implemented = path.exists() and (
                    not prefix or prefix in path.read_text(encoding="utf-8")
                )
            except OSError:
                implemented = False
            if not implemented:
                yield (
                    ctx.tree,
                    f"declared thread {name!r} is implemented nowhere in "
                    f"{module} — construct the thread there (literal "
                    "name) or drop the THREAD_REGISTRY row",
                )
        return

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if call_name(node) not in ("threading.Thread", "Thread"):
            continue
        name_expr = next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None
        )
        if name_expr is None:
            yield (
                node,
                "threading.Thread constructed without a name= — give the "
                "thread a literal name and declare it in utils/config.py "
                "THREAD_REGISTRY (name, owning module, locks it may hold)",
            )
            continue
        resolved = resolve_thread_name(ctx, name_expr, node)
        if resolved is None:
            yield (
                node,
                "thread name is not statically resolvable — use a string "
                "literal or f-string name so THREAD_REGISTRY can be "
                "validated against it",
            )
            continue
        if rows is None:
            yield (
                node,
                f"thread {resolved!r} but no THREAD_REGISTRY declaration "
                "found — declare the thread inventory in utils/config.py",
            )
            continue
        matched = [r for r in rows if len(r) >= 2 and _names_match(resolved, r[0])]
        if not matched:
            yield (
                node,
                f"thread {resolved!r} is not declared in utils/config.py "
                "THREAD_REGISTRY — register (name, owning module, locks it "
                "may hold) before spawning it",
            )
        elif not any(r[1] == ctx.relpath for r in matched):
            yield (
                node,
                f"thread {resolved!r} is declared for module "
                f"{matched[0][1]!r} but constructed in {ctx.relpath!r} — "
                "move the construction or fix the THREAD_REGISTRY row",
            )


# --------------------------------------------------------------------------
# 9. env-knob-drift
# --------------------------------------------------------------------------

_knob_cache: dict[str, frozenset | None] = {}


def _parse_declared_literal(cfg_path, name: str) -> frozenset | None:
    """Lexically extract a string-literal collection assigned to ``name``
    in a config module (never imports it — the linter must run even when
    the package is broken).  None when the file has no declaration."""
    try:
        tree = ast.parse(cfg_path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return frozenset(
                n.value
                for n in ast.walk(value)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            )
    return None


def _declared_config_literal(
    ctx: FileContext, name: str, cache: dict
) -> frozenset | None:
    """Resolve ``name``'s declaration from the scanned tree's utils/
    config.py, falling back to this package's own (snippet lints); cached
    per lint root."""
    from pathlib import Path

    key = str(ctx.root) if ctx.root is not None else ""
    if key in cache:
        return cache[key]
    candidates = []
    if ctx.root is not None:
        candidates += [
            ctx.root / "page_rank_and_tfidf_using_apache_spark_tpu_torch/utils/config.py",
            ctx.root / "utils/config.py",
        ]
    candidates.append(Path(__file__).resolve().parents[1] / "utils" / "config.py")
    declared = None
    for c in candidates:
        if c.exists():
            declared = _parse_declared_literal(c, name)
            if declared is not None:
                break
    cache[key] = declared
    return declared


def _declared_knobs(ctx: FileContext) -> frozenset | None:
    return _declared_config_literal(ctx, "GRAFT_ENV_KNOBS", _knob_cache)


@rule(
    "env-knob-drift",
    "os.environ read of a GRAFT_* knob that is not declared in "
    "utils/config.py GRAFT_ENV_KNOBS — knobs must be registered (and "
    "documented) before code may read them",
)
def check_env_knob_drift(ctx: FileContext) -> Iterator[Hit]:
    if ctx.relpath.endswith("utils/config.py"):
        return  # the declaration site itself

    reads: list[tuple[ast.AST, str]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            cname = call_name(node)
            if cname in ("os.environ.get", "os.getenv", "environ.get") and node.args:
                a = node.args[0]
                if (
                    isinstance(a, ast.Constant)
                    and isinstance(a.value, str)
                    and a.value.startswith("GRAFT_")
                ):
                    reads.append((node, a.value))
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            base = dotted_name(node.value)
            if base in ("os.environ", "environ"):
                s = node.slice
                if (
                    isinstance(s, ast.Constant)
                    and isinstance(s.value, str)
                    and s.value.startswith("GRAFT_")
                ):
                    reads.append((node, s.value))
    if not reads:
        return
    knobs = _declared_knobs(ctx)
    for node, knob in reads:
        if knobs is not None and knob in knobs:
            continue
        where = (
            "no GRAFT_ENV_KNOBS declaration found"
            if knobs is None
            else "not in utils/config.py GRAFT_ENV_KNOBS"
        )
        yield (
            node,
            f"undeclared env knob {knob!r} ({where}) — declare it in "
            "GRAFT_ENV_KNOBS with a comment and document it in the README "
            "env-knob table before reading it",
        )


# --------------------------------------------------------------------------
# 9b. metric-name-drift
# --------------------------------------------------------------------------

# The declared metric-name contract (analysis/registry.py METRIC_SCHEMAS):
# rows of (name glob, kind, unit, publishing sites).  Two namespaces share
# it — run-aggregate publishes (``obs.counter/gauge/histogram``) and live-
# SLO hub publishes (``hub.count/counter/gauge``, plus MetricsHub's own
# ``self.*`` calls) — because both end up in operator-facing surfaces
# (run summary / trace_report on one side, /metrics / slo_watch /
# federation on the other) where a silent rename breaks every reader.

_metric_schema_cache: dict = {}

_METRIC_KINDS = frozenset({"counter", "gauge", "histogram", "slo"})
_METRIC_CALL_KIND = {
    "count": "counter",
    "counter": "counter",
    "gauge": "gauge",
    "histogram": "histogram",
}
_METRIC_RECEIVERS = frozenset({"obs", "hub"})


def _parse_metric_rows(reg_path) -> "tuple | None":
    """Lexically extract METRIC_SCHEMAS rows from analysis/registry.py,
    resolving the registry's ``f"{_PKG}/..."`` site paths through its
    module-level string constants (never imports — the linter must run
    even when the package is broken).  None when the file has no
    declaration."""
    try:
        tree = ast.parse(reg_path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    consts: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            consts[node.targets[0].id] = node.value.value

    def lit(elt: ast.AST) -> str | None:
        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
            return elt.value
        if isinstance(elt, ast.JoinedStr):
            parts = []
            for v in elt.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    parts.append(v.value)
                elif isinstance(v, ast.FormattedValue) and \
                        isinstance(v.value, ast.Name) and \
                        v.value.id in consts:
                    parts.append(consts[v.value.id])
                else:
                    return None
            return "".join(parts)
        return None

    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "METRIC_SCHEMAS"
                   for t in targets):
            continue
        if not isinstance(value, (ast.Tuple, ast.List)):
            return None
        rows = []
        for row in value.elts:
            if not isinstance(row, (ast.Tuple, ast.List)) or \
                    len(row.elts) != 4:
                continue
            name, kind, unit = (lit(e) for e in row.elts[:3])
            sites_elt = row.elts[3]
            sites = tuple(
                s for s in (lit(e) for e in sites_elt.elts) if s
            ) if isinstance(sites_elt, (ast.Tuple, ast.List)) else ()
            if name and kind:
                rows.append((name, kind, unit or "", sites))
        return tuple(rows)
    return None


def metric_schema_rows(root) -> "tuple | None":
    """METRIC_SCHEMAS rows for the scanned tree (falling back to this
    package's own analysis/registry.py for bare snippet lints); cached
    per root.  Each row is ``(name_glob, kind, unit, sites)``."""
    from pathlib import Path

    key = str(root) if root is not None else ""
    if key in _metric_schema_cache:
        return _metric_schema_cache[key]
    candidates = []
    if root is not None:
        candidates += [
            Path(root) / "page_rank_and_tfidf_using_apache_spark_tpu_torch/analysis/registry.py",
            Path(root) / "analysis/registry.py",
        ]
    candidates.append(Path(__file__).resolve().parent / "registry.py")
    rows = None
    for c in candidates:
        if c.exists():
            rows = _parse_metric_rows(c)
            if rows is not None:
                break
    _metric_schema_cache[key] = rows
    return rows


@rule(
    "metric-name-drift",
    "a metric published under a name not declared in analysis/registry.py "
    "METRIC_SCHEMAS (or from a module the row does not list, or with a "
    "kind the row contradicts), or a declared metric no site publishes — "
    "every dashboard, slo_watch board, trace_diff gate and federation "
    "merge keys on these names, so the name space is a checked contract",
)
def check_metric_name_drift(ctx: FileContext) -> Iterator[Hit]:
    rows = metric_schema_rows(ctx.root)
    if ctx.relpath.endswith("analysis/registry.py"):
        # declaration side: every row's kind must be known and its name's
        # literal fragments must appear in every site it claims (glob
        # names check their non-* fragments, the f-string publish pattern)
        if rows is None or ctx.root is None:
            return
        for name, kind, _unit, sites in rows:
            if kind not in _METRIC_KINDS:
                yield (
                    ctx.tree,
                    f"METRIC_SCHEMAS row {name!r} declares unknown kind "
                    f"{kind!r} (expected one of {sorted(_METRIC_KINDS)})",
                )
            frags = [f for f in name.split("*") if f]
            for site in sites:
                path = ctx.root / site
                try:
                    text = path.read_text(encoding="utf-8") \
                        if path.exists() else None
                except OSError:
                    text = None
                if text is None or not all(f in text for f in frags):
                    yield (
                        ctx.tree,
                        f"METRIC_SCHEMAS declares {name!r} published from "
                        f"{site} but the name appears nowhere there — "
                        "stale registry row or renamed metric",
                    )
        return

    # usage side: every literal-named publish call must be covered by a
    # row — name, kind and publishing module.  Variable names (e.g.
    # ingest_event's `self.count(kind)` passthrough) are skipped; their
    # kind-set literals are validated by the declaration side above.
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)):
            continue
        kind = _METRIC_CALL_KIND.get(fn.attr)
        if kind is None:
            continue
        recv = fn.value.id
        if recv not in _METRIC_RECEIVERS and not (
                recv == "self" and ctx.relpath.endswith("obs/metrics.py")):
            continue
        resolved = resolve_thread_name(ctx, node.args[0], node)
        if resolved is None:
            continue
        if rows is None:
            yield (
                node,
                f"metric {resolved!r} published but no METRIC_SCHEMAS "
                "declaration found — declare the metric-name contract in "
                "analysis/registry.py",
            )
            continue
        matched = [r for r in rows if _names_match(resolved, r[0])]
        if not matched:
            yield (
                node,
                f"metric {resolved!r} is not declared in "
                "analysis/registry.py METRIC_SCHEMAS — register (name, "
                "kind, unit, publishing sites) before publishing it",
            )
            continue
        kinded = [r for r in matched if r[1] == kind]
        if not kinded:
            yield (
                node,
                f"metric {resolved!r} is published as a {kind} but "
                f"METRIC_SCHEMAS declares it {matched[0][1]!r} — a kind "
                "change breaks every reader's aggregation; fix one side",
            )
        elif not any(ctx.relpath == s for r in kinded for s in r[3]):
            yield (
                node,
                f"metric {resolved!r} is published from {ctx.relpath!r} "
                "which its METRIC_SCHEMAS row does not list — add the "
                "site or move the publish",
            )


# --------------------------------------------------------------------------
# 10. ladder-rung-drift
# --------------------------------------------------------------------------

_ladder_cache: dict[str, frozenset | None] = {}


def _declared_ladder(ctx: FileContext) -> frozenset | None:
    return _declared_config_literal(ctx, "DEGRADE_LADDER", _ladder_cache)


def _degraded_ladder_kwargs(tree: ast.AST) -> Iterator[tuple[ast.AST, str]]:
    """Every string-literal ``ladder=`` kwarg on an
    ``emit("degraded", ...)`` / ``record(event="degraded", ...)`` call."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        is_degraded = any(
            isinstance(a, ast.Constant) and a.value == "degraded"
            for a in node.args
        ) or any(
            kw.arg == "event"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value == "degraded"
            for kw in node.keywords
        )
        if not is_degraded:
            continue
        for kw in node.keywords:
            if (
                kw.arg == "ladder"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
            ):
                yield node, kw.value.value


@rule(
    "ladder-rung-drift",
    "degradation-ladder drift against utils/config.py DEGRADE_LADDER: a "
    "`degraded` event emitted with an undeclared ladder name, or a "
    "declared rung no resilience/ module implements — the ladder the docs "
    "promise and the ladder the code walks must be the same ladder",
)
def check_ladder_rung_drift(ctx: FileContext) -> Iterator[Hit]:
    ladder = _declared_ladder(ctx)
    if ctx.relpath.endswith("utils/config.py"):
        # declaration side: every declared rung must be implemented — i.e.
        # appear as a string literal somewhere under resilience/ (the
        # subsystem that owns degradation).  Checked from the declaration
        # site so the finding lands where the fix (or the deletion) goes.
        if ladder is None or ctx.root is None:
            return
        res_dirs = [
            ctx.root / "page_rank_and_tfidf_using_apache_spark_tpu_torch/resilience",
            ctx.root / "resilience",
        ]
        files = [p for d in res_dirs if d.is_dir() for p in d.glob("*.py")]
        if not files:
            return  # nothing to check against (snippet trees)
        seen: set[str] = set()
        for p in files:
            try:
                t = ast.parse(p.read_text(encoding="utf-8"))
            except (OSError, SyntaxError):
                continue
            seen.update(
                n.value
                for n in ast.walk(t)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            )
        for rung in sorted(ladder - seen):
            yield (
                ctx.tree,
                f"declared rung {rung!r} is referenced nowhere under "
                "resilience/ — implement the rung (it must publish a "
                "`degraded` event) or drop it from DEGRADE_LADDER",
            )
        return

    for node, name in _degraded_ladder_kwargs(ctx.tree):
        if ladder is not None and name in ladder:
            continue
        where = (
            "no DEGRADE_LADDER declaration found"
            if ladder is None
            else "not in utils/config.py DEGRADE_LADDER"
        )
        yield (
            node,
            f"`degraded` event emitted with undeclared ladder {name!r} "
            f"({where}) — declare the rung in DEGRADE_LADDER (and the "
            "README ladder table) before code may take it",
        )


def _use_is_single_element(use: ast.Name, ctx: FileContext) -> bool:
    """True if this load feeds only a constant element access like
    ``x[0]``, ``x[0, 0]`` or ``x.ravel()[0]``."""
    node: ast.AST = use
    parent = ctx.parents.get(node)
    # allow a .ravel()/.flatten()/.reshape() hop
    if (
        isinstance(parent, ast.Attribute)
        and parent.attr in ("ravel", "flatten", "reshape")
    ):
        grand = ctx.parents.get(parent)
        if isinstance(grand, ast.Call):
            node, parent = grand, ctx.parents.get(grand)
    if isinstance(parent, ast.Subscript) and parent.value is node:
        idx = parent.slice
        if isinstance(idx, ast.Constant) and isinstance(idx.value, int):
            return True
        if isinstance(idx, ast.Tuple) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, int)
            for e in idx.elts
        ):
            return True
    return False




# --------------------------------------------------------------------------
# 12. sync-put-in-ingest-loop
# --------------------------------------------------------------------------

# Directory components whose per-chunk H2D transfers must route through the
# staging API (dataflow.ingest.staged_put / the chunked_ingest stage
# closure): a raw host-to-device copy inside an ingest loop body serializes
# the pipeline — the transfer blocks the thread that should be dispatching
# chunk N while chunk N+1 transfers — and sits outside the
# ``ingest_h2d_put`` chaos/retry site, so device loss during the put
# bypasses the pipeline's recovery point.
_INGEST_PUT_DIRS = frozenset({"dataflow", "models", "parallel"})
_STAGED_PUT_LEAF = "staged_put"
_PUT_CTORS = frozenset({"torch.as_tensor", "torch.tensor"})


def _under_staged_put(node: ast.AST, ctx: FileContext) -> bool:
    """Is ``node`` lexically inside an argument of a ``staged_put(...)``
    call (any alias path: ``staged_put`` / ``dflow.staged_put`` /
    ``ingest.staged_put``)?  The conventional shape is a lambda/closure
    handed to staged_put, whose body issues the raw puts."""
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.Call):
            cname = call_name(cur)
            if cname and cname.rsplit(".", 1)[-1] == _STAGED_PUT_LEAF:
                return True
        cur = ctx.parents.get(cur)
    return False


def _is_host_expr(expr: ast.AST, host_names: set[str]) -> bool:
    """Host data: a name bound from host data in the enclosing function, or
    an expression built by ``torch.from_numpy`` / ``np.*``."""
    if isinstance(expr, ast.Name):
        return expr.id in host_names
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            cname = call_name(sub) or ""
            if cname == "torch.from_numpy" or cname.startswith(_NP_ROOTS):
                return True
    return False


def _host_bound_names(fn: FuncNode | None, ctx: FileContext) -> set[str]:
    scope = ctx.tree.body if fn is None else (
        fn.body if isinstance(fn.body, list) else [])
    out: set[str] = set()
    for stmt in scope:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign) and _is_host_expr(node.value, set()):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


def _raw_put(node: ast.Call, host_names: set[str]) -> str | None:
    """``torch.as_tensor/tensor(..., device=<device>)``, or ``.cuda()`` /
    ``.to(<device>)`` (not a dtype, not "cpu") of host data: a
    host-to-device copy, or None.  A device tensor's ``.to(device)`` is a
    device-to-device copy (a collective's, a slot's) and is not one."""
    cname = call_name(node)
    if cname in _PUT_CTORS:
        dev = next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        if dev is not None and not _is_cpu_literal(dev):
            return f"{cname}(..., device=)"
        return None
    if not isinstance(node.func, ast.Attribute) or \
            not _is_host_expr(node.func.value, host_names):
        return None
    if node.func.attr == "cuda":
        return ".cuda()"
    if node.func.attr == "to":
        dev = _to_device_arg(node)
        if dev is not None and not _is_cpu_literal(dev):
            return ".to(device)"
    return None


@rule(
    "sync-put-in-ingest-loop",
    "raw host-to-device copy (.to(device) / .cuda() of host data, "
    "torch.as_tensor(..., device=)) inside a loop body in dataflow/, models/ or parallel/ "
    "outside the staging API (dataflow.ingest.staged_put) — per-chunk H2D "
    "transfers must run on the pipeline's staging stage so they overlap "
    "compute, retry transients, and surface device loss at the pipeline's "
    "recovery point (ratchet stays at zero: migrate, don't baseline)",
)
def check_sync_put_in_ingest_loop(ctx: FileContext) -> Iterator[Hit]:
    parts = ctx.relpath.split("/")
    if not (set(parts[:-1]) & _INGEST_PUT_DIRS):
        return
    host_cache: dict[FuncNode | None, set[str]] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = ctx.enclosing_function(node)
        if fn not in host_cache:
            host_cache[fn] = _host_bound_names(fn, ctx)
        kind = _raw_put(node, host_cache[fn])
        if kind is None:
            continue
        if not ctx.enclosing_loops(node):
            continue
        if _under_staged_put(node, ctx):
            continue
        yield (
            node,
            f"raw {kind} inside a loop body — route the transfer "
            "through dataflow.ingest.staged_put (or the chunked_ingest "
            "stage closure) so it runs on the staging stage: overlapped "
            "with compute, retried on transients, and recoverable at the "
            "pipeline's recovery point on device loss",
        )
