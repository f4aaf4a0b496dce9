"""One traced step of a registered entry point: the port's counterpart of
the JAX package's ``jax.make_jaxpr`` and of ``semantic.walk_eqns``,
``_trace_signature`` and ``_anchor_location``.

:func:`trace_variant` runs an entry's function under
``make_fx(tracing_mode="fake")`` on fake tensors on ``cuda:0``, made from
the variant's :class:`TensorSpec` leaves: shapes flow, nothing is
computed, no CUDA context is made, so it runs where there is no card.
``dataflow.fixpoint.single_step`` is open meanwhile, so a runner's loop
runs its step once: the trace is one step, the reference's "loop bodies
counted once".  Each kernel wrapper traces as one ``graft_torch`` op
(``ops/traced.py``).  What it returns (:class:`Trace`):

- the graph's call nodes (:class:`OpNode`): the op, its tensor inputs and
  outputs (shape, dtype), whether it is a view, and the file and line of
  the port's code that called it;
- the variant's signature: each tensor leaf's shape and dtype;
- the host reads of the step.  A read that needs the data (``float(t)``,
  ``.item()``, ``bool(t)``, an output whose shape depends on the data:
  ``nonzero``, ``unique``, ``masked_select``, a boolean index) raises
  under fake tensors; here it is caught where the port's code makes it,
  recorded with its file and line, and answered with a stand-in (1, or an
  output of the largest size the data allows), so the step goes on.  A
  step that reads more than :data:`MAX_HOST_READS` times (a loop on a read)
  stops there, recorded in ``stopped``;
- the collectives the step ran, as ``parallel/collectives.py`` reports
  them (name, mesh axis, slot count), each marked when it came after a
  host read of a slot-varying value.  A value is slot-varying unless every
  tensor it was computed from is: inputs are, and the results of ``psum``,
  ``pmax`` and ``all_gather`` (the same on every slot) are not;
- the inputs the step writes in place, by argument position: the write
  aliases of the op schemas on the input placeholders, through views.

Only ``torch`` is imported here; tiers 1, 4, 5 and 6 never import this
module.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import sys
from pathlib import Path
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.traced import OP_NAMESPACE
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives

_PKG_DIR = Path(__file__).resolve().parents[1]
_ROOT = _PKG_DIR.parent
# Frames of these files are the machinery, not the code under analysis.
_SKIP_FILES = (str(_PKG_DIR / "analysis"), str(_PKG_DIR / "parallel" / "collectives.py"),
               str(_PKG_DIR / "ops" / "traced.py"))

# The device the fake inputs name: the card's, which no trace touches.
DEVICE = torch.device("cuda", 0)
# Host reads a traced step may make before the trace stops.
MAX_HOST_READS = 64
# Collectives whose result is the same on every slot (the reference's
# _UNIFORMIZING_PRIMS).
UNIFORM_COLLECTIVES = frozenset({"psum", "pmax", "all_gather"})


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor input of a traced variant: its shape and dtype (the
    counterpart of ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def spec(shape, dtype: torch.dtype = torch.float32) -> TensorSpec:
    return TensorSpec(tuple(int(d) for d in shape), dtype)


def spec_of(tree):
    """``tree`` with every tensor leaf replaced by its :class:`TensorSpec`:
    a structure the port builds for real (a ``DeviceGraph``, a slot's
    arrays) as the input of a trace."""
    return pytree.tree_map(
        lambda x: spec(x.shape, x.dtype) if isinstance(x, torch.Tensor) else x, tree)


def signature(args: tuple) -> tuple:
    """Each tensor leaf's (shape, dtype) in order: what a plan build, an
    allocator size and a graph capture see of one call."""
    return tuple((leaf.shape, str(leaf.dtype))
                 for leaf in pytree.tree_leaves(args) if isinstance(leaf, TensorSpec))


@dataclasses.dataclass
class OpNode:
    """One call node of the traced graph."""

    target: str  # e.g. "aten.add.Tensor", "graft_torch.segment.default"
    namespace: str  # "aten", "graft_torch", ...
    name: str  # the op without namespace and overload: "add", "segment"
    is_view: bool
    inputs: list  # (shape, dtype) of each tensor argument
    outputs: list  # (shape, dtype) of each tensor result
    location: tuple | None  # (repo-relative path, line, def line) of the port's call

    @property
    def is_kernel(self) -> bool:
        return self.namespace == OP_NAMESPACE


@dataclasses.dataclass
class HostRead:
    kind: str  # "__float__", "item", "nonzero", ...
    location: tuple | None
    varying: bool  # the value read may differ between slots


@dataclasses.dataclass
class Collective:
    name: str  # psum, pmax, all_gather, reduce_scatter, ppermute
    axis: str | None
    size: int
    count: int  # primitives of this name the call ran
    nbytes: int  # the bytes of its per-slot results
    location: tuple | None
    after_varying_read: bool


@dataclasses.dataclass
class Trace:
    nodes: list  # OpNode, in graph order
    constants: list  # (shape, dtype) of tensors the step closed over
    host_reads: list  # HostRead
    collectives: list  # Collective
    writes: set  # argument positions whose tensors the step writes in place
    stopped: str | None = None  # why the trace ended before the step did

    def kernel_nodes(self) -> dict:
        """Kernel op nodes by name (the kernels' ``LAUNCHES`` keys)."""
        out: dict = {}
        for node in self.nodes:
            if node.is_kernel:
                out[node.name] = out.get(node.name, 0) + 1
        return out

    def transfers(self) -> list:
        """What moves data to the host in the step: the recorded reads,
        and graph nodes whose result lies on the CPU while an input lies
        on the card."""
        moves = [HostRead(n.target, n.location, False) for n in self.nodes
                 if n.outputs and n.outputs[0][2] == "cpu"
                 and any(i[2] != "cpu" for i in n.inputs)]
        return list(self.host_reads) + moves


class TraceStopped(Exception):
    """The traced step read the host more than MAX_HOST_READS times."""


@functools.lru_cache(maxsize=None)
def _relpath(filename: str) -> str:
    try:
        return Path(filename).resolve().relative_to(_ROOT).as_posix()
    except ValueError:
        return filename


def caller_location() -> tuple | None:
    """(repo-relative path, line, first line of the function) of the
    innermost frame of the port's own code (its package, less the
    analyzer, the kernels' op registry and the collectives), else None."""
    f = sys._getframe(1)
    pkg = str(_PKG_DIR)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(pkg) and not name.startswith(_SKIP_FILES):
            return _relpath(name), f.f_lineno, f.f_code.co_firstlineno
        f = f.f_back
    return None


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Varying(TorchDispatchMode):
    """Records each op's call site, and which tensors may differ between
    slots (a result is slot-varying when one of its tensor arguments is)."""

    def __init__(self):
        super().__init__()
        self.varying = WeakIdKeyDictionary()
        self.calls: list = []  # (op overload, location), in dispatch order

    def mark(self, tensors, varying: bool) -> None:
        for t in tensors:
            self.varying[t] = varying

    def is_varying(self, t) -> bool:
        return bool(self.varying.get(t, False))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((func, caller_location()))
        out = func(*args, **kwargs)
        self.mark(_tensors(out), any(self.is_varying(t) for t in _tensors((args, kwargs))))
        return out


_SCALAR_READS = {
    torch.Tensor.__float__: 1.0, torch.Tensor.__int__: 1, torch.Tensor.__index__: 1,
    torch.Tensor.__bool__: True, torch.Tensor.item: None, torch.Tensor.tolist: None,
}


def _unique_stand_in(x, sorted=True, return_inverse=False, return_counts=False, dim=None):
    n = x.numel()
    out = [torch.empty(n, dtype=x.dtype, device=x.device)]
    if return_inverse:
        out.append(torch.empty(x.shape, dtype=torch.int64, device=x.device))
    if return_counts:
        out.append(torch.empty(n, dtype=torch.int64, device=x.device))
    return out[0] if len(out) == 1 else tuple(out)


def _nonzero_stand_in(x, *, as_tuple=False):
    if as_tuple:
        return tuple(torch.empty(x.numel(), dtype=torch.int64, device=x.device)
                     for _ in range(x.dim()))
    return torch.empty((x.numel(), x.dim()), dtype=torch.int64, device=x.device)


def _masked_select_stand_in(x, mask):
    return torch.empty(torch.broadcast_shapes(x.shape, mask.shape).numel(), dtype=x.dtype,
                       device=x.device)


# Functions whose output shape depends on the data: their stand-ins take
# the largest shape the data allows.
_SHAPE_READS = {
    torch.nonzero: _nonzero_stand_in, torch.Tensor.nonzero: _nonzero_stand_in,
    torch.argwhere: _nonzero_stand_in, torch.Tensor.argwhere: _nonzero_stand_in,
    torch.unique: _unique_stand_in, torch.Tensor.unique: _unique_stand_in,
    torch.masked_select: _masked_select_stand_in,
    torch.Tensor.masked_select: _masked_select_stand_in,
}


_aten = torch.ops.aten


def _basic_index(x, idx) -> tuple:
    """``x`` under the ints, slices, ``None`` and ``...`` of the index
    ``idx``, and its integer tensors by the dimension of that view they
    index: PyTorch's own order of indexing, as aten ops."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if any(i is Ellipsis for i in items):
        at = items.index(Ellipsis)
        used = sum(1 for i in items if i is not None and i is not Ellipsis)
        items[at:at + 1] = [slice(None)] * (x.dim() - used)
    out, dim, tensors = x, 0, {}
    for item in items:
        if item is None:
            out = _aten.unsqueeze.default(out, dim)
            dim += 1
        elif isinstance(item, bool) or not isinstance(item, (int, slice, torch.Tensor)):
            raise TypeError(f"the trace takes no index of type {type(item).__name__}")
        elif isinstance(item, int):
            out = _aten.select.int(out, dim, item)
        elif isinstance(item, slice):
            if item != slice(None):
                out = _aten.slice.Tensor(out, dim, item.start, item.stop, item.step or 1)
            dim += 1
        else:
            tensors[dim] = item
            dim += 1
    return out, tensors


def _indices(tensors: dict) -> list:
    return [tensors.get(d) for d in range(max(tensors) + 1)]


def _getitem(x, idx):
    out, tensors = _basic_index(x, idx)
    if tensors:
        return _aten.index.Tensor(out, _indices(tensors))
    return out if out is not x else _aten.alias.default(x)


def _setitem(x, idx, value) -> None:
    view, tensors = _basic_index(x, idx)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    if tensors:
        _aten.index_put_.default(view, _indices(tensors), value)
    else:
        _aten.copy_.default(view, value)


class _HostReads(TorchFunctionMode):
    """Catches each read of tensor data on the host before fake tensors
    raise on it, records it and answers a stand-in; and indexes tensors
    through aten ops, as ``Tensor.__getitem__``, ``__setitem__``,
    ``contiguous`` and ``copy_`` would, since their Python bindings need a
    CUDA build for a CUDA tensor, fake or not."""

    def __init__(self, varying: _Varying, on_read: Callable):
        super().__init__()
        self.varying = varying
        self.on_read = on_read

    def _read(self, kind: str, x) -> None:
        self.on_read(HostRead(kind, caller_location(),
                              isinstance(x, torch.Tensor) and self.varying.is_varying(x)))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SCALAR_READS:
            self._read(func.__name__, args[0])
            value = _SCALAR_READS[func]
            if value is None:
                value = 1.0 if args[0].is_floating_point() else 1
                if func is torch.Tensor.tolist:
                    value = [value] * args[0].numel() if args[0].dim() else value
            return value
        if func in _SHAPE_READS:
            self._read(func.__name__, args[0])
            out = _SHAPE_READS[func](*args, **kwargs)
            self.varying.mark(_tensors(out), self.varying.is_varying(args[0]))
            return out
        if func is torch.Tensor.__getitem__:
            x, idx = args
            if isinstance(idx, torch.Tensor) and idx.dtype == torch.bool:
                self._read("__getitem__[bool]", idx)
                out = torch.empty((idx.numel(),) + tuple(x.shape[idx.dim():]), dtype=x.dtype,
                                  device=x.device)
                self.varying.mark([out], self.varying.is_varying(x)
                                  or self.varying.is_varying(idx))
                return out
            return _getitem(x, idx)
        if func is torch.Tensor.__setitem__:
            return _setitem(*args)
        if func is torch.Tensor.contiguous and not args[0].is_contiguous():
            return _aten.clone.default(args[0], memory_format=torch.contiguous_format)
        if func is torch.Tensor.copy_:
            return _aten.copy_.default(*args, **kwargs)
        return func(*args, **kwargs)


def _make_fx_kwargs() -> dict:
    params = inspect.signature(make_fx).parameters
    return {"_error_on_data_dependent_ops": True} if "_error_on_data_dependent_ops" in params else {}


def _base_placeholder(node):
    """The placeholder a node's storage belongs to, through view ops."""
    while node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload) \
            and node.target.is_view and node.args:
        node = node.args[0]
    return node if node.op == "placeholder" else None


def _written_placeholders(gm) -> set:
    out = set()
    for node in gm.graph.nodes:
        target = node.target
        if node.op != "call_function" or not isinstance(target, torch._ops.OpOverload):
            continue
        for i, arg in enumerate(target._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
            for v in (value if isinstance(value, (list, tuple)) else [value]):
                if isinstance(v, torch.fx.Node):
                    base = _base_placeholder(v)
                    if base is not None:
                        out.add(base)
    return out


def _meta_tensors(value) -> list:
    return [(tuple(t.shape), t.dtype, t.device.type) for t in _tensors(value)]


def _op_node(node, location) -> OpNode:
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        namespace, name = target.namespace, target._overloadpacket.__name__
        is_view = bool(target.is_view)
    else:
        namespace, name, is_view = "", getattr(target, "__name__", str(target)), False
    inputs = [(tuple(a.meta["val"].shape), a.meta["val"].dtype, a.meta["val"].device.type)
              for a in node.all_input_nodes
              if isinstance(a.meta.get("val"), torch.Tensor)]
    return OpNode(target=str(target), namespace=namespace, name=name, is_view=is_view,
                  inputs=inputs, outputs=_meta_tensors(node.meta.get("val")),
                  location=location)


def trace_variant(fn: Callable, args: tuple) -> Trace:
    """One step of ``fn(*args)`` on fake tensors on :data:`DEVICE`, with
    ``args`` a tuple of pytrees whose :class:`TensorSpec` leaves become the
    fake inputs.  Raises whatever the step raises, but for its host reads."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    flat, owners = [], []  # the fake tensor leaves, and each one's argument position
    trees = []
    for pos, arg in enumerate(args):
        leaves, tree_spec = pytree.tree_flatten(arg)
        with mode:
            leaves = [torch.empty(x.shape, dtype=x.dtype, device=DEVICE)
                      if isinstance(x, TensorSpec) else x for x in leaves]
        slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        flat.extend(leaves[i] for i in slots)
        owners.extend([pos] * len(slots))
        trees.append((leaves, slots, tree_spec))

    varying = _Varying()
    reads: list = []
    colls: list = []

    def on_read(read: HostRead) -> None:
        reads.append(read)
        if len(reads) > MAX_HOST_READS:
            raise TraceStopped(f"more than {MAX_HOST_READS} host reads in one step")

    def on_collective(name, axis, size, outputs, count) -> None:
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(outputs))
        colls.append(Collective(name, axis, size, count, nbytes, caller_location(),
                                any(r.varying for r in reads)))
        varying.mark(_tensors(outputs), name not in UNIFORM_COLLECTIVES)

    def flat_fn(*tensors):
        it = iter(tensors)
        rebuilt = []
        for leaves, slots, tree_spec in trees:
            leaves = list(leaves)
            for i in slots:
                leaves[i] = next(it)
            rebuilt.append(pytree.tree_unflatten(leaves, tree_spec))
        varying.mark(tensors, True)
        with varying, _HostReads(varying, on_read), collectives.recording(on_collective), \
                fixpoint.single_step():
            out = fn(*rebuilt)
        return _tensors(out)

    try:
        gm = make_fx(flat_fn, tracing_mode="fake", **_make_fx_kwargs())(*flat)
    except TraceStopped as exc:
        return Trace([], [], reads, colls, set(), stopped=str(exc))

    # align the graph's call nodes with the dispatches the mode saw, in order
    calls, at = varying.calls, 0
    nodes, constants = [], []
    placeholders = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            placeholders.append(node)
        elif node.op == "get_attr":
            constants.extend(_meta_tensors(getattr(gm, node.target, None)))
        elif node.op == "call_function":
            location = None
            for j in range(at, len(calls)):
                if calls[j][0] is node.target:
                    location, at = calls[j][1], j + 1
                    break
            nodes.append(_op_node(node, location))
    index = {ph: i for i, ph in enumerate(placeholders)}
    writes = {owners[index[ph]] for ph in _written_placeholders(gm) if ph in index}
    return Trace(nodes, constants, reads, colls, writes)


def anchor_location(module: str, anchor: Any, root: Path) -> tuple[str, int, str]:
    """(repo-relative path, line, snippet) of ``anchor``'s definition, or
    ``module`` at line 1 where it has none: where an entry's findings
    point, so their fingerprints survive registry reshuffles."""
    path, line = module, 1
    if anchor is not None:
        target = inspect.unwrap(anchor)
        try:
            src = Path(inspect.getsourcefile(target) or "")
            _, line = inspect.getsourcelines(target)
            path = src.resolve().relative_to(root.resolve()).as_posix()
        except (TypeError, OSError, ValueError):
            path, line = module, 1
    return path, line, source_line(root, path, line)


def source_line(root: Path, path: str, line: int) -> str:
    full = root / path
    if full.exists():
        lines = full.read_text(encoding="utf-8").splitlines()
        if 1 <= line <= len(lines):
            return lines[line - 1].strip()
    return ""
