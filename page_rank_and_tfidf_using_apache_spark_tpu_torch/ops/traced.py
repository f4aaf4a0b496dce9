"""The port's kernels as ops of its own ``torch.library`` namespace, for the
static analyzer's trace.

Each wrapper of ``csrc/`` (``segment_kernels.segment_sum_kernel``,
``pallas_kernels.cumsum_kernel``, ``rowsum_kernel``, ``spmv_pallas``,
``gather_kernels.take_along_rows_kernel``) launches its kernel through
``ctypes``, which no tracer can see.  Given a fake tensor on a CUDA device,
as the analyzer's ``make_fx`` trace passes (``analysis/trace.py``), a
wrapper returns instead the call of its op here, ``graft_torch::<name>``
with ``<name>`` its ``LAUNCHES`` key, so the kernel is one node of the
traced graph, where a launch would be.  The op's fake implementation gives
the output's shape, dtype and device and reads nothing; its real one calls
the wrapper.  Any other input keeps the wrapper's own path: a CUDA tensor
launches the kernel with no dispatcher hop, a CPU tensor runs the plain
version.

The ops are registered on first use, so a process that never traces
registers none.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

OP_NAMESPACE = "graft_torch"

_OPS: dict = {}


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor: a trace's, with no storage."""
    return isinstance(t, FakeTensor)


def kernel_op(name: str, schema: str, impl: Callable, fake: Callable):
    """The op ``graft_torch::<name>`` of schema ``schema``, which mutates
    none of its arguments, with ``impl`` on real tensors and ``fake`` on
    fake ones; registered on the first call."""
    op = _OPS.get(name)
    if op is None:
        op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", impl, mutates_args=(),
                                     schema=schema)
        op.register_fake(fake)
        _OPS[name] = op
    return op
