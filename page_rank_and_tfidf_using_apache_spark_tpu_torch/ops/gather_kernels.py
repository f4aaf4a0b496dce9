"""The SpMV cost probe's same-shape gather, as a hand-written CUDA kernel.

Counterpart of the Pallas kernel in the JAX package's
``tools/gather_micro.py`` (``make_runner.kernel``, ``:77-98``): a
``take_along_axis`` whose index has the shape of its output, within blocks
of 8 rows that all read one ``[8, W]`` (or broadcast ``[1, W]``) table.
On the card it is ``csrc/gather.cu``, built for ``sm_90a`` on first use
(``ops/_build.py``); on the CPU the wrapper runs :func:`take_along_rows_plain`.

Like the TPU kernel, which keeps its table in VMEM, the CUDA kernel gathers
from fast memory: a block stages what its outputs read of the table in
shared memory, or, where the table is small enough for L1 or too wide for
a block, a grid-stride loop reads it through L1/L2.  :func:`stages_table`
picks, from the shapes, the alignment and the shared memory a block can
hold (``gather_table_limit()`` of the device).

``LAUNCHES`` counts kernel launches, so a run can show that it went through
the kernel.  It is kept apart from ``pallas_kernels.LAUNCHES``, whose keys
are the PageRank path's kernels.  Under the static analyzer's trace (fake
tensors on a CUDA device) the wrapper is one ``graft_torch::gather`` op
instead (``ops/traced.py``), wherever it would launch.
"""

from __future__ import annotations

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build, traced
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pallas_kernels import _raise_on

# Rows of the table block each group of 8 output rows gathers from.
BLOCK_ROWS = 8

# Tables the L2 loop keeps in L1 (lane W <= 4,096 at 8 rows): staging them
# measured no faster on the H100 (PERF.md section 6).
L1_TABLE_BYTES = 128 * 1024

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES: dict[str, int] = {"gather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, idx: torch.Tensor, axis: int) -> None:
    for t, name in ((x, "x"), (idx, "idx")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"gather takes torch.Tensor {name}, got {type(t).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"gather takes float32 x, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather takes int32 idx, got {idx.dtype}")
    if x.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"gather takes 2-D x and idx, got {tuple(x.shape)} and {tuple(idx.shape)}")
    if x.shape[0] not in (1, BLOCK_ROWS) or x.shape[1] != idx.shape[1]:
        raise ValueError(f"gather takes x of shape [8 or 1, W] and idx of shape [8*steps, W], "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)}")
    if idx.shape[0] % BLOCK_ROWS:
        raise ValueError(f"gather takes a multiple of {BLOCK_ROWS} idx rows, got {idx.shape[0]}")
    if axis not in (0, 1):
        raise ValueError(f"gather takes axis 0 or 1, got {axis}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather takes contiguous tensors")
    if x.device != idx.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather runs on cpu or cuda tensors on one device, "
                         f"got {x.device} and {idx.device}")


def stages_table(x_rows: int, width: int, axis: int, *, aligned: bool,
                 table_limit: int) -> bool:
    """Whether ``csrc/gather.cu`` stages the table in shared memory (its
    staged route) rather than reading it through L1/L2 (its L2 loop).

    A block stages what its outputs read: the whole ``[x_rows, W]`` table
    for sublane (``axis=0``), one row for lane (the block's outputs all
    read row ``g % 8``, or the broadcast row).  That must fit in
    ``table_limit`` bytes, and a bulk copy needs ``width % 4 == 0`` and
    16-byte aligned tensors (``aligned``).  A table of at most
    :data:`L1_TABLE_BYTES` stays on the L2 loop, whose L1 holds it."""
    if not aligned or width % 4 or x_rows * width * 4 <= L1_TABLE_BYTES:
        return False
    return (x_rows * width if axis == 0 else width) * 4 <= table_limit


def table_limit(device: torch.device) -> int:
    """Bytes of table a block of ``csrc/gather.cu`` can stage on the CUDA
    ``device`` (232,432 on an H100)."""
    with torch.cuda.device(device):
        limit = _build.library("gather").gather_table_limit()
    if limit <= 0:
        raise RuntimeError(f"gather: no shared-memory limit for {device}")
    return limit


def take_along_rows_plain(x: torch.Tensor, idx: torch.Tensor, *, axis: int) -> torch.Tensor:
    """``take_along_axis`` within blocks of 8 rows, plain PyTorch:
    ``torch.gather`` on a stride-0 ``[steps, 8, W]`` view of ``x`` (its one
    row broadcast to 8 where ``x`` is ``[1, W]``), with ``idx`` widened to
    int64.  ``torch.gather`` raises on an index out of range on the CPU."""
    rows, width = idx.shape
    steps = rows // BLOCK_ROWS
    table = x.expand(BLOCK_ROWS, width).unsqueeze(0).expand(steps, BLOCK_ROWS, width)
    dim = 2 if axis == 1 else 1
    return torch.gather(table, dim, idx.view(steps, BLOCK_ROWS, width).long()).view(rows, width)


def take_along_rows_kernel(x: torch.Tensor, idx: torch.Tensor, *, axis: int) -> torch.Tensor:
    """Same-shape gather of ``tools/gather_micro.py``'s probe: ``out[g, j] =
    xb[g % 8, idx[g, j]]`` for ``axis=1`` and ``xb[idx[g, j], j]`` for
    ``axis=0``, where ``xb`` is ``x`` (``[8, W]`` float32) or its one row
    broadcast to 8 (``x`` of shape ``[1, W]``), and ``idx`` is int32
    ``[8*steps, W]``.

    Index contract: every index lies in ``[0, W)`` for ``axis=1`` and in
    ``[0, 8)`` for ``axis=0``, as the probe draws them.  The CUDA kernel
    does not check it (an index out of range reads outside the table); the
    plain version, which the CPU route runs, raises.

    ``csrc/gather.cu`` on CUDA, on the route :func:`stages_table` picks,
    and :func:`take_along_rows_plain` on the CPU."""
    _check(x, idx, axis)
    if x.device.type == "cpu":
        return take_along_rows_plain(x, idx, axis=axis)
    rows, width = idx.shape
    if idx.numel() and traced.is_fake(x):
        return _gather_op()(x, idx, axis)
    out = torch.empty_like(idx, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.library("gather")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, idx, out))
    staged = stages_table(x.shape[0], width, axis, aligned=aligned,
                          table_limit=table_limit(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gather_f32(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], rows,
                            width, axis, int(staged), stream)
    _raise_on(rc, lib, "gather_error_string", "gather")
    LAUNCHES["gather"] += 1
    return out


def _gather_impl(x, idx, axis):
    return take_along_rows_kernel(x, idx, axis=axis)


def _gather_fake(x, idx, axis):
    return torch.empty_like(idx, dtype=torch.float32)


def _gather_op():
    return traced.kernel_op("gather", "(Tensor x, Tensor idx, int axis) -> Tensor",
                            _gather_impl, _gather_fake)
