"""The probe's gather kernel module on the CPU, against the JAX tool's Pallas kernel.

``tools/gather_micro.py`` builds its kernel in a closure inside ``main``
(``make_runner``, ``:73-100``), so it cannot be imported: :func:`pallas_gather`
restates its ``pl.pallas_call`` (``:77-98``) verbatim and runs it in
interpret mode.  On the CPU the port's wrapper runs its plain version; the
CUDA kernel is held against the same plain version, bit for bit, by
``chip_smoke.py``.  A gather is exact, so every comparison is equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import gather_micro


def pallas_gather(x, idx, *, axis, broadcast):
    """``tools/gather_micro.py:77-98`` with ``interpret=True``."""
    rows = 8
    width = x.shape[1]
    steps = idx.shape[0] // rows
    x_rows = 1 if broadcast else rows

    def kernel(x_ref, idx_ref, o_ref):
        x = x_ref[:]
        if broadcast:
            x = jnp.broadcast_to(x, (rows, width))
        o_ref[:] = jnp.take_along_axis(x, idx_ref[:], axis=axis)

    io_spec = pl.BlockSpec((rows, width), lambda i: (i, 0),
                           memory_space=pltpu.VMEM)

    def call(x, idx):
        return pl.pallas_call(
            kernel,
            grid=(steps,),
            in_specs=[
                pl.BlockSpec((x_rows, width), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                io_spec,
            ],
            out_specs=io_spec,
            out_shape=jax.ShapeDtypeStruct((rows * steps, width), x.dtype),
            interpret=True,
        )(x, idx)

    return np.asarray(call(jnp.asarray(x), jnp.asarray(idx)))


# Bytes of table a block of csrc/gather.cu stages on an H100: 232,448 bytes
# of opt-in shared memory less its 16-byte barrier.
H100_TABLE_LIMIT = 232_448 - 16
# The widths at which the staged route's reach changes there: where an
# 8-row table, and a broadcast row, outgrow L1_TABLE_BYTES; where all 8
# rows (sublane), and one row (lane), outgrow a block.
ROUTE_LIMITS = (4096, 32768, 7260, 58108)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("width", [128, 256, 1024, *(w + d for w in ROUTE_LIMITS for d in (0, 4))])
@pytest.mark.parametrize("mode", ["lane", "sublane", "broadcast"])
def test_gather_matches_pallas_kernel(mode, width, steps):
    m = gather_micro.Mode(width, steps, axis=0 if mode == "sublane" else 1,
                          broadcast=mode == "broadcast")
    x, idx = gather_micro.mode_inputs(m, np.random.default_rng(width + steps))
    want = pallas_gather(x, idx, axis=m.axis, broadcast=m.broadcast)
    tx, tidx = torch.from_numpy(x), torch.from_numpy(idx)
    plain = gk.take_along_rows_plain(tx, tidx, axis=m.axis)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(gk.take_along_rows_kernel(tx, tidx, axis=m.axis).numpy(), want)
    assert plain.dtype == torch.float32 and plain.shape == tidx.shape


X8, X1, IDX = torch.zeros(8, 16), torch.zeros(1, 16), torch.zeros(16, 16, dtype=torch.int32)


@pytest.mark.parametrize("x, idx, axis, error", [
    (X8.double(), IDX, 1, TypeError),
    (X8, IDX.long(), 1, TypeError),
    (X8.numpy(), IDX, 1, TypeError),
    (torch.zeros(8, 32)[:, ::2], IDX, 1, ValueError),
    (X8, torch.zeros(16, 32, dtype=torch.int32)[:, ::2], 1, ValueError),
    (torch.zeros(8, 16, 1), IDX, 1, ValueError),
    (X8, torch.zeros(256, dtype=torch.int32), 1, ValueError),
    (torch.zeros(4, 16), IDX, 1, ValueError),
    (X8, torch.zeros(12, 16, dtype=torch.int32), 1, ValueError),
    (X8, torch.zeros(16, 8, dtype=torch.int32), 1, ValueError),
    (X8, IDX, 2, ValueError),
    (torch.zeros(8, 16, device="meta"), torch.zeros(16, 16, dtype=torch.int32, device="meta"), 1,
     ValueError),
    (X1, torch.zeros(16, 16, dtype=torch.int32, device="meta"), 1, ValueError),
])
def test_wrapper_rejects_bad_input(x, idx, axis, error):
    with pytest.raises(error):
        gk.take_along_rows_kernel(x, idx, axis=axis)


@pytest.mark.parametrize("axis, bad", [(1, 16), (1, -17), (0, 8)])
def test_plain_raises_out_of_range(axis, bad):
    """The index contract: the CPU route raises where the kernel would read
    outside the table."""
    idx = torch.zeros(8, 16, dtype=torch.int32)
    idx[3, 5] = bad
    with pytest.raises(RuntimeError, match="out of bounds"):
        gk.take_along_rows_kernel(X8, idx, axis=axis)


def test_cpu_calls_count_no_launch():
    gk.reset_launches()
    gk.take_along_rows_kernel(X8, IDX, axis=1)
    gk.take_along_rows_kernel(X1, IDX, axis=0)
    assert gk.LAUNCHES == {"gather": 0}


def test_empty_input():
    out = gk.take_along_rows_kernel(torch.zeros(8, 0), torch.zeros(8, 0, dtype=torch.int32), axis=1)
    assert out.shape == (8, 0) and out.dtype == torch.float32


@pytest.mark.parametrize("x_rows, width, axis, aligned, staged", [
    (8, 4096, 1, True, False),  # lane: a 128 KB table stays in L1 on the L2 loop
    (8, 4100, 1, True, True),  # one row a block
    (8, 32768, 1, True, True),
    (8, 58108, 1, True, True),
    (8, 58112, 1, True, False),  # one row outgrows a block
    (8, 109184, 1, True, False),  # the probe's widest lane width
    (8, 4096, 0, True, False),  # sublane: all 8 rows staged
    (8, 4100, 0, True, True),
    (8, 7260, 0, True, True),
    (8, 7264, 0, True, False),
    (1, 32768, 1, True, False),  # the broadcast row
    (1, 32772, 1, True, True),
    (1, 58108, 0, True, True),
    (1, 58112, 0, True, False),
    (8, 8192, 1, False, False),  # a bulk copy needs 16-byte aligned tensors
    (8, 8194, 1, True, False),  # and 16-byte rows
    (8, 0, 1, True, False),
])
def test_stages_table_follows_the_limits(x_rows, width, axis, aligned, staged):
    assert gk.stages_table(x_rows, width, axis, aligned=aligned,
                           table_limit=H100_TABLE_LIMIT) is staged


@pytest.mark.parametrize("x_rows, axis, limit", [
    (8, 1, 4096), (8, 0, 4096), (1, 1, 32768), (1, 0, 32768),  # L1's reach
    (8, 0, 7260), (8, 1, 58108), (1, 1, 58108), (1, 0, 58108),  # a block's reach
])
def test_route_limits_are_where_the_route_changes(x_rows, axis, limit):
    """Each of ``ROUTE_LIMITS`` flips the route of the modes it bounds."""
    def staged(w):
        return gk.stages_table(x_rows, w, axis, aligned=True, table_limit=H100_TABLE_LIMIT)

    assert limit in ROUTE_LIMITS
    assert staged(limit) != staged(limit + 4)
