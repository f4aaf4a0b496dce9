"""Peaks of the card and the bytes a kernel call needs, counted from shapes.

A kernel's share of its roofline is the least time the card could take
for the call, the bytes it needs over the peak bandwidth, divided by the
time the profiler saw the kernel take.  Bytes count each input read once
and each output written once, whatever the kernel reads again, and leave
out its scratch.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published (data sheet): HBM3 bandwidth, bytes/s, at the
# full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12

# Merge-path items a tile of the program's segmented sum takes; the plan
# the kernel reads holds one int32 coordinate a tile, plus one.
SEGMENT_TILE_ITEMS = 2048


def segment_gather_bytes(n: int, e: int, value_bytes: int = 4, out_bytes: int = 4) -> int:
    """One gathered segmented sum ``out[v] = sum x[src[k]]`` over the CSR
    rows of ``e`` destination-sorted edges into ``n`` rows: ``src`` (int32
    [e]), ``x`` ([n]), the row pointers (int32 [n+1]) and the tile
    coordinates (int32 [tiles+1]) read once, ``out`` ([n]) written once."""
    tiles = -(-(n + e) // SEGMENT_TILE_ITEMS)
    return 4 * e + value_bytes * n + 4 * (n + 1) + 4 * (tiles + 1) + out_bytes * n


def share_pct(n_bytes: float, seconds: float) -> float | None:
    """Percent of the byte roofline that ``n_bytes`` moved in ``seconds``
    reach; None where nothing was timed."""
    if seconds <= 0:
        return None
    return 100.0 * n_bytes / PEAK_BYTES_PER_S / seconds
