"""The kernels' per-graph plans, and numpy models of the decompositions that
``csrc/segment.cu`` and ``csrc/spmv.cu`` run over them.

A plan is built once per CSR pointer array on the host
(``segment_kernels.segment_plan``, ``pallas_kernels.spmv_plan``): the
merge-path coordinate of every segment tile, and the CSR pointers of every
spmv tile.  The kernels run only on the card (``chip_smoke.py``), so the
logic that spans tiles is checked here on numpy models that follow the
kernels' steps: per-tile partial sums with carries added in tile order
(segment), and row starts read from the tile that holds them (spmv).  The
models are held to the plain versions: float64 within 1e-12 of the row's
sum of |x| (other orders of addition), small integers exactly.
"""

import os
import pathlib
import re
import time

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pagerank as jops
from page_rank_and_tfidf_using_apache_spark_tpu_torch import convert
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk


def _from_dst(n: int, dst) -> np.ndarray:
    return np.searchsorted(np.sort(np.asarray(dst)), np.arange(n + 1))


def _ptr_cases(block: int) -> dict:
    """CSR pointers ``{name: ptr}`` around tiles of ``block`` items."""
    rng = np.random.default_rng(block)
    hub = 150 * block
    return {
        "random n=50 E=300": _from_dst(50, rng.integers(0, 50, 300)),
        "random n=1000 E=37": _from_dst(1000, rng.integers(0, 1000, 37)),
        "hub row over 150 tiles": np.array([0, hub]),
        "hub row 57 of 100 amid empty rows": np.r_[np.zeros(58, np.int64), np.full(43, hub)],
        "empty leading, inner and trailing rows": _from_dst(
            60, np.r_[rng.integers(10, 20, 3 * block), rng.integers(30, 40, 2 * block)]),
        "every row ends a tile": np.arange(41) * (block - 1),
        "n=0": np.zeros(1, np.int64),
        "E=0, n=30": np.zeros(31, np.int64),
    }


BLOCKS = (4, 7, sk.BLOCK_ITEMS)
CASES = [(b, name) for b in BLOCKS for name in _ptr_cases(b)]


def _merged_coords(ptr: np.ndarray, block: int) -> np.ndarray:
    """Brute force: the merged list of values and row ends, row by row,
    then the row ends before every tile's first item."""
    n, e = len(ptr) - 1, int(ptr[-1])
    items = []  # True: a row end
    for r in range(n):
        items += [False] * int(ptr[r + 1] - ptr[r]) + [True]
    ends_before = np.concatenate([[0], np.cumsum(items, dtype=np.int64)])
    tiles = -(-(n + e) // block) if n and e else 0
    return ends_before[[min(b * block, n + e) for b in range(tiles + 1)]]


@pytest.mark.parametrize("block, name", CASES)
def test_segment_coords_match_a_brute_force_merge(block, name):
    ptr = _ptr_cases(block)[name]
    got = sk.segment_coords(ptr, block)
    assert np.array_equal(got, _merged_coords(ptr, block))
    n, e = len(ptr) - 1, int(ptr[-1])
    assert got.shape[0] == sk.segment_tiles(n, e, block) + 1
    if got.shape[0] > 1:
        assert got[0] == 0 and got[-1] == n and np.all(np.diff(got) >= 0)
        assert np.all(np.diff(got) <= block)  # a tile ends at most `block` rows


def test_segment_plan_holds_coords_and_zeroed_scratch():
    ptr = _ptr_cases(sk.BLOCK_ITEMS)["hub row 57 of 100 amid empty rows"]
    plan = sk.segment_plan(torch.from_numpy(ptr.astype(np.int32)))
    tiles = sk.segment_tiles(100, int(ptr[-1]))
    assert (plan.n, plan.e) == (100, int(ptr[-1])) and tiles == 151
    assert plan.coords.dtype == torch.int32 and plan.coords.device.type == "cpu"
    assert plan.coords.tolist() == sk.segment_coords(ptr).tolist()
    assert plan.state.dtype == torch.uint8 and plan.state.numel() == 16 + 16 * tiles
    assert not plan.state.any()
    same = sk.segment_plan(ptr)
    assert torch.equal(same.coords, plan.coords) and same.state.numel() == plan.state.numel()


# --------------------------------------------------------------- spmv rows

SPMV_CASES = {
    "random": lambda rng, t: _from_dst(100, rng.integers(0, 100, 9 * t + 3)),
    "E a multiple of the tile": lambda rng, t: _from_dst(100, rng.integers(0, 100, 5 * t)),
    "empty leading and trailing rows": lambda rng, t: _from_dst(
        100, rng.integers(10, 90, 3 * t + 5)),
    "hub row over 40 tiles": lambda rng, t: np.r_[np.zeros(8), np.full(5, 40 * t)].astype(int),
    "one edge": lambda rng, t: np.array([0, 0, 1, 1]),
    "E=0": lambda rng, t: np.zeros(5, np.int64),
}


@pytest.mark.parametrize("tile", [4, 7, pk.TILE])
@pytest.mark.parametrize("name", sorted(SPMV_CASES))
def test_spmv_rows_are_the_pointers_of_each_tile(name, tile):
    indptr = SPMV_CASES[name](np.random.default_rng(tile), tile)
    n, e = len(indptr) - 1, int(indptr[-1])
    rows = pk.spmv_rows(indptr, tile)
    tiles = -(-e // tile)
    assert rows.shape == (tiles + 1,)
    want = np.searchsorted(indptr, np.arange(tiles + 1) * tile, side="right")
    if tiles:
        want[0], want[-1] = 0, n + 1
        assert np.array_equal(rows, want)
    for t in range(tiles):  # the pointers in (t·tile, end], and 0 in tile 0
        base, end = t * tile, min((t + 1) * tile, e)
        mine = np.flatnonzero(((indptr > base) | (t == 0)) & (indptr <= end))
        assert mine.tolist() == list(range(rows[t], rows[t + 1]))


def test_spmv_plan_holds_rows_and_zeroed_scratch():
    indptr = SPMV_CASES["random"](np.random.default_rng(0), pk.TILE)
    plan = pk.spmv_plan(torch.from_numpy(indptr.astype(np.int32)))
    tiles = -(-int(indptr[-1]) // pk.TILE)
    assert (plan.n, plan.e) == (100, int(indptr[-1]))
    assert plan.rows.dtype == torch.int32 and plan.rows.tolist() == pk.spmv_rows(indptr).tolist()
    assert plan.state.numel() == 16 + 48 * tiles and not plan.state.any()


# ------------------------------------------------------------------ models

def segment_model(v: np.ndarray, ptr: np.ndarray, block: int) -> np.ndarray:
    """``csrc/segment.cu``'s decomposition in numpy: tile by tile from the
    plan's coordinates, each tile walks its items in order, writes the rows
    it ends (but a row that began in an earlier tile), and keeps the carry
    of the row it ends in; a row that began earlier adds the carries of the
    tiles before it, back to the first whose key differs, then its own
    part, and no carry of that row lies below the tile before the one that
    holds the row's first value.  Every row is written exactly once."""
    n, e = len(ptr) - 1, int(ptr[-1])
    coords = sk.segment_coords(ptr, block)
    out = np.full(n, np.nan)
    carries = []
    for t in range(coords.shape[0] - 1):
        d0, d1 = t * block, min((t + 1) * block, n + e)
        x0, x1 = int(coords[t]), int(coords[t + 1])
        y0, y1 = d0 - x0, d1 - x1
        split = y0 > ptr[x0]
        x, y, acc, held = x0, y0, 0.0, None
        for _ in range(d0, d1):
            if y < ptr[x + 1]:
                acc += v[y]
                y += 1
            else:
                if x == x0 and split:
                    held = acc
                else:
                    assert np.isnan(out[x])
                    out[x] = acc
                acc, x = 0.0, x + 1
        assert (x, y) == (x1, y1)
        carries.append((x, acc))
        if held is not None:
            total = 0.0
            for key, val in reversed(carries[:-1]):
                if key != x0:
                    break
                total += val
            # the kernel reads carries only from the tile before the one
            # that holds the row's first value: none below ends in the row
            lo = max((int(ptr[x0]) + x0) // block - 1, 0)
            assert all(key != x0 for key, _ in carries[:lo])
            assert np.isnan(out[x0])
            out[x0] = total + held
    if e == 0:
        out[:] = 0.0
    assert not np.isnan(out).any()
    return out


def spmv_model(per_edge: np.ndarray, indptr: np.ndarray, tile: int) -> np.ndarray:
    """``csrc/spmv.cu``'s decomposition in numpy: tile t reads c0 only
    inside (t·tile, end] (or c0[0] in tile 0) and writes the rows whose end
    pointer falls there; a row that began in an earlier tile reads c0 at
    its start from tile (start - 1) // tile, which must have published it
    as c0 at its last pointer."""
    n, e = len(indptr) - 1, int(indptr[-1])
    c0 = np.concatenate([[0.0], np.cumsum(per_edge)])
    rows = pk.spmv_rows(indptr, tile)
    out = np.full(n, np.nan)
    last = {}  # tile -> (its last pointer, c0 there)
    for t in range(rows.shape[0] - 1):
        base, end = t * tile, min((t + 1) * tile, e)

        def local(j, base=base, end=end, t=t):
            assert base < j <= end or (t == 0 and j == 0)
            return c0[j]

        i0, i1 = int(rows[t]), int(rows[t + 1])
        for i in range(max(i0, 1), i1):
            j1, j0 = int(indptr[i]), int(indptr[i - 1])
            c1 = local(j1)
            if i > i0:
                c = local(j0)
            elif j0 == 0:
                c = 0.0
            else:
                ts = (j0 - 1) // tile
                assert ts < t and last[ts][0] == j0
                c = last[ts][1]
            assert np.isnan(out[i - 1])
            out[i - 1] = c1 - c
            if i == i1 - 1:
                last[t] = (j1, c1)
    if e == 0:
        out[:] = 0.0
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("kind", ["real", "integer"])
@pytest.mark.parametrize("block, name", [(b, n) for b in (4, 7) for n in _ptr_cases(b)])
def test_segment_model_matches_plain(block, name, kind):
    ptr = _ptr_cases(block)[name]
    n, e = len(ptr) - 1, int(ptr[-1])
    rng = np.random.default_rng(3)
    v = rng.integers(-3, 4, e).astype(np.float64) if kind == "integer" else rng.random(e)
    got = segment_model(v, ptr, block)
    want = sk.segment_sum_plain(torch.from_numpy(v), torch.from_numpy(ptr.astype(np.int32)),
                                n).numpy()
    if kind == "integer":
        assert np.array_equal(got, want)
    else:
        scale = np.add.reduceat(np.r_[np.abs(v), 0.0], ptr[:-1]) * (np.diff(ptr) > 0)
        assert np.all(np.abs(got - want) <= 1e-12 * scale)


@pytest.mark.parametrize("kind", ["real", "integer"])
@pytest.mark.parametrize("tile", [4, 7])
@pytest.mark.parametrize("name", sorted(SPMV_CASES))
def test_spmv_model_matches_plain(name, tile, kind):
    rng = np.random.default_rng(tile)
    indptr = SPMV_CASES[name](rng, tile)
    n, e = len(indptr) - 1, int(indptr[-1])
    src = rng.integers(0, n, e)
    w = rng.integers(1, 4, n).astype(np.float64) if kind == "integer" else rng.random(n)
    got = spmv_model(w[src], indptr, tile)
    want = pk.spmv_pallas_plain(torch.from_numpy(src.astype(np.int32)),
                                torch.from_numpy(indptr.astype(np.int32)),
                                torch.from_numpy(w), n=n).numpy()
    if kind == "integer":
        assert np.array_equal(got, want)
    else:
        c = np.concatenate([[0.0], np.cumsum(w[src])])
        assert np.all(np.abs(got - want) <= 1e-12 * (c[indptr[1:]] + c[indptr[:-1]]))


# ------------------------------------------------------- graphs and plans

def _same_plan(a, b) -> bool:
    return (type(a) is type(b) and (a.n, a.e) == (b.n, b.e)
            and all(torch.equal(x, y) for x, y in zip(a[2:], b[2:])))


def _graph_pair():
    return jg.synthetic_powerlaw(200, 1500, seed=5), tg.synthetic_powerlaw(200, 1500, seed=5)


@pytest.mark.parametrize("layout", [None, "hybrid", "sort_shuffle"])
def test_put_graph_builds_a_plan_for_each_pointer_array(layout):
    _, g = _graph_pair()
    sk.reset_launches()
    dg = tops.put_graph(g, "float64", layout=layout, head_row_width=16, bucket_width=4,
                        keep_edge_arrays=layout is None, device="cpu")
    if layout is None:
        assert _same_plan(dg.segment_plan, sk.segment_plan(dg.indptr))
        assert _same_plan(dg.spmv_plan, pk.spmv_plan(dg.indptr))
        assert dg.hybrid is None and dg.shuffle is None
    else:  # the layouts' graphs keep no edge arrays, so no indptr plans
        assert dg.segment_plan is None and dg.spmv_plan is None
    if layout == "hybrid":
        assert _same_plan(dg.hybrid.head_row_plan, sk.segment_plan(dg.hybrid.head_row_ptr))
    if layout == "sort_shuffle":
        assert _same_plan(dg.shuffle.bucket_plan, sk.segment_plan(dg.shuffle.bucket_ptr))


@pytest.mark.parametrize("layout", [None, "hybrid", "sort_shuffle"])
def test_convert_builds_the_plans_of_put_graph(layout):
    jgr, g = _graph_pair()
    keep = layout is None
    jdg = jops.put_graph(jgr, "float64", layout=layout, head_row_width=16, bucket_width=4,
                         keep_edge_arrays=keep)
    got = convert.device_graph(jdg, device="cpu")
    want = tops.put_graph(g, "float64", layout=layout, head_row_width=16, bucket_width=4,
                          keep_edge_arrays=keep, device="cpu")
    for name in ("segment_plan", "spmv_plan"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or _same_plan(a, b), name
    if layout == "hybrid":
        assert _same_plan(got.hybrid.head_row_plan, want.hybrid.head_row_plan)
    if layout == "sort_shuffle":
        assert _same_plan(got.shuffle.bucket_plan, want.shuffle.bucket_plan)
    # a converted port graph is planned anew, not copied
    again = convert.device_graph(got, device="cpu")
    for name in ("segment_plan", "spmv_plan"):
        a, b = getattr(again, name), getattr(want, name)
        assert (a is None and b is None) or _same_plan(a, b), name


def test_each_plan_is_built_once_per_graph():
    _, g = _graph_pair()
    sk.reset_launches()
    pk.reset_launches()
    dg = tops.put_graph(g, "float64", device="cpu")
    w = torch.from_numpy(np.random.default_rng(1).random(g.n_nodes))
    for impl in ("segment", "pallas"):
        tops.spmv(dg, w, g.n_nodes, impl)
    assert sk.PLANS_BUILT == {"segment": 1} and pk.PLANS_BUILT == {"spmv": 1}
    sk.reset_launches()
    assert sk.PLANS_BUILT == {"segment": 0}


# ---------------------------------------------------------------- wrappers

def test_wrappers_on_the_cpu_ignore_the_plan():
    ptr = torch.tensor([0, 2, 3, 5, 6], dtype=torch.int32)
    values = torch.arange(1.0, 7.0, dtype=torch.float64)
    plan = sk.segment_plan(ptr)
    assert torch.equal(sk.segment_sum_kernel(values, ptr, 4, plan=plan),
                       sk.segment_sum_plain(values, ptr, 4))
    src = torch.tensor([0, 1, 2, 3, 0, 1], dtype=torch.int32)
    w = torch.arange(1.0, 5.0, dtype=torch.float64)
    got = pk.spmv_pallas(src, ptr, w, n=4, plan=pk.spmv_plan(ptr))
    assert torch.equal(got, pk.spmv_pallas_plain(src, ptr, w, n=4))
    assert sk.LAUNCHES == {"segment": 0} and pk.LAUNCHES["spmv"] == 0


@pytest.mark.parametrize("bad, error", [
    ("other pointers", ValueError),
    ("not a plan", TypeError),
    ("on another device", ValueError),
])
@pytest.mark.parametrize("wrapper", ["segment", "spmv"])
def test_wrappers_reject_a_plan_that_is_not_the_graphs(wrapper, bad, error):
    ptr = torch.tensor([0, 2, 3, 5, 6], dtype=torch.int32)
    other = torch.tensor([0, 2, 3, 5, 7], dtype=torch.int32)
    make = sk.segment_plan if wrapper == "segment" else pk.spmv_plan
    plan = {"other pointers": make(other), "not a plan": (4, 6),
            "on another device": make(ptr, device="meta")}[bad]
    with pytest.raises(error):
        if wrapper == "segment":
            sk.segment_sum_kernel(torch.ones(6, dtype=torch.float64), ptr, 4, plan=plan)
        else:
            pk.spmv_pallas(torch.zeros(6, dtype=torch.int32), ptr,
                           torch.ones(4, dtype=torch.float64), n=4, plan=plan)


# --------------------------------------------------------------- the build

EXPORT = re.compile(r"^(?:int|long long|const char\*) (\w+)\(([^)]*)\)", re.M)


@pytest.mark.parametrize("name", sorted(set(_build.SIGNATURES) - {"segment"}))
def test_build_knows_every_export(name):
    """``_build.SIGNATURES[name]`` names exactly the C functions
    ``csrc/<name>.cu`` exports, with as many arguments (``segment`` in
    ``test_torch_segment.py``)."""
    text = (_build.SRC_DIR / f"{name}.cu").read_text()
    exported = text[text.index('extern "C" {'):]
    found = {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
             for m in EXPORT.finditer(exported)}
    assert {k: len(v[1]) for k, v in _build.SIGNATURES[name].items()} == found


def test_plan_sizes_match_the_sources():
    """The wrappers' tile sizes and scratch layout are the kernels'."""
    seg = (_build.SRC_DIR / "segment.cu").read_text()
    assert "constexpr int kItems = 8;" in seg and "constexpr int kThreads = 256;" in seg
    assert sk.BLOCK_ITEMS == 256 * 8
    scan = (_build.SRC_DIR / "scan.cuh").read_text()
    assert "constexpr int kItems = 16;" in scan and pk.TILE == 256 * 16
    spmv = (_build.SRC_DIR / "spmv.cu").read_text()
    assert "3 * tiles * static_cast<long long>(sizeof(Slot))" in spmv


@pytest.mark.parametrize("name", ["segment", "spmv"])
def test_a_newer_plan_header_rebuilds(name, tmp_path, monkeypatch):
    src, build = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    build.mkdir()
    for p in _build.SRC_DIR.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    now = time.time()
    for p in src.iterdir():
        os.utime(p, (now - 100, now - 100))
    _build.lib_path(name).write_bytes(b"")
    os.utime(_build.lib_path(name), (now - 50, now - 50))
    assert not _build._stale(name)
    os.utime(src / "plan.cuh", (now, now))
    assert _build._stale(name)


def test_plan_header_is_among_the_sources():
    assert (pathlib.Path(_build.SRC_DIR) / "plan.cuh").is_file()
    for name in ("segment", "spmv"):
        assert '#include "plan.cuh"' in (_build.SRC_DIR / f"{name}.cu").read_text()
