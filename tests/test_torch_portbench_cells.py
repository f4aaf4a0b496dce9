"""The benchmark's PageRank cells at a size the CPU runs: the port's
``api.pagerank`` on a graph of each configuration's shape, held to the
benchmark's plain float64 yardstick under the cell's own limits; and the
cells as ``BENCHMARK.json`` declares them.

The graphs come from the benchmark's generator (``portbench/graphgen.py``)
with nodes, edges and both largest degrees cut by one factor to about
20,000 nodes; exponents and dangling share are the configuration's.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu_torch import api
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import from_edges
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
from portbench import checks, graphgen, reference, spec

ROOT = Path(__file__).resolve().parents[1]
NODES = 20_000

# the published counts of each configuration's graph: (nodes, edges)
PUBLISHED = {"snap-web-google": (875_713, 5_105_039),
             "law-twitter-2010": (41_652_230, 1_468_365_182)}


def _cut(graph: dict) -> dict:
    f = NODES / graph["nodes"]
    g = dict(graph)
    for k in ("nodes", "edges", "max_out_degree", "max_in_degree"):
        g[k] = max(1, round(graph[k] * f))
    return g


@pytest.mark.parametrize("cell", ["wg-pagerank-20it", "tw-pagerank-20it"])
def test_pagerank_at_the_cells_shape_is_within_its_limits(cell):
    c = spec.load(ROOT, cell)
    g = _cut(c.config["graph"])
    edges = graphgen.generate(g.pop("nodes"), g.pop("edges"), seed=2_147_483_659 + len(cell),
                              device="cpu", **g)
    src, dst = edges.src.numpy(), edges.dst.numpy()
    graph = from_edges(src, dst, compact_ids=False)
    assert (graph.n_nodes, graph.n_edges) == (edges.n, src.shape[0])
    pr = c.config["pagerank"]
    iters = int(c.traffic["iterations"])
    res = api.pagerank(graph, PageRankConfig(iterations=iters, **pr), device="cpu")
    assert res.iterations == iters == 20
    ref = reference.pagerank(
        reference.build(src, dst, edges.n, "cpu"), reference.restart_matrix(edges.n, None, "cpu"),
        iterations=iters, damping=pr["damping"], dangling=pr["dangling"], init=pr["init"])
    readings = checks.readings(res.ranks[None, :], ref)
    ok, table = checks.judge(readings, c.limits)
    assert ok, table
    assert abs(float(ref.sum()) - 1.0) < 1e-9


def test_the_new_cells_load_with_their_counts_and_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    for cell, config in (("wg-pagerank-20it", "snap-web-google"),
                         ("tw-pagerank-20it", "law-twitter-2010")):
        c = spec.load(ROOT, cell)
        assert c.chips == 1 and c.limits is not None
        assert c.config["name"] == config and c.traffic["entry"] == "pagerank"
        reduced = configs[config]["reduced"]
        for key, published in zip(("nodes", "edges"), PUBLISHED[config]):
            assert c.config["graph"][key] == published or f"graph.{key}" in reduced, key
        assert {m["name"] for m in c.end_to_end} == {"pr_iters_per_s", "pr_call_p95_ms", "setup_s"}
        names = {m["name"] for m in c.per_layer}
        assert "put_device_gb.pr" in names
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"].startswith("pr_") or m["name"].endswith(".pr"):
                assert cell in m["workloads"], m["name"]
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(ROOT, m["name"]))


def test_put_device_gb_reads_the_put_records():
    from portbench import layers

    def ctx(*records):
        calls = [layers.Call(0.1, 20, 1, [r, {"event": "result_pull", "secs": 0.1}])
                 for r in records]
        return layers.Context(calls=calls, window_s=1.0, setup_s=1.0, nodes=1, edges=1,
                              config={}, trace=None)

    read = spec.reader(ROOT, "put_device_gb.pr")
    assert read(ctx({"event": "put_graph", "device_bytes": 3e9},
                    {"event": "put_graph", "device_bytes": 5e9})) == pytest.approx(4.0)
    # a program that does not count it gives the metric nothing to read
    assert read(ctx({"event": "put_graph", "h2d_bytes": 10})) is None
    assert read(ctx()) is None
