"""The span tree of one PageRank or PPR call of the port, and the records that
read it.

Every phase of ``run_pagerank`` and ``run_ppr_batch`` is an obs span whose
chain of parents reaches the call's own ``<p>.call`` span: the host
preparation (``<p>.prep``), the put (``<p>.put_graph``) with its copies
(``device.h2d``) and plan builds (``ops.segment_plan``, ``ops.spmv_plan``),
the segment loop and the result pull.  The ``put_graph`` record sums the
put's copies and plans and carries the prep's seconds; ``result_pull`` has
a record of its own, with no ``iter`` (the benchmark's ``loop_ms`` reads
only the segment records).  A resumed run keeps the JAX package's record
order.
"""

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.models.pagerank import run_pagerank as jrun
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.metrics import MetricsRecorder as JMetrics
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import run_components
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder
from tests.port_telemetry import reference_view

N, E, SEED = 120, 600, 11
# impl -> (segment plans, spmv plans) that the put builds
PLANS = {"segment": (1, 1), "pallas": (1, 1), "bcoo": (1, 1), "hybrid": (1, 0),
         "sort_shuffle": (1, 0)}


def graph():
    return tg.synthetic_powerlaw(N, E, seed=SEED)


def queries(g):
    return [[int(g.node_ids[0])], [int(g.node_ids[7])], [int(g.node_ids[7])]]


def call(entry: str, g, cfg, **kw):
    if entry == "pagerank":
        return run_pagerank(g, cfg, device="cpu", **kw)
    return run_ppr_batch(g, cfg, queries(g), device="cpu", **kw)


def traced(fn):
    """``fn()``'s result and the span_end events it published, by span id."""
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    try:
        out = fn()
    finally:
        obs.bus().detach(sink)
    return out, {e["span"]: e for e in sink.of_kind("span_end")}


def ancestors(spans: dict, sid: int) -> list:
    """Names of the span ``sid``'s parents, innermost first."""
    out, par = [], spans[sid]["parent"]
    while par is not None:
        out.append(spans[par]["name"])
        par = spans[par]["parent"]
    return out


def named(spans: dict, name: str) -> list:
    return [e for e in spans.values() if e["name"] == name]


@pytest.mark.parametrize("impl", sorted(PLANS))
@pytest.mark.parametrize("entry", ["pagerank", "ppr"])
def test_every_phase_span_descends_from_the_call(entry, impl):
    g = graph()
    cfg = tcfg.PageRankConfig(iterations=6, spmv_impl=impl, head_row_width=8)
    res, spans = traced(lambda: call(entry, g, cfg))
    (top,) = named(spans, f"{entry}.call")
    assert top["parent"] is None and top["status"] == "ok"
    attrs = {"nodes": N, "edges": g.n_edges} | ({"queries": 3} if entry == "ppr" else {})
    assert top["attrs"] == attrs
    for sid, e in spans.items():
        if sid != top["span"]:
            assert ancestors(spans, sid)[-1] == f"{entry}.call", e["name"]
    assert len(named(spans, f"{entry}.put_graph")) == 1
    assert len(named(spans, f"{entry}.prep")) == (1 if entry == "pagerank" else 2)
    assert len(named(spans, f"{entry}.result_pull")) == 1
    assert len(named(spans, f"{entry}.segment")) == 1
    # a layout impl uploads zero-length placeholders of the edge arrays
    copies = named(spans, "device.h2d")
    assert any(e["attrs"]["bytes"] > 0 for e in copies)
    # each copy and plan build lies in the put or the prep
    for e in copies + named(spans, "ops.segment_plan") + named(spans, "ops.spmv_plan"):
        assert ancestors(spans, e["span"])[0] in (f"{entry}.put_graph", f"{entry}.prep")
    assert (len(named(spans, "ops.segment_plan")),
            len(named(spans, "ops.spmv_plan"))) == PLANS[impl]
    assert res.ranks.shape[-1] == N


@pytest.mark.parametrize("entry", ["pagerank", "ppr"])
def test_put_graph_record_sums_the_puts_spans(entry):
    g = graph()
    res, spans = traced(lambda: call(entry, g, tcfg.PageRankConfig(iterations=4)))
    (put,) = [r for r in res.metrics.records if r.get("event") == "put_graph"]
    (put_span,) = named(spans, f"{entry}.put_graph")
    in_put = [e for e in spans.values() if put_span["name"] in ancestors(spans, e["span"])]
    copies = [e for e in in_put if e["name"] == "device.h2d"]
    plans = [e for e in in_put if e["name"] in ("ops.segment_plan", "ops.spmv_plan")]
    assert put["h2d_bytes"] == sum(e["attrs"]["bytes"] for e in copies) > 0
    # each record value is the Timer around its span, so never shorter
    assert put["h2d_secs"] >= sum(e["secs"] for e in copies) > 0
    assert put["plan_secs"] >= sum(e["secs"] for e in plans) > 0
    assert put["h2d_secs"] + put["plan_secs"] <= put["preprocess_secs"]
    assert put["preprocess_secs"] >= put_span["secs"]
    preps = named(spans, f"{entry}.prep")
    in_driver = preps[-1]["secs"]  # the prep in the driver that writes put_graph
    assert put["prep_secs"] >= in_driver > 0
    prep_total = sum(r["prep_secs"] for r in res.metrics.records if "prep_secs" in r)
    assert prep_total >= sum(e["secs"] for e in preps)
    if entry == "ppr":
        (batch,) = [r for r in res.metrics.records if r.get("event") == "ppr_batch"]
        assert batch["prep_secs"] >= preps[0]["secs"] > 0
        # the restart matrix goes up inside the put
        assert any(e["attrs"]["bytes"] == 3 * N * 4 for e in copies)


@pytest.mark.parametrize("entry", ["pagerank", "ppr"])
def test_result_pull_has_a_record_of_its_own(entry):
    g = graph()
    res, spans = traced(lambda: call(entry, g, tcfg.PageRankConfig(iterations=5,
                                                                   checkpoint_every=0)))
    pulls = [r for r in res.metrics.records if r.get("event") == "result_pull"]
    assert [sorted(r) for r in pulls] == [["bytes", "event", "secs"]]
    assert "iter" not in pulls[0] and pulls[0]["bytes"] == res.ranks.nbytes
    (span,) = named(spans, f"{entry}.result_pull")
    assert pulls[0]["secs"] >= span["secs"] > 0
    assert res.metrics.records[-1] is pulls[0]
    # the loop's records, those with iter and secs, are the segments alone
    assert [r["iter"] for r in res.metrics.records if "iter" in r and "secs" in r] == [5]


def test_resumed_pagerank_keeps_the_reference_record_order(tmp_path):
    """The checkpoint's ranks go up again outside the prep, after the
    put_graph record, so the records keep the JAX package's order."""
    kw = dict(iterations=8, dangling="redistribute", init="uniform", dtype="float64",
              checkpoint_every=4)
    g, jgraph = graph(), jg.synthetic_powerlaw(N, E, seed=SEED)
    for d, iters in (("t", 6), ("j", 6)):
        cfg = dict(kw, iterations=iters, checkpoint_dir=str(tmp_path / d))
        if d == "t":
            run_pagerank(g, tcfg.PageRankConfig(**cfg), device="cpu")
        else:
            jrun(jgraph, jcfg.PageRankConfig(**cfg))
    jm = JMetrics()
    jrun(jgraph, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")), metrics=jm,
         resume=True)
    m = MetricsRecorder()
    res, spans = traced(lambda: run_pagerank(
        g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "t")), metrics=m,
        resume=True, device="cpu"))
    assert [r.get("event") for r in m.records] == [
        "put_graph", "resume", None, "result_pull"]
    assert [sorted(r) for r in reference_view(m.records)] == [sorted(r) for r in jm.records]
    # three copies outside the put: the prep's two and the resumed ranks
    outside = [e for e in named(spans, "device.h2d")
               if "pagerank.put_graph" not in ancestors(spans, e["span"])]
    assert [ancestors(spans, e["span"])[0] for e in outside] == [
        "pagerank.prep", "pagerank.prep", "pagerank.call"]
    unbroken = run_pagerank(g, tcfg.PageRankConfig(**dict(kw, checkpoint_every=0)),
                            device="cpu")
    np.testing.assert_array_equal(res.ranks, unbroken.ranks)


def test_resumed_ppr_keeps_its_record_order(tmp_path):
    """The fixpoint driver's prep uploads the initial carry; a resumed one
    goes up again outside it, so the resume record still comes before the
    put_graph record, as in the JAX package's driver."""
    kw = dict(iterations=8, dtype="float64", checkpoint_every=4)
    g = graph()
    q = queries(g)
    run_ppr_batch(g, tcfg.PageRankConfig(**dict(kw, iterations=6),
                                         checkpoint_dir=str(tmp_path)), q, device="cpu")
    m = MetricsRecorder()
    res, spans = traced(lambda: run_ppr_batch(
        g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path)), q, metrics=m,
        resume=True, device="cpu"))
    assert [r.get("event") for r in m.records] == [
        "ppr_batch", "resume", "put_graph", None, "result_pull"]
    outside = [e for e in named(spans, "device.h2d")
               if "ppr.put_graph" not in ancestors(spans, e["span"])]
    assert [ancestors(spans, e["span"])[0] for e in outside] == ["ppr.prep", "ppr.call"]
    unbroken = run_ppr_batch(g, tcfg.PageRankConfig(**dict(kw, checkpoint_every=0)), q,
                             device="cpu")
    np.testing.assert_array_equal(res.ranks, unbroken.ranks)


@pytest.mark.parametrize("workload", ["hits", "cc"])
def test_every_fixpoint_workload_spans_its_prep_and_put(workload):
    """HITS and components share the fixpoint driver: the same prep and put
    spans under their prefix, and the same record fields."""
    g = graph()
    run = (lambda: run_hits(g, tcfg.HitsConfig(iterations=5), device="cpu")) \
        if workload == "hits" else \
        (lambda: run_components(g, tcfg.ComponentsConfig(iterations=5), device="cpu"))
    res, spans = traced(run)
    assert len(named(spans, f"{workload}.prep")) == 1
    (put_span,) = named(spans, f"{workload}.put_graph")
    copies = [e for e in named(spans, "device.h2d")
              if ancestors(spans, e["span"])[0] == put_span["name"]]
    (put,) = [r for r in res.metrics.records if r.get("event") == "put_graph"]
    assert put["h2d_bytes"] == sum(e["attrs"]["bytes"] for e in copies) > 0
    assert put["h2d_secs"] + put["plan_secs"] <= put["preprocess_secs"]
    # HITS builds the reverse pass's plan too
    assert len(named(spans, "ops.segment_plan")) == (2 if workload == "hits" else 1)
    (pull,) = [r for r in res.metrics.records if r.get("event") == "result_pull"]
    assert "iter" not in pull and pull["bytes"] > 0


def test_a_call_with_no_ranks_to_compute_is_still_one_call_span():
    _, spans = traced(lambda: run_pagerank(tg.parse_snap_text(""), tcfg.PageRankConfig(),
                                           device="cpu"))
    assert [e["name"] for e in spans.values()] == ["pagerank.call"]
    assert spans[next(iter(spans))]["attrs"] == {"nodes": 0, "edges": 0}


def test_the_bridge_to_a_profiler_keeps_the_call_tree():
    """Under ``torch.profiler`` the call's phases are host ranges of the
    same names, nested as the spans are."""
    from torch.profiler import ProfilerActivity, profile

    g = graph()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_pagerank(g, tcfg.PageRankConfig(iterations=3), device="cpu")
    keys = {e.key for e in prof.key_averages()}
    assert {"pagerank.call", "pagerank.prep", "pagerank.put_graph", "device.h2d",
            "ops.segment_plan", "ops.spmv_plan", "pagerank.segment",
            "pagerank.result_pull"} <= keys
