"""Impacted-list scoring and delta segments of the port, on the CPU.

``serving/segments.py`` is a copy of the JAX package's: its code
(docstrings aside) is the reference's, the merge's guarded call at the
``segment_merge`` site included.  A segmented directory
written by either package loads in the other with equal re-weighted
tables.  The tests of ``tests/test_segments.py`` that need no chaos or
registry are ported: impacted scoring equal to COO scoring bit for bit
for every ranker, the bucket planner against a naive walk, the CSC-by-term
layout, the segment lifecycle (seal, commit, serve, merge, hot-swap) and a
query served from a segment committed after the server started.
"""

from __future__ import annotations

import ast
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import serving as jserving
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.serving import segments as jsgm
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import serve as cli_serve
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
    run_tfidf,
    run_tfidf_streaming,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.artifact import (
    build_term_offsets,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
    IMPACT_MIN_BUCKET_BITS,
    _check_impacted_servable,
    _Pending,
    impacted_pad_plan,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import device as tdevice
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    TfidfConfig,
)
from tests.test_torch_obs import PORT, REF, _code
from tests.test_torch_serving import QUERIES, assert_topk, make_server, oracle_scores

FIXTURE = Path(__file__).parent / "fixtures" / "tiny.txt"
CFG = TfidfConfig(vocab_bits=10, idf_mode="smooth", l2_normalize=True)


@pytest.fixture(scope="module")
def oracle_index(tmp_path_factory):
    """The sklearn-oracle corpus built into one servable artifact with
    BM25 weights and a PageRank prior — the byte-equality substrate."""
    out = run_tfidf(_docs(), CFG, device="cpu")
    d = tmp_path_factory.mktemp("idx")
    ranks = np.linspace(0.5, 1.5, out.n_docs).astype(np.float32)
    serving.save_index(str(d), out, CFG, ranks=ranks, bm25=Bm25Config())
    return serving.load_index(str(d))


def _docs() -> list[str]:
    return FIXTURE.read_text().splitlines()


# ------------------------------------------------------------------ the copy

class _WithoutMergeDevice(ast.NodeTransformer):
    """The port's one addition to ``serving/segments.py``: the ``device``
    argument of ``merge_segments`` and ``SegmentMerger``, the merger's
    ``self.device = device``, and the two places that pass it on."""

    def _drop_device(self, args: ast.arguments) -> None:
        names = [a.arg for a in args.args]
        if "device" in names:
            i = names.index("device")
            del args.args[i]
            del args.defaults[i - (len(names) - len(args.defaults))]
        names = [a.arg for a in args.kwonlyargs]
        if "device" in names:
            i = names.index("device")
            del args.kwonlyargs[i], args.kw_defaults[i]

    def visit_FunctionDef(self, node):
        if node.name in ("merge_segments", "__init__"):
            self._drop_device(node.args)
        self.generic_visit(node)
        return node

    def visit_Assign(self, node):
        tgt = node.targets[0]
        if (isinstance(tgt, ast.Attribute) and tgt.attr == "device"
                and isinstance(node.value, ast.Name) and node.value.id == "device"):
            return None
        self.generic_visit(node)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        name = getattr(node.func, "id", None)
        if name == "TfidfOutput":
            node.keywords = [k for k in node.keywords if k.arg != "device"]
        if (name == "merge_segments" and len(node.args) == 4
                and isinstance(node.args[3], ast.Attribute)
                and node.args[3].attr == "device"):
            node.args = node.args[:3]
        return node


def test_copy_matches_reference():
    """The copy's code is the reference's but for the merge's ``device``."""
    port = PORT / "serving" / "segments.py"
    assert (_code(port, _WithoutMergeDevice())
            == _code(REF / "serving" / "segments.py"))
    assert _code(port) != _code(REF / "serving" / "segments.py")


# ------------------------------------------------ impacted-list equality

def test_impacted_byte_equal_to_coo_all_rankers(oracle_index):
    """Impacted-list results equal the COO path's bit for bit for tfidf,
    bm25 AND the per-request prior blend — same corpus, same queries, only
    ServeConfig.scoring differs."""
    expect: dict = {}
    for scoring in ("coo", "impacted"):
        with make_server(oracle_index, top_k=4, max_batch=4, scoring=scoring,
                         prior_alpha=0.25) as srv:
            for ranker in serving.RANKERS:
                for q in QUERIES:
                    scores, idx = srv.query(q, ranker=ranker)
                    key = (ranker, tuple(q))
                    got = (scores.tobytes(), idx.tobytes())
                    if scoring == "coo":
                        expect[key] = got
                    else:
                        assert got == expect[key], (ranker, q)


def test_impacted_bucket_planner_matches_naive(oracle_index):
    """The vectorized host planner produces exactly the buckets a naive
    per-term walk of the CSC offsets would, each with its term's slot."""
    srv = make_server(oracle_index, top_k=4, scoring="impacted", impact_bucket_width=4)
    seg = srv._build_segs(srv._segset, srv.k)[0]
    uniq = [_Pending(b"k", *srv.make_query(q)) for q in QUERIES]
    bs, bl, br, bqw, bslot, total = srv._plan_impacted([seg], uniq, np.float32)[0]
    W = 4
    off = seg.offsets
    exp = []
    for row, p in enumerate(uniq):
        for slot, (t, w) in enumerate(zip(p.q_term, p.q_weight)):
            s, e = int(off[t]), int(off[t + 1])
            run = e - s
            for j in range((run + W - 1) // W):
                exp.append((s + j * W, min(W, run - j * W), row, float(w), slot))
    assert total == len(exp)
    for i, (s, ln, row, w, slot) in enumerate(exp):
        assert (bs[i], bl[i], br[i], bslot[i]) == (s, ln, row, slot)
        assert bqw[i] == w
    # pad tail is inert
    assert (bl[total:] == 0).all() and (bqw[total:] == 0).all()


def test_artifact_term_offsets_describe_runs(oracle_index):
    off = oracle_index.term_offsets
    term = np.asarray(oracle_index.term)
    assert off is not None and off.shape[0] == oracle_index.vocab_size + 1
    assert off[0] == 0 and off[-1] == oracle_index.nnz
    np.testing.assert_array_equal(
        off, build_term_offsets(term, oracle_index.vocab_size))
    for t in np.unique(term)[:20]:
        s, e = int(off[t]), int(off[t + 1])
        assert (term[s:e] == t).all()


def test_registry_covers_impacted_entries():
    """The impacted scorer writes no input, its bucket plan stays under its
    ceiling, and the segments' merge is registered (the twin of
    tests/test_segments.py's)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import ENTRY_POINTS

    eps = {ep.name: ep for ep in ENTRY_POINTS}
    imp = eps["tfidf_score_impacted_batch"]
    assert imp.donate == ()  # must write no input
    assert imp.pad_plan is not None and imp.pad_frac_ceiling is not None
    worst = max(frac for _, frac in imp.pad_plan())
    assert worst <= imp.pad_frac_ceiling
    assert "tfidf_topk_merge" in eps


def test_streaming_built_artifact_is_term_sorted(tmp_path):
    docs = _docs()
    chunks = [docs[i:i + 3] for i in range(0, len(docs), 3)]
    scfg = TfidfConfig(vocab_bits=10, prefetch=0, pipeline_depth=0)
    out = run_tfidf_streaming(iter(chunks), scfg, device="cpu")
    serving.save_index(str(tmp_path), out, scfg)
    idx = serving.load_index(str(tmp_path))
    term = np.asarray(idx.term)
    doc = np.asarray(idx.doc)
    assert ((term[1:] > term[:-1])
            | ((term[1:] == term[:-1]) & (doc[1:] >= doc[:-1]))).all()
    assert idx.term_offsets is not None


def test_impacted_pad_plan_policy():
    plan = impacted_pad_plan([10, 60, 64, 100])
    assert plan[0][0] == "impacted"
    assert 0.0 <= plan[0][1] < 0.7
    floor = impacted_pad_plan([1])
    assert floor[0][1] == 1 - 1 / (1 << IMPACT_MIN_BUCKET_BITS)


def test_impacted_refuses_what_it_cannot_slice(oracle_index):
    """A segment past 2^31 postings (int32 run starts) or without CSC
    offsets serves through the COO path only."""
    segset = sgm.wrap_index_as_set(oracle_index)
    seg = segset.segments[0]
    impacted = serving.ServeConfig(scoring="impacted")
    big = sgm.SegmentSet(
        directory=segset.directory, manifest=segset.manifest, cfg=segset.cfg,
        df_global=segset.df_global,
        segments=(sgm.LoadedSegment(index=seg.index, weights=seg.weights,
                                    term_offsets=seg.term_offsets,
                                    ref=sgm.SegmentRef("v9", 0, seg.ref.n_docs, 1 << 31)),))
    with pytest.raises(ValueError, match="int32 offsets"):
        _check_impacted_servable(impacted, big)
    legacy = sgm.SegmentSet(
        directory=segset.directory, manifest=segset.manifest, cfg=segset.cfg,
        df_global=segset.df_global,
        segments=(sgm.LoadedSegment(index=seg.index, weights=seg.weights,
                                    term_offsets=None, ref=seg.ref),))
    with pytest.raises(ValueError, match="legacy"):
        serving.TfidfServer(legacy, impacted, device="cpu")
    _check_impacted_servable(serving.ServeConfig(), big)  # coo takes both


# ------------------------------------------------------ segment lifecycle

def _seal(d, docs, scfg, base, bm25=Bm25Config()):
    out = run_tfidf(docs, scfg, device="cpu")
    ref = sgm.seal_segment(str(d), out, scfg, doc_base=base,
                           ranks=np.ones(out.n_docs, np.float32), bm25=bm25)
    sgm.commit_append(str(d), ref, scfg.config_hash())
    return out, ref


def test_segment_seal_commit_and_global_stats(tmp_path):
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    half = len(docs) // 2
    o1, r1 = _seal(tmp_path, docs[:half], scfg, 0)
    o2, r2 = _seal(tmp_path, docs[half:], scfg, o1.n_docs)
    m = sgm.latest_manifest(str(tmp_path))
    assert m.version == 2 and len(m.segments) == 2
    assert m.n_docs == o1.n_docs + o2.n_docs
    segset = sgm.load_segment_set(str(tmp_path))
    full = run_tfidf(docs, scfg, device="cpu")
    np.testing.assert_array_equal(segset.df_global, full.df)
    with pytest.raises(ValueError, match="refusing"):
        sgm.load_segment_set(str(tmp_path), expect_config_hash="nope")
    other = TfidfConfig(vocab_bits=10, idf_mode="smooth")
    bad = run_tfidf(docs[:2], other, device="cpu")
    ref = sgm.seal_segment(str(tmp_path), bad, other, doc_base=m.n_docs)
    with pytest.raises(ValueError, match="refusing"):
        sgm.commit_append(str(tmp_path), ref, other.config_hash())


@pytest.mark.parametrize("scoring", ["coo", "impacted"])
def test_segmented_scoring_matches_full_rebuild(tmp_path, scoring):
    """Cross-segment scoring under summed global stats == a monolithic
    rebuild of the same corpus (global IDF drift included)."""
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    half = len(docs) // 2
    o1, _ = _seal(tmp_path, docs[:half], scfg, 0)
    _seal(tmp_path, docs[half:], scfg, o1.n_docs)
    segset = sgm.load_segment_set(str(tmp_path))
    full = run_tfidf(docs, scfg, device="cpu")
    serving.save_index(str(tmp_path / "ref"), full, scfg)
    with make_server(segset, top_k=5, scoring=scoring) as seg_srv, \
            make_server(serving.load_index(str(tmp_path / "ref")), top_k=5) as ref_srv:
        for q in QUERIES:
            ss, si = seg_srv.query(q)
            rs, ri = ref_srv.query(q)
            np.testing.assert_allclose(ss, rs, atol=1e-5)
            if rs.shape[0] > 1 and np.all(np.abs(np.diff(rs)) > 1e-6):
                np.testing.assert_array_equal(si, ri)


def test_segmented_served_matches_reference_server(tmp_path):
    """Three segments served by the port and by the JAX server: scores
    within 2e-6 of the float64 oracle over the re-weighted tables, ids
    equal wherever the oracle separates them, ties to the older segment."""
    scfg = TfidfConfig(vocab_bits=10, idf_mode="smooth", l2_normalize=True)
    docs = [d for d in _docs() for _ in range(2)]  # exact ties across segments
    third = len(docs) // 3
    o1, _ = _seal(tmp_path, docs[:third], scfg, 0)
    o2, _ = _seal(tmp_path, docs[third:2 * third], scfg, o1.n_docs)
    _seal(tmp_path, docs[2 * third:], scfg, o1.n_docs + o2.n_docs)
    segset = sgm.load_segment_set(str(tmp_path))
    jset = jsgm.load_segment_set(str(tmp_path))
    k = 6
    with jserving.TfidfServer(jset, jserving.ServeConfig(top_k=k)) as jsrv:
        ref = {tuple(q): jsrv.query(q) for q in QUERIES}
    for scoring in ("coo", "impacted"):
        with make_server(segset, top_k=k, scoring=scoring) as srv:
            for q in QUERIES:
                s, i = srv.query(q)
                qt, qw = srv.make_query(q)
                want = np.concatenate([
                    oracle_scores(seg.index, seg.weights["tfidf"], qt, qw)
                    for seg in segset.segments])
                assert_topk(s, i, want, k, ref[tuple(q)][1], label=f"{scoring} {q}")


def test_query_served_from_segment_committed_after_start(tmp_path):
    """A segment committed after server start is servable via
    refresh_segments — no restart — and returns GLOBAL doc ids from the
    new segment's range."""
    scfg = TfidfConfig(vocab_bits=10)
    o1, _ = _seal(tmp_path, _docs(), scfg, 0)
    srv = make_server(sgm.load_segment_set(str(tmp_path)), top_k=3, scoring="impacted").start()
    try:
        s0, _ = srv.query(["zzzfresh"])
        assert float(s0[0]) == 0.0  # unknown term before the commit
        _seal(tmp_path, ["zzzfresh newdoc content"], scfg, o1.n_docs)
        srv.refresh_segments(sgm.load_segment_set(str(tmp_path)))
        s1, i1 = srv.query(["zzzfresh"])
        assert float(s1[0]) > 0.0
        assert int(i1[0]) == o1.n_docs  # the new segment's global base
        assert srv.stats()["refreshes"] == 1
        assert srv.index.n_docs == o1.n_docs + 1
    finally:
        srv.stop()


def test_set_prior_carries_over_refresh(tmp_path):
    """The last global prior is re-applied to a refreshed set; the docs of
    a segment committed after it get the neutral 1.0."""
    scfg = TfidfConfig(vocab_bits=10)
    o1, _ = _seal(tmp_path, _docs(), scfg, 0)
    n = o1.n_docs
    with make_server(sgm.load_segment_set(str(tmp_path)), top_k=n + 1, prior_alpha=1.0,
                     cache_size=0) as srv:
        ranks = np.linspace(3.0, 2.0, n).astype(np.float32)
        srv.set_prior(ranks)
        _seal(tmp_path, ["zzzfresh newdoc content"], scfg, n)
        srv.refresh_segments(sgm.load_segment_set(str(tmp_path)))
        s, i = srv.query([], ranker="prior")  # scores are the prior alone
    got = np.zeros(n + 1, np.float32)
    got[i] = s
    np.testing.assert_array_equal(got, np.concatenate([ranks, [1.0]]).astype(np.float32))


def test_merge_preserves_scores(tmp_path):
    """Merging segments under the same global stats changes no served bit;
    replaced segment dirs go one generation later, the merged one
    serves."""
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    third = max(len(docs) // 3, 1)
    o1, _ = _seal(tmp_path, docs[:third], scfg, 0)
    o2, _ = _seal(tmp_path, docs[third:2 * third], scfg, o1.n_docs)
    _seal(tmp_path, docs[2 * third:], scfg, o1.n_docs + o2.n_docs)
    segset = sgm.load_segment_set(str(tmp_path))
    assert len(segset.segments) == 3
    with make_server(segset, top_k=5, scoring="impacted") as srv:
        before = {tuple(q): srv.query(q) for q in QUERIES}
        merger = sgm.SegmentMerger(str(tmp_path), scfg, max_segments=1, device="cpu")
        assert tdevice.DEFAULT_DEVICE == "cuda"
        assert merger.merge_once()
        while merger.merge_once():
            pass
        m = sgm.latest_manifest(str(tmp_path))
        assert len(m.segments) == 1 and merger.merges == 2
        srv.refresh_segments(sgm.load_segment_set(str(tmp_path)))
        for q in QUERIES:
            s, i = srv.query(q)
            bs, bi = before[tuple(q)]
            assert s.tobytes() == bs.tobytes() and i.tobytes() == bi.tobytes(), q
    live = {s.name for s in m.segments}
    on_disk = {p.name for p in (tmp_path / "segments").iterdir() if p.is_dir()}
    assert live <= on_disk


def test_merger_thread_compacts_in_background(tmp_path):
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    o1, _ = _seal(tmp_path, docs[:4], scfg, 0)
    _seal(tmp_path, docs[4:], scfg, o1.n_docs)
    with sgm.SegmentMerger(str(tmp_path), scfg, max_segments=1, interval_s=0.05,
                           device="cpu") as merger:
        deadline = time.monotonic() + 30.0
        while merger.merges < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    assert merger.merges == 1
    assert len(sgm.latest_manifest(str(tmp_path)).segments) == 1


def test_merge_seals_bm25_on_the_segments_device(tmp_path):
    """Two ``device="cpu"`` segments merge on the CPU with the default
    device left at cuda, and the merged segment's BM25 table equals the
    JAX package's merge of the same two segments."""
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    o1, r1 = _seal(port_dir, docs[:5], scfg, 0)
    _, r2 = _seal(port_dir, docs[5:], scfg, o1.n_docs)
    shutil.copytree(port_dir, ref_dir)
    assert tdevice.DEFAULT_DEVICE == "cuda"
    got = sgm.load_segment(str(port_dir), sgm.merge_segments(str(port_dir), (r1, r2), scfg,
                                                              device="cpu"))
    jr1, jr2 = (jsgm.SegmentRef.from_json(r.to_json()) for r in (r1, r2))
    jcfg_ = jcfg.TfidfConfig(vocab_bits=10)
    want = jsgm.load_segment(str(ref_dir), jsgm.merge_segments(str(ref_dir), (jr1, jr2), jcfg_))
    np.testing.assert_array_equal(np.asarray(got.doc), np.asarray(want.doc))
    np.testing.assert_array_equal(np.asarray(got.term), np.asarray(want.term))
    assert got.bm25_weight is not None
    np.testing.assert_allclose(np.asarray(got.bm25_weight), np.asarray(want.bm25_weight),
                               rtol=0, atol=2e-6)


def test_merge_refuses_non_contiguous(tmp_path):
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    o1, r1 = _seal(tmp_path, docs[:4], scfg, 0)
    o2, r2 = _seal(tmp_path, docs[4:8], scfg, o1.n_docs)
    o3, r3 = _seal(tmp_path, docs[8:], scfg, o1.n_docs + o2.n_docs)
    with pytest.raises(ValueError, match="contiguous"):
        sgm.merge_segments(str(tmp_path), (r1, r3), scfg)


# ------------------------------------------------ the two packages' formats

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segment_dir_crosses_packages(tmp_path, writer):
    """A segmented directory sealed by either package loads in both, with
    equal manifests and re-weighted tables; and both packages' seals of
    the same documents load to equal tables."""
    docs = _docs()
    half = len(docs) // 2
    kw = dict(vocab_bits=10, idf_mode="smooth", l2_normalize=True)
    for who, d in (("port", tmp_path / "port"), ("jax", tmp_path / "jax")):
        base = 0
        for part in (docs[:half], docs[half:]):
            if who == "port":
                cfg = TfidfConfig(**kw)
                out = run_tfidf(part, cfg, device="cpu")
                ref = sgm.seal_segment(str(d), out, cfg, doc_base=base, bm25=Bm25Config())
            else:
                cfg = jcfg.TfidfConfig(**kw)
                out = jm.run_tfidf(part, cfg)
                ref = jsgm.seal_segment(str(d), out, cfg, doc_base=base,
                                        bm25=jcfg.Bm25Config())
            (sgm if who == "port" else jsgm).commit_append(str(d), ref, cfg.config_hash())
            base += out.n_docs
    src = tmp_path / writer
    mine, theirs = sgm.load_segment_set(str(src)), jsgm.load_segment_set(str(src))
    assert mine.manifest.segments == tuple(
        sgm.SegmentRef.from_json(s.to_json()) for s in theirs.manifest.segments)
    assert mine.df_global.tobytes() == theirs.df_global.tobytes()
    other = sgm.load_segment_set(str(tmp_path / ("jax" if writer == "port" else "port")))
    for a, b, c in zip(mine.segments, theirs.segments, other.segments):
        assert set(a.weights) == set(b.weights) == {"tfidf", "bm25"}
        for r in a.weights:
            assert a.weights[r].tobytes() == b.weights[r].tobytes(), r
            # the re-weighted tables come from counts, DF and lengths only:
            # the other package's seal of the same documents gives them too
            np.testing.assert_allclose(a.weights[r], c.weights[r], rtol=2e-6, atol=0)
        assert a.term_offsets.tobytes() == b.term_offsets.tobytes()


def test_cli_serves_segmented_dir(tmp_path, capsys):
    """cli.serve on a segmented directory serves the live set, the same
    lines as a server over the set."""
    scfg = TfidfConfig(vocab_bits=10)
    docs = _docs()
    o1, _ = _seal(tmp_path, docs[:6], scfg, 0)
    _seal(tmp_path, docs[6:], scfg, o1.n_docs)
    queries = tmp_path / "q.txt"
    queries.write_text("\n".join(" ".join(q) for q in QUERIES) + "\n")
    assert cli_serve.main([str(tmp_path), "--queries", str(queries), "--top-k", "3",
                           "--scoring", "impacted", "--device", "cpu"]) == 0
    rows = capsys.readouterr()[0].splitlines()
    want = []
    with make_server(sgm.load_segment_set(str(tmp_path)), top_k=3) as srv:
        for qid, q in enumerate(QUERIES):
            s, d = srv.query(q)
            want += [f"{qid}\t{int(i)}\t{float(v):.10g}" for v, i in zip(s, d) if v > 0]
    assert rows == want and any(int(r.split("\t")[1]) >= o1.n_docs for r in rows)
