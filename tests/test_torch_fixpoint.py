"""The port's segment driver, PageRank checkpoints and resume, on the CPU.

``dataflow/fixpoint.run_segments`` runs PageRank (and the fixpoint
workloads, ``tests/test_torch_workloads.py``) in checkpointed segments.
Pins: a run killed after a checkpoint and resumed gives an unbroken run's
bits, for every SpMV impl in float32 and float64; a segment boundary does
not change the math; the config-hash and "different graph" guards; a
checkpoint written by either package resumes in the other, within 1e-12
of the reader's unbroken run; the metrics records and spans are the JAX
package's; the degradation rungs, not ported, raise naming their ROADMAP
item; and the CLI's checkpoint flags print what the JAX CLI prints.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.cli import pagerank as jcli
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.models.pagerank import run_pagerank as jrun
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.metrics import MetricsRecorder as JMetrics
from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted, obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as tfix
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import driver
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank as trun
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos as tchaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

TINY = str(pathlib.Path(__file__).resolve().parent / "fixtures" / "tiny.txt")
BASE = dict(iterations=12, dangling="redistribute", init="uniform", head_row_width=8)
TOL = 1e-12  # float64, of the total rank mass (1 under init=uniform)


def graph(n: int = 120, e: int = 600, seed: int = 11):
    return tg.synthetic_powerlaw(n, e, seed=seed)


def killed_and_resumed(g, cfg, ck: str, at: int, **run_kw):
    """Run ``cfg`` with checkpoints every 4 iterations but only to ``at``
    (the killed run), then resume it to the end."""
    kw = dict(checkpoint_every=4, checkpoint_dir=ck)
    trun(g, dataclasses.replace(cfg, iterations=at, **kw), device="cpu")
    assert ckpt.latest_checkpoint(ck) is not None
    return trun(g, dataclasses.replace(cfg, **kw), resume=True, device="cpu", **run_kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("impl", tcfg.SPMV_IMPLS)
def test_kill_and_resume_gives_equal_bits(impl, dtype, tmp_path):
    g = graph()
    cfg = tcfg.PageRankConfig(**BASE, spmv_impl=impl, dtype=dtype)
    full = trun(g, cfg, device="cpu")
    m = MetricsRecorder()
    res = killed_and_resumed(g, cfg, str(tmp_path / "ck"), 10, metrics=m)
    assert res.ranks.dtype == full.ranks.dtype == np.dtype(dtype)
    assert res.ranks.tobytes() == full.ranks.tobytes()
    assert res.iterations == 12 and res.l1_delta == full.l1_delta
    resumed = [r for r in m.records if r.get("event") == "resume"]
    assert [r["start_iter"] for r in resumed] == [8]


def test_segment_boundary_does_not_change_bits(tmp_path):
    """20 iterations as 4 segments of 5 give the unbroken run's bits; only
    the delta is per segment, and the last one is the unbroken run's."""
    g = graph()
    cfg = tcfg.PageRankConfig(**{**BASE, "iterations": 20}, dtype="float32")
    full = trun(g, cfg, device="cpu")
    m = MetricsRecorder()
    split = trun(g, dataclasses.replace(cfg, checkpoint_every=5,
                                        checkpoint_dir=str(tmp_path)), metrics=m, device="cpu")
    assert split.ranks.tobytes() == full.ranks.tobytes()
    assert split.l1_delta == full.l1_delta
    assert [r["iter"] for r in m.records if "l1_delta" in r] == [5, 10, 15, 20]
    assert [r["iter"] for r in m.records if r.get("event") == "checkpoint"] == [5, 10, 15]
    assert m.scalars == {"iterations": 20, "l1_delta": full.l1_delta}


def test_runner_cache_builds_each_segment_length_once():
    calls = []

    def make_runner(seg_cfg):
        calls.append(seg_cfg.iterations)
        assert seg_cfg.checkpoint_every == 0 and seg_cfg.checkpoint_dir is None
        return lambda r: (r + seg_cfg.iterations, seg_cfg.iterations, 0.5)

    cfg = tcfg.PageRankConfig(iterations=11, checkpoint_every=4)  # no dir: no files
    out, done, delta = tfix.run_segments(
        cfg, MetricsRecorder(), 0, 0, make_runner=make_runner,
        invoke=lambda runner, r: runner(r), extract_np=np.asarray)
    assert (out, done, delta) == (11, 11, 0.5)
    assert calls == [4, 3]


@pytest.mark.parametrize("tol, segments", [(0.0, 3), (1e-6, 1)])
def test_only_a_fixed_count_run_is_split(tol, segments):
    """checkpoint_every applies only where tol == 0: a tolerance run is
    one segment.  spark_exact is never split."""
    g = graph()
    m = MetricsRecorder()
    trun(g, tcfg.PageRankConfig(**BASE, tol=tol, dtype="float64", checkpoint_every=4),
         metrics=m, device="cpu")
    assert sum("l1_delta" in r for r in m.records) == segments
    m2 = MetricsRecorder()
    trun(g, tcfg.PageRankConfig(iterations=12, spark_exact=True, checkpoint_every=4),
         metrics=m2, device="cpu")
    assert sum("l1_delta" in r for r in m2.records) == 1


@pytest.mark.parametrize("fault", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    tchaos.DeviceLostError("injected whole-backend loss"),
], ids=["kernel", "lost"])
def test_degradation_rungs_are_refused(fault):
    """The salvage rung refuses an error that is not a lost device naming
    its index (a kernel's sticky CUDA error, a whole-backend loss): nothing
    runs on the CPU, no ``degraded`` event, and the segment exhausts with
    the error."""
    cfg = tcfg.PageRankConfig(iterations=2)
    m = MetricsRecorder()
    ran = []

    def invoke(runner, x):
        raise fault

    rebuild = tfix.make_cpu_salvage(
        cfg, m, site_prefix="pagerank", init_state=lambda: np.zeros(3),
        cpu_exec=lambda *a: ran.append(a), make_runner=lambda c: None,
        extract_np=np.asarray)
    with pytest.raises(ResilienceExhausted) as ei:
        tfix.run_segments(cfg, m, 0, 0, make_runner=lambda c: None, invoke=invoke,
                          extract_np=np.asarray, elastic_rebuild=rebuild)
    assert ei.value.last_error is fault and ei.value.site == "pagerank_step"
    assert ran == [] and not any(r.get("event") == "degraded" for r in m.records)


def test_checkpoint_config_hash_guard(tmp_path):
    g = graph(50, 150, seed=2)
    ck = str(tmp_path / "ck")
    kw = dict(iterations=8, checkpoint_every=2, checkpoint_dir=ck,
              dangling="redistribute", init="uniform")
    trun(g, tcfg.PageRankConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        trun(g, tcfg.PageRankConfig(**kw, damping=0.5), resume=True, device="cpu")


def test_resume_rejects_different_graph(tmp_path):
    kw = dict(iterations=6, checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"),
              dangling="redistribute", init="uniform")
    trun(graph(40, 120, seed=3), tcfg.PageRankConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="different graph"):
        trun(graph(80, 240, seed=3), tcfg.PageRankConfig(**kw), resume=True, device="cpu")


def test_resume_needs_a_directory_and_starts_fresh_without_a_checkpoint(tmp_path):
    g = graph()
    cfg = tcfg.PageRankConfig(**BASE, dtype="float64")
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        trun(g, cfg, resume=True, device="cpu")
    res = trun(g, dataclasses.replace(cfg, checkpoint_dir=str(tmp_path)), resume=True,
               device="cpu")
    assert res.ranks.tobytes() == trun(g, cfg, device="cpu").ranks.tobytes()
    ranks = np.zeros(g.n_nodes, np.float64)
    assert driver.resume_from_checkpoint(
        dataclasses.replace(cfg, checkpoint_dir=str(tmp_path)), MetricsRecorder(), ranks,
        n=g.n_nodes) == 0
    assert not ranks.any()


@pytest.mark.parametrize("impl", ["segment", "pallas", "hybrid"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(writer, impl, tmp_path):
    """A PageRank checkpoint written by either package resumes in the
    other (same config hash, ``.npz`` layout and ``LATEST`` pointer),
    within 1e-12 of the reader's unbroken run."""
    kw = dict(**BASE, spmv_impl=impl, dtype="float64")
    ck = dict(checkpoint_every=4, checkpoint_dir=str(tmp_path / "ck"))
    args = (120, 600)
    jgr, tgr = jg.synthetic_powerlaw(*args, seed=11), tg.synthetic_powerlaw(*args, seed=11)
    assert tcfg.PageRankConfig(**kw).config_hash() == jcfg.PageRankConfig(**kw).config_hash()
    killed = {**kw, "iterations": 10}
    if writer == "jax":
        jrun(jgr, jcfg.PageRankConfig(**killed, **ck))
        res = trun(tgr, tcfg.PageRankConfig(**kw, **ck), resume=True, device="cpu")
        full = trun(tgr, tcfg.PageRankConfig(**kw), device="cpu")
    else:
        trun(tgr, tcfg.PageRankConfig(**killed, **ck), device="cpu")
        res = jrun(jgr, jcfg.PageRankConfig(**kw, **ck), resume=True)
        full = jrun(jgr, jcfg.PageRankConfig(**kw))
    resumed = [r for r in res.metrics.records if r.get("event") == "resume"]
    assert [r["start_iter"] for r in resumed] == [8]
    assert np.abs(np.asarray(res.ranks) - np.asarray(full.ranks)).max() <= TOL
    assert res.iterations == full.iterations == 12


@pytest.mark.parametrize("name, kw", [
    ("PageRankConfig", dict(iterations=7, damping=0.8, spmv_impl="hybrid", dtype="float64",
                            checkpoint_every=3, checkpoint_dir="/x")),
    ("HitsConfig", dict(iterations=50, tol=0.0, dtype="float64", checkpoint_every=5)),
    ("ComponentsConfig", dict(iterations=30, checkpoint_dir="/y")),
])
def test_config_hashes_match_jax(name, kw):
    """A checkpoint carries its writer's config hash: equal configs hash
    equal in both packages, so either resumes the other's; fields and
    defaults agree, and the operational fields are left out."""
    t, j = getattr(tcfg, name)(**kw), getattr(jcfg, name)(**kw)
    assert t.config_hash() == j.config_hash()
    assert tcfg.config_to_json(t) == jcfg.config_to_json(j)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert t.config_hash() == dataclasses.replace(t, iterations=1, checkpoint_every=0,
                                                  checkpoint_dir=None).config_hash()
    for bad in [dict(iterations=-1)] + ([dict(tol=-1.0)] if name == "HitsConfig" else []):
        with pytest.raises(ValueError):
            getattr(tcfg, name)(**bad)
        with pytest.raises(ValueError):
            getattr(jcfg, name)(**bad)


def test_records_and_spans_match_reference_names(tmp_path):
    """The records and spans the JAX package's tools read, for a
    checkpointed run: put_graph, one record a segment, the checkpoint
    events; pagerank.segment, .checkpoint and .ckpt_pull, .result_pull."""
    g = graph()
    kw = dict(**BASE, dtype="float64", checkpoint_every=4)
    sink, jsink = obs.MemorySink(), jobs.MemorySink()
    obs.bus().attach(sink)
    jobs.bus().attach(jsink)
    try:
        m, jm = MetricsRecorder(), JMetrics()
        # unfaulted runs in both packages: each package counts an env plan's
        # calls on its own, so a GRAFT_CHAOS plan would fault different calls
        with tchaos.inject(""), jchaos.inject(""):
            trun(g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "t")), metrics=m,
                 device="cpu")
            jrun(jg.synthetic_powerlaw(120, 600, seed=11),
                 jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")), metrics=jm)
    finally:
        obs.bus().detach(sink)
        jobs.bus().detach(jsink)
    assert [sorted(r) for r in m.records] == [sorted(r) for r in jm.records]
    assert [r.get("event") for r in m.records] == [
        "put_graph", None, "checkpoint", None, "checkpoint", None]
    spans = {e["name"] for e in sink.of_kind("span_end")}
    jspans = {e["name"] for e in jsink.of_kind("span_end")}
    want = {"pagerank.segment", "pagerank.checkpoint", "pagerank.ckpt_pull",
            "pagerank.result_pull"}
    assert want <= spans and spans <= jspans
    assert len([e for e in sink.of_kind("span_end") if e["name"] == "pagerank.segment"]) == 3


def _cli_lines(run, argv, out):
    assert run(argv + ["--output", str(out)]) == 0
    return out.read_text().splitlines()


def test_cli_checkpoint_flags_match_jax_cli(tmp_path):
    """Killed at 10 with checkpoints every 5, resumed to 20: the port's CLI
    and the JAX CLI write the same lines, and the same as an unbroken run."""
    common = [TINY, "--dtype", "float64", "--dangling", "redistribute"]
    lines = {}
    for name, run, extra in (("port", tcli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, ["--tuned-profile", "off"])):
        ck = ["--checkpoint-dir", str(tmp_path / name), "--checkpoint-every", "5"]
        _cli_lines(run, [common[0], "10", *common[1:], *ck, *extra], tmp_path / "k.txt")
        lines[name] = _cli_lines(run, [common[0], "20", *common[1:], *ck, "--resume", *extra],
                                 tmp_path / f"{name}.txt")
    full = _cli_lines(tcli.main, [common[0], "20", *common[1:], "--device", "cpu"],
                      tmp_path / "full.txt")
    assert lines["port"] == lines["jax"] == full and len(full) > 0
    assert ckpt.latest_checkpoint(str(tmp_path / "port")).endswith("00000015.npz")


@pytest.mark.parametrize("flags, item", [
    (["--mesh", "2"], 11),
    (["--shard-strategy", "nodes"], 11),
])
def test_later_flags_exit_naming_their_item(flags, item, capsys, tmp_path):
    """The flags of ROADMAP Queue 1 item 11 are ported: no flag is left to
    refuse, and each runs as the JAX CLI's does (``--shard-strategy``
    alone is read only under ``--mesh``), its ranks equal to the same
    command's without it on one slot."""
    assert item == 11 and tcli.build_parser().parse_args([TINY, *flags])
    common = [TINY, "5", "--device", "cpu", "--dtype", "float64"]
    assert tcli.main([*common, *flags, "--output", str(tmp_path / "a.txt")]) == 0
    assert tcli.main([*common, "--output", str(tmp_path / "b.txt")]) == 0
    a = [ln.split("\t") for ln in (tmp_path / "a.txt").read_text().splitlines()]
    b = [ln.split("\t") for ln in (tmp_path / "b.txt").read_text().splitlines()]
    assert [r[0] for r in a] == [r[0] for r in b] and a
    assert max(abs(float(x[1]) - float(y[1])) for x, y in zip(a, b)) <= 1e-12
    assert "ROADMAP" not in capsys.readouterr().err
