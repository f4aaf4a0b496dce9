"""The chaos gate's scenarios (``..._torch/tools/chaos_scenarios.py``) on
the CPU, against the JAX package's ``tools/chaos.sh``.

Each scenario runs at the reference's sizes with ``device="cpu"`` and must
hold the reference's bars (the functions assert them).  Where the
reference's scenario leaves records, its body runs here too, through the
JAX package on 2 of the test session's CPU devices, and the port's records
must equal them: the trace report's ``mesh_shrinks`` as (site, devices
before, devices after), its ``exhausted`` and ``degraded`` counts by site.
A fleet scenario's audit holds the reference router's audit keys, with
``dropped``, ``double_served`` and ``roll_retries`` 0; the crash scenario
kills at as many write boundaries as the reference's harness counts.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import pathlib
import shutil

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow.ppr import run_ppr_batch as jppr
from page_rank_and_tfidf_using_apache_spark_tpu.io import synthetic_powerlaw as jpowerlaw
from page_rank_and_tfidf_using_apache_spark_tpu.models.pagerank import run_pagerank as jrun
from page_rank_and_tfidf_using_apache_spark_tpu.models.tfidf import (
    run_tfidf_streaming as jstream,
)
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import (
    run_pagerank_sharded as jpr_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import run_tfidf_sharded as jtf_sharded
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import elastic as jelastic
from page_rank_and_tfidf_using_apache_spark_tpu.serving import fabric as jfabric
from page_rank_and_tfidf_using_apache_spark_tpu.utils.config import PageRankConfig as JPrCfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.config import TfidfConfig as JTfCfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS, NODES_AXIS
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import chaos_scenarios as cs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import ci_smokes

REPO = pathlib.Path(__file__).resolve().parents[1]
KW = dict(dangling="redistribute", init="uniform", dtype="float32")


@pytest.fixture(autouse=True)
def clean_health():
    elastic.reset_health()
    jelastic.reset_health()
    yield
    elastic.reset_health()
    jelastic.reset_health()


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_traced(name: str, tmp_path, body) -> dict:
    """The reference's body inside its own traced run, read back by the
    repository's ``tools/trace_report.py``."""
    d = tmp_path / "ref"
    jobs.start_run(name, str(d))
    try:
        body()
    finally:
        jobs.end_run()
    rep = cs.trace_report().report(glob.glob(str(d / f"{name}.*.trace.jsonl"))[0])
    return {"mesh_shrinks": cs.shrink_pairs(rep), "exhausted": dict(rep["exhausted"]),
            "degraded": dict(rep["degraded"])}


def _records(rep: dict) -> dict:
    return {k: rep[k] for k in ("mesh_shrinks", "exhausted", "degraded")}


# ------------------------------------------------------- the mesh scenarios

def test_device_lost_records_are_the_references(tmp_path):
    """``tools/chaos.sh:36-106``: three shrinks 2 -> 1 at the reference's
    sites (the PageRank step, the sharded ingest's wait, the owned step),
    no exhausted site, each runner within 1e-6 of its unbroken run."""
    got = cs.device_lost("cpu")
    g = jpowerlaw(800, 3200, seed=5)
    cfg = JPrCfg(iterations=10, **KW)
    chunks = cs.corpus_chunks()
    base_pr = jrun(g, cfg)
    base_tf = jtf_sharded(iter(chunks), JTfCfg(vocab_bits=10), n_devices=2)

    def body():
        with jchaos.inject("*:device_lost@dev:1"):
            res = jpr_sharded(g, cfg, n_devices=2)
            np.testing.assert_allclose(res.ranks, base_pr.ranks, atol=1e-6)
            jelastic.reset_health()
            tf = jtf_sharded(iter(chunks), JTfCfg(vocab_bits=10), n_devices=2)
            np.testing.assert_allclose(tf.to_dense(), base_tf.to_dense(), atol=1e-6)
            jelastic.reset_health()
            res_o = jpr_sharded(g, cfg, n_devices=2, strategy="owned")
            np.testing.assert_allclose(res_o.ranks, base_pr.ranks, atol=1e-6)

    want = _ref_traced("chaos_device_lost", tmp_path, body)
    assert _records(got) == want
    assert [s[1:] for s in got["mesh_shrinks"]] == [(2, 1)] * 3
    assert max(got["max_abs_err"].values()) <= 1e-6


def test_fixpoint_records_are_the_references(tmp_path):
    """``tools/chaos.sh:117-176``: one shrink 2 -> 1 of the tolerance
    fixpoint; batched PPR's delta fetch exhausts by design and the step's
    salvage rung degrades once."""
    got = cs.fixpoint("cpu")
    g = jpowerlaw(800, 3200, seed=9)
    cfg = JPrCfg(iterations=200, tol=1e-8, **KW)
    base = jpr_sharded(g, cfg, n_devices=2)
    queries = [[int(g.node_ids[0])], [int(g.node_ids[10])]]
    base_ppr = jppr(g, JPrCfg(iterations=30, **KW), queries)

    def body():
        with jchaos.inject("*:device_lost@dev:1"):
            res = jpr_sharded(g, cfg, n_devices=2)
        np.testing.assert_allclose(res.ranks, base.ranks, atol=1e-6)
        jelastic.reset_health()
        with jchaos.inject("ppr_delta_sync:device_lost@dev:0"):
            ppr = jppr(g, JPrCfg(iterations=30, **KW), queries)
        np.testing.assert_allclose(ppr.ranks, base_ppr.ranks, atol=1e-6)

    want = _ref_traced("chaos_dataflow_fixpoint", tmp_path, body)
    assert _records(got) == want
    assert got["mesh_shrinks"] == [("pagerank_step", 2, 1)]
    assert got["degraded"]["ppr_step"] == 1


def test_ingest_h2d_records_are_the_references(tmp_path):
    """``tools/chaos.sh:187-249``: the single-device stream degrades at the
    put and replays on the CPU bit for bit; the sharded one shrinks 2 -> 1
    at ``ingest_h2d_put``; both runs trace their ingest accounting."""
    got = cs.ingest_h2d("cpu")
    chunks = cs.corpus_chunks()
    cfg = JTfCfg(vocab_bits=10, prefetch=2, pipeline_depth=2)
    base_stream = jstream(iter(chunks), cfg)
    base_shard = jtf_sharded(iter(chunks), JTfCfg(vocab_bits=10), n_devices=2)

    def body():
        with jchaos.inject("ingest_h2d_put:device_lost@dev:0"):
            res = jstream(iter(chunks), cfg)
        assert res.to_dense().tobytes() == base_stream.to_dense().tobytes()
        jelastic.reset_health()
        with jchaos.inject("ingest_h2d_put:device_lost@dev:1"):
            tf = jtf_sharded(iter(chunks), JTfCfg(vocab_bits=10), n_devices=2)
        np.testing.assert_allclose(tf.to_dense(), base_shard.to_dense(), atol=1e-6)

    want = _ref_traced("chaos_ingest_h2d", tmp_path, body)
    assert _records(got) == want
    assert got["mesh_shrinks"] == [("ingest_h2d_put", 2, 1)] and got["ingest_runs"] == 2


@pytest.mark.parametrize("axis", [NODES_AXIS, DATA_AXIS])
def test_slot_mesh_on_the_cpu_is_mesh_for(axis):
    """On the CPU the scenarios' mesh is ``mesh_for(2, axis, "cpu")``: slot
    ids 0 and 1, so ``device_lost@dev:1`` names slot 1."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import mesh_for

    m = cs.slot_mesh(2, axis, "cpu")
    want = mesh_for(2, axis, device="cpu")
    assert m == want and [s.id for s in m.slots] == [0, 1] and m.axis == axis


# ---------------------------------------------------- serving and the fleet

def _ref_audit_keys(tmp_path) -> set:
    """The reference router's audit keys (an unstarted router's)."""
    return set(jfabric.ServingFabric(str(tmp_path), jfabric.FabricConfig(federation=False))
               .audit())


def test_segment_swap_serves_each_request_once():
    """``tools/chaos.sh:259-351``: every audited request served exactly
    once across 4 hot swaps and the merge; the merge's injected fault was
    retried; one segment left."""
    got = cs.segment_swap("cpu")
    assert got["requests"] > 0
    assert got["audit"] == {"dropped": 0, "double_served": 0}
    assert got["merge_calls"] >= 2 and got["segments"] == 1


def test_crash_append_kills_every_reference_boundary(tmp_path, monkeypatch, capsys):
    """``tools/chaos.sh:362-387``: a SIGKILL at each of the write
    boundaries the reference's harness counts for ``append``; every reload
    serves the pre-kill or the committed generation."""
    got = cs.crash_append("cpu")
    ref = _tool("crash_harness")
    for mod, name in ((os, "replace"), (os, "unlink"), (shutil, "rmtree")):
        monkeypatch.setattr(mod, name, getattr(mod, name))  # restored after
    assert ref.worker_setup(str(tmp_path), "append") == 0
    capsys.readouterr()
    originals = (os.replace, os.unlink, shutil.rmtree)
    try:
        assert ref.worker_op(str(tmp_path), "append", -1) == 0
    finally:
        os.replace, os.unlink, shutil.rmtree = originals
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["boundaries"]
    assert got["boundaries"] == want and got["kills"] == want
    assert got["served_pre"] >= 1 and got["served_pre"] + got["served_post"] == want


def test_crash_harness_smoke():
    """``tools/ci.sh:167-173``, the CI smoke beside the scenario: 3 kills
    spread over ``append``'s boundaries."""
    got = ci_smokes.crash("cpu")
    assert got["kills"] == 3 and got["boundaries"] >= 4


def _check_fleet_audit(got: dict, tmp_path) -> None:
    assert set(got["audit"]) <= _ref_audit_keys(tmp_path)
    assert got["audit"]["dropped"] == got["audit"]["double_served"] == 0
    assert got["audit"]["roll_retries"] == 0


def test_malformed_messages_at_a_faulted_fleet(tmp_path):
    """``tools/chaos.sh:398-492``: the protocol harness conforms, at least 4
    malformed bodies answered a typed 400 at live replicas under the
    partition and the replica's self-kill, the swap seam kills with
    SIGKILL, and the audit is clean."""
    got = cs.malformed("cpu")
    assert got["harness_probes"] > 0 and got["typed_rejections"] >= 4
    assert got["kill_seam_rc"] == -9
    _check_fleet_audit(got, tmp_path)


def test_fed_scrape_partition_and_hang(tmp_path):
    """``tools/chaos.sh:502-596``: 26 of 26 delivered, both replicas
    labelled stale under the partition, never dropped."""
    got = cs.fed_scrape("cpu")
    assert got["audit"]["requests"] == got["audit"]["delivered"] == 26
    assert sorted(got["stale"]) == ["0", "1"] and got["scrape_errors"] >= 2
    _check_fleet_audit(got, tmp_path)


def test_cache_peer_partition_and_hang(tmp_path):
    """``tools/chaos.sh:609-729``: the non-owner's blocking stays within
    the peek deadline's bounds, its breaker trips and recloses with a real
    peer hit, nothing fails."""
    got = cs.cache_peer("cpu")
    secs = got["blocking_s"]
    assert secs["partitioned_peek"] < 2.0 and secs["open_breaker"] < 1.0
    assert secs["hung_probe"] < 1.5
    assert got["peek_timeouts"] >= 2 and got["peer_hits"] >= 1
    assert got["audit"]["failed"] == 0
    _check_fleet_audit(got, tmp_path)


# --------------------------------------------------------------- the CLI

def test_cli_runs_named_scenarios_and_refuses_unknown_ones(capsys):
    assert cs.main(["--device", "cpu", "ingest_h2d"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("OK ingest_h2d (")
    with pytest.raises(SystemExit):
        cs.main(["no_such_scenario"])
    assert "unknown scenarios ['no_such_scenario']" in capsys.readouterr().err
    assert list(cs.SCENARIOS) == ["device_lost", "fixpoint", "ingest_h2d", "segment_swap",
                                  "crash_append", "malformed", "fed_scrape", "cache_peer"]
