"""The port's soaks (``serving/soak.py``) against the JAX package's, on the
CPU.

One 6 s soak with one injected device loss runs through each package
(``tests/test_soak.py``'s settings): the port's record has the reference's
keys, level by level, drops nothing, serves nothing twice and recovers
once, and its loss-to-recovery events come in the reference's order — the
port's executor never salvages a whole-backend loss, so the soak's own
recovery (above the executor) carries it, as in the reference.  The
soak's prior refresh (PageRank under ``spmv_impl="segment"``) equals the
reference's, the configs read the reference's env knobs, and the record
lands in a trace the root ``tools/trace_report.py`` renders.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.serving import soak as jsoak
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import soak
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import device as tdevice

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = dict(duration_s=6.0, qps=20.0, clients=2, rebuild_every_s=2.5,
                chunk_interval_s=0.3, prior_refresh_every_s=2.0, losses=1,
                loss_at_s=2.0, grace_s=20.0)
# the loss-to-recovery events (the rest interleave with ingest timing)
RECOVERY_KINDS = ("soak_loss_injected", "exhausted", "degraded", "soak_swap",
                  "soak_recovered")


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_soak_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recovery_events(events) -> list[tuple]:
    """The loss-to-recovery records, consecutive repeats collapsed (each
    failed batch publishes its own ``exhausted``)."""
    out: list[tuple] = []
    on = False
    for e in events:
        kind = e["kind"]
        if kind == "soak_loss_injected":
            on = True
        if on and kind in RECOVERY_KINDS:
            rec = (kind, e.get("site"), e.get("reason"))
            if not out or out[-1] != rec:
                out.append(rec)
        if kind == "soak_recovered":
            on = False
    return out


@pytest.fixture(scope="module")
def loss_soaks(tmp_path_factory):
    """ONE traced soak with one device loss through each package."""
    out = {}
    trace_dir = tmp_path_factory.mktemp("torch_soak_trace")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAFT_CHAOS", "")
        sink = obs.MemorySink()
        obs.bus().attach(sink)
        try:
            with obs.run("torchsoak", trace_dir=str(trace_dir)) as r:
                rec = soak.run_soak(soak.SoakConfig(**SETTINGS, device="cpu"))
        finally:
            obs.bus().detach(sink)
        out["port"] = (rec, list(sink.events), r.trace_path)
        jsink = jobs.MemorySink()
        jobs.bus().attach(jsink)
        try:
            jrec = jsoak.run_soak(jsoak.SoakConfig(**SETTINGS))
        finally:
            jobs.bus().detach(jsink)
        out["jax"] = (jrec, list(jsink.events), None)
    return out


def _key_tree(rec) -> dict:
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in rec.items()}


def _common_tree(a: dict, b: dict) -> tuple[dict, dict]:
    """Both key trees, descending only where both sides hold a dict (a
    value that is a dict in one run and None in the other — the mid-run
    snapshot, a latency window with no samples — is run-dependent)."""
    ta, tb = {}, {}
    for k in set(a) | set(b):
        va, vb = a.get(k, "missing"), b.get(k, "missing")
        if isinstance(va, dict) and isinstance(vb, dict):
            ta[k], tb[k] = _common_tree(va, vb)
        else:
            ta[k] = None if k in a else "missing"
            tb[k] = None if k in b else "missing"
    return ta, tb


def test_soak_record_has_the_references_keys(loss_soaks):
    rec, jrec = loss_soaks["port"][0], loss_soaks["jax"][0]
    mine, ref = _common_tree(_key_tree(rec), _key_tree(jrec))
    assert mine == ref
    assert set(rec["error_budget"]) == set(jrec["error_budget"])
    assert rec["backend"] == "cpu" and jrec["backend"] == "cpu"
    json.dumps(rec)  # one JSON line's worth of plain data


def test_soak_with_one_loss_drops_nothing_and_recovers_once(loss_soaks):
    rec = loss_soaks["port"][0]
    assert rec["requests"] > 40
    assert rec["dropped"] == 0 and rec["double_served"] == 0
    recov = rec["recovery"]
    assert recov["losses_injected"] == 1 and len(recov["recoveries"]) == 1
    assert recov["recoveries"][0]["reason"] == "device_loss"
    assert 0.0 < recov["time_to_recover_s"] < 20.0
    assert rec["chaos_losses"] >= 1
    assert rec["ingest"]["rebuilds"] >= 1 and rec["ingest"]["index_version"] >= 2
    assert rec["ingest"]["prior_refreshes"] >= 1
    mixed = rec["mixed_traffic"]
    assert sum(mixed.values()) == rec["requests"] and min(mixed.values()) > 0
    assert rec["served_p50_ms"] is not None
    assert rec["served_p99_ms"] >= rec["served_p50_ms"]
    assert rec["error_budget"]["availability"]["target"] == 0.999


def test_soak_loss_and_recovery_events_in_the_references_order(loss_soaks):
    """``soak_loss_injected`` → the exhausted ``serve_dispatch`` batch →
    the recovery swap → ``soak_recovered``, with no ``degraded`` (no
    in-process rung salvages a whole-backend loss), as the reference
    publishes them."""
    mine = _recovery_events(loss_soaks["port"][1])
    ref = _recovery_events(loss_soaks["jax"][1])
    assert mine == ref
    assert mine == [("soak_loss_injected", None, None),
                    ("exhausted", "serve_dispatch", None),
                    ("soak_swap", None, "recover:device_loss"),
                    ("soak_recovered", None, "device_loss")]


def test_soak_record_lands_in_trace(loss_soaks):
    rec, _, trace_path = loss_soaks["port"]
    tr = _tool("trace_report")
    rep = tr.report(trace_path)
    assert rep["slo"]["served_p99_ms"] == rec["served_p99_ms"]
    assert rep["slo"]["dropped"] == 0
    human = tr.render_human(rep)
    assert "slo:" in human and "time-to-recover" in human


def test_cpu_soak_merges_on_its_device():
    """A ``device="cpu"`` soak whose live set may hold one segment merges
    on the CPU, with the default device left at cuda: merges land and no
    ``segment_merge_failed`` is published."""
    assert tdevice.DEFAULT_DEVICE == "cuda"
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRAFT_CHAOS", "")
            rec = soak.run_soak(soak.SoakConfig(
                duration_s=4.0, qps=10.0, clients=1, rebuild_every_s=1.0,
                chunk_interval_s=0.2, prior_refresh_every_s=60.0, losses=0,
                max_live_segments=1, merge_interval_s=0.25, device="cpu"))
    finally:
        obs.bus().detach(sink)
    assert rec["ingest"]["merges"] >= 1
    assert not [e for e in sink.events if e["kind"] == "segment_merge_failed"]
    assert rec["dropped"] == 0 and rec["double_served"] == 0


@pytest.mark.parametrize("n_docs, seed", [(240, 7), (1000, 1007), (37, 3)])
def test_prior_refresh_equals_the_references(n_docs, seed):
    """The soak's prior (PageRank ``segment`` over a synthetic citation
    graph, mean 1) on the CPU equals the reference's within float32's
    sum-order slack."""
    mine = soak._prior_ranks(n_docs, seed, 5, "cpu")
    ref = np.asarray(jsoak._prior_ranks(n_docs, seed, 5))
    assert mine.dtype == np.float32 and mine.shape == ref.shape == (n_docs,)
    assert abs(float(mine.mean()) - 1.0) < 1e-5
    assert np.allclose(mine, ref, rtol=1e-5, atol=1e-6)


def test_configs_match_the_reference_and_read_the_env(monkeypatch):
    for cls in ("SoakConfig", "FleetSoakConfig"):
        port = {f.name: f.default for f in dataclasses.fields(getattr(soak, cls))}
        ref = {f.name: f.default for f in dataclasses.fields(getattr(jsoak, cls))}
        assert port == {**ref, "device": "cuda"}, cls
    monkeypatch.setenv("GRAFT_SOAK_DURATION_S", "12")
    monkeypatch.setenv("GRAFT_SOAK_QPS", "7")
    monkeypatch.setenv("GRAFT_SOAK_SLO_P99_MS", "250")
    monkeypatch.setenv("GRAFT_SOAK_SLO_AVAILABILITY", "0.99")
    monkeypatch.setenv("GRAFT_FABRIC_REPLICAS", "3")
    monkeypatch.setenv("GRAFT_AUTOSCALE_COOLDOWN_S", "2.5")
    for cls in ("SoakConfig", "FleetSoakConfig"):
        mine = dataclasses.asdict(getattr(soak, cls).from_env(clients=4))
        ref = dataclasses.asdict(getattr(jsoak, cls).from_env(clients=4))
        assert mine == {**ref, "device": "cuda"}, cls
    with pytest.raises(ValueError):
        soak.SoakConfig(duration_s=0)
    with pytest.raises(ValueError):
        soak.FleetSoakConfig(autoscale=True, replicas=1)


def test_serving_latest_version_reads_both_layouts(tmp_path):
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import artifact
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig

    cfg = TfidfConfig(vocab_bits=8)
    out = run_tfidf(["a b c", "b c d"], cfg, device="cpu")
    assert soak.serving_latest_version(str(tmp_path)) is None
    plain, segs = tmp_path / "plain", tmp_path / "segs"
    artifact.save_index(str(plain), out, cfg)
    artifact.save_index(str(plain), out, cfg)
    sgm.commit_append(str(segs), sgm.seal_segment(str(segs), out, cfg, doc_base=0,
                                                  bm25=None), cfg.config_hash())
    for d in (plain, segs):
        assert (soak.serving_latest_version(str(d))
                == jsoak.serving_latest_version(str(d)))
    assert soak.serving_latest_version(str(plain)) == 2
    assert soak.serving_latest_version(str(segs)) == 1
