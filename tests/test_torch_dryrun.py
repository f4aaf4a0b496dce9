"""The port's multi-device dry run and owned-scale sweep
(``..._torch/tools/dryrun.py``) against the reference's
(``__graft_entry__.dryrun_multichip`` and ``_owned_scale_sweep``).

The reference runs on the 8 simulated CPU devices of ``tests/conftest.py``
(its own ``dryrun_multichip`` is not called: its ``clear_backends()`` would
reset jax for the whole session, so the test calls the strategy loop's
body and ``_owned_scale_sweep`` directly); the port runs on D CPU slots.
The sweep runs at a small base (``BENCH_OWNED_BASE_NODES``) over 1x and
4x, under a budget the 4x point's replicated state exceeds, at D = 4 and 8:
comm bytes a step equal at every point, rank sums within 1e-6, the sharded
TF-IDF's document and nonzero counts equal.
"""

from __future__ import annotations

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import make_mesh as jmake_mesh
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import (
    run_pagerank_sharded as jrun_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import (
    run_tfidf_sharded as jrun_tfidf_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import dryrun

DS = (4, 8)
KNOBS = {"BENCH_OWNED_BASE_NODES": "2000", "BENCH_OWNED_SCALES": "1,4",
         "BENCH_OWNED_HBM_BYTES": str(256 << 10)}
SWEEP_LINE = re.compile(r"owned-scale (\S+)x on (\d+) devices: n=(\d+) e=(\d+) "
                        r"comm_bytes_per_step=(\d+) \(sum=(\S+)\)")
VERDICT_LINE = re.compile(r"owned-scale sweep: comm-bytes exponent (\S+) .* "
                          r"auto_select -> (\w+)")


def reference(d: int) -> dict:
    """The reference's dry run at ``d`` devices, piece by piece: the
    strategy loop's body, the sharded TF-IDF, ``_owned_scale_sweep`` (its
    printed lines) and, for exact rank sums, its loop body at each scale."""
    mesh = jmake_mesh(d)
    graph = graft._tiny_graph()
    cfg = jcfg.PageRankConfig(iterations=2, dangling="redistribute", init="uniform",
                              personalize=(1, 5))
    sums = {s: float(np.asarray(jrun_sharded(graph, cfg, mesh=mesh, strategy=s).ranks).sum())
            for s in dryrun.STRATEGIES}
    docs = [f"alpha beta w{i} w{i % 3}" for i in range(4 * d)]
    chunks = [docs[i: i + 2] for i in range(0, len(docs), 2)]
    tf = jrun_tfidf_sharded(iter(chunks), jcfg.TfidfConfig(vocab_bits=10), mesh=mesh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft._owned_scale_sweep(mesh, d)
    printed = buf.getvalue()
    points = [dict(scale=float(m[0]), n=int(m[2]), e=int(m[3]), comm=int(m[4]))
              for m in SWEEP_LINE.findall(printed)]
    scfg = jcfg.PageRankConfig(iterations=2, dangling="redistribute", init="uniform",
                               dtype="float32")
    for p in points:
        g = jg.synthetic_zipf(p["n"], p["e"], seed=7, src_exponent=1.5)
        p["sum"] = float(np.asarray(
            jrun_sharded(g, scfg, mesh=mesh, strategy="owned").ranks).sum())
    verdict = VERDICT_LINE.search(printed)
    return {"sums": sums, "tfidf": (tf.n_docs, tf.nnz), "points": points,
            "exponent": float(verdict[1]), "auto_select": verdict[2]}


@pytest.fixture(scope="module", params=DS, ids=lambda d: f"D{d}")
def both(request):
    d = request.param
    with pytest.MonkeyPatch.context() as mp:
        for k, v in KNOBS.items():
            mp.setenv(k, v)
        port = dryrun.dryrun_multichip(d, device="cpu")
        ref = reference(d)
    return d, port, ref


def test_every_strategy_matches_the_reference(both):
    d, port, ref = both
    assert port["layout"] == f"{d} slots of cpu"
    assert set(port["strategies"]) == set(ref["sums"]) == set(dryrun.STRATEGIES)
    for s, total in port["strategies"].items():
        assert abs(total - ref["sums"][s]) <= 1e-6, (s, total, ref["sums"][s])


def test_sharded_tfidf_matches_the_reference(both):
    _, port, ref = both
    assert (port["tfidf"]["n_docs"], port["tfidf"]["nnz"]) == ref["tfidf"]


def test_sweep_comm_bytes_equal_the_references(both):
    _, port, ref = both
    got = [(p["scale"], p["n"], p["e"], p["comm_bytes_per_step"])
           for p in port["owned_scale"]["points"]]
    assert got == [(p["scale"], p["n"], p["e"], p["comm"]) for p in ref["points"]]
    assert len(got) == 2


def test_sweep_rank_sums_match_the_references(both):
    _, port, ref = both
    for p, r in zip(port["owned_scale"]["points"], ref["points"], strict=True):
        assert abs(p["rank_sum"] - r["sum"]) <= 1e-6, (p, r)


def test_sweep_verdict_matches_the_references(both):
    d, port, ref = both
    sweep = port["owned_scale"]
    assert round(sweep["comm_bytes_exponent"], 3) == ref["exponent"] < 1.0
    assert sweep["auto_select"] == ref["auto_select"] == "owned"
    assert not sweep["replicated_fits"]


def test_sweep_holds_owned_to_one_device(both):
    """Each point's float64 owned within 1e-9 L1 of one device, and its
    float32 owned equal to one device bit for bit."""
    _, port, _ = both
    for p in port["owned_scale"]["points"]:
        assert p["f64_l1_vs_one_device"] <= dryrun.F64_L1
        assert p["f32_entries_differ_from_one_device"] == 0
        assert p["f32_l1_vs_one_device"] <= 1e-6
        # CPU slots: no card memory
        assert p["max_memory_allocated"] is None and p["memory_allocated_before"] is None
        assert p["partition_secs"] >= 0 and p["iters_per_sec"] > 0


def test_sweep_records_the_float64_head_psum_bytes(both):
    """Beside the reference's model, each point records what the owned
    step's float64 [h_pad+2] head psum moves a step: the model's
    ring-allreduce entries at 8 bytes each."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import pagerank_sharded as tps

    d, port, _ = both
    for p in port["owned_scale"]["points"]:
        sh = tps.partition_graph(dryrun.sweep_graph(p["n"], p["e"]), d, strategy="owned").owned
        assert p["head_psum_bytes_per_step"] == 2 * (sh.h_pad + 2) * (d - 1) // d * 8 > 0


def test_exponent_assertion_fires_on_a_4x_sweep():
    """Comm bytes growing faster than n over a sweep spanning 4x fail the
    reference's sublinearity bar; points spanning less than 4x are not held
    to it, as in the reference."""
    with pytest.raises(AssertionError, match="comm bytes not sublinear"):
        dryrun.sweep_verdict([(1000, 5000), (4000, 40000)], 5.83, 4, 1, "owned")
    got = dryrun.sweep_verdict([(1000, 5000), (3999, 40000)], 5.83, 4, 1, "owned")
    assert got["comm_bytes_exponent"] > 1.0
    with pytest.raises(AssertionError):  # sublinear, but the replicated state fits
        dryrun.sweep_verdict([(1000, 5000), (4000, 6000)], 5.83, 4, 1 << 40, "edges")


def test_empty_scales_skip_the_sweep_as_the_reference(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_OWNED_SCALES", " , ")
    assert dryrun.owned_scale_sweep(None, 4) is None
    port = capsys.readouterr().out
    graft._owned_scale_sweep(None, 4)
    assert capsys.readouterr().out == port == \
        "owned-scale sweep: skipped (BENCH_OWNED_SCALES empty)\n"


def test_mesh_is_slots_of_one_card_or_one_slot_a_card(monkeypatch):
    """On ``cuda`` the dry run takes one slot a card where that many cards
    are visible, else the slots of ``cuda:0``; an indexed device keeps its
    slots on that device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh, layout = dryrun.dryrun_mesh(4)
    assert mesh.devices == [torch.device("cuda", i) for i in range(4)]
    assert layout == "one slot a card on 4 cards"
    mesh, layout = dryrun.dryrun_mesh(8)
    assert mesh.devices == [torch.device("cuda", 0)] * 8 and layout == "8 slots of cuda:0"
    mesh, _ = dryrun.dryrun_mesh(4, "cuda:1")
    assert mesh.devices == [torch.device("cuda", 1)] * 4
    mesh, layout = dryrun.dryrun_mesh(2, "cpu")
    assert mesh.devices == [torch.device("cpu")] * 2 and layout == "2 slots of cpu"


def test_cli_prints_the_references_lines_then_a_stamped_record(monkeypatch, capsys):
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_OWNED_SCALES", "1")
    assert dryrun.main(["2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "dryrun mesh: 2 slots of cpu"
    assert [ln.split(":")[0] for ln in lines[1:8]] == \
        [f"dryrun pagerank[{s}] on 2 devices" for s in dryrun.STRATEGIES]
    assert lines[8].startswith("dryrun tfidf sharded on 2 devices: ok (nnz=")
    assert SWEEP_LINE.match(lines[9])
    rec = json.loads(lines[-1])
    assert (rec["backend"], rec["device"], rec["power_limit"]) == ("cpu", "cpu", None)
    assert [p["scale"] for p in rec["owned_scale"]["points"]] == [1.0]
