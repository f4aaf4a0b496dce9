"""One mesh across several processes (``parallel.init_distributed``), on
the CPU over gloo and the loopback.

Two and four processes are spawned, each joining the group from
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
(``..._torch/tools/mesh_processes.py``); one group a process count runs
every case, with one and two CPU slots a process.  The spawned processes
import the port only.  Held here:

- every PageRank strategy and ``auto`` under ``segment`` and ``cumsum``,
  a ``tol`` run, sharded TF-IDF, HITS (``tol``), components and PPR:
  every process returns the same bits, equal to the one-process slot mesh
  of the same slots;
- float64 within 1e-12 of the JAX package's sharded runner on the
  conftest's 8 host devices;
- a run stopped at 10 with a checkpoint every 5 (process 0 writes) and
  resumed from it to 20 on every process, equal to the unbroken run;
- a lost slot: every process raises ``ResilienceExhausted`` naming the
  newest checkpoint, with no shrink, where the one-process mesh shrinks;
  a process killed mid-run ends its peer's run with an error, not a hang;
- ``init_distributed``'s arguments and environment, its refusal of NCCL
  without CUDA, and the meshes a group refuses.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import mesh as jmesh
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import pagerank_sharded as jps
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import STRATEGIES
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import mesh_processes as mp

GRAPH = (500, 3000, 42)  # tests/test_torch_parallel.py's graph
TINY = "tests/fixtures/tiny.txt"
WORLDS = (2, 4)
SLOTS = (1, 2)
DEADLINE_S = 150.0
F32 = dict(iterations=20, dangling="redistribute", init="uniform", dtype="float32")
F64 = dict(F32, dtype="float64")


def _pagerank_cases() -> list:
    return [dict(name=f"pagerank-{s}-{impl}-L{slots}", kind="pagerank", strategy=s,
                 slots=slots, cfg=dict(F32, spmv_impl=impl))
            for slots in SLOTS for s in STRATEGIES + ("auto",)
            for impl in ("segment", "cumsum") if not (s == "owned" and impl == "cumsum")]


def _cases(world: int, tmp) -> list:
    g = tg.synthetic_powerlaw(*GRAPH[:2], seed=GRAPH[2])
    queries = [[int(g.node_ids[i])] for i in (0, 7, 42)]
    cases = _pagerank_cases() + [
        dict(name="pagerank-tol-L2", kind="pagerank", strategy="nodes", slots=2,
             cfg=dict(F32, iterations=500, tol=1e-7)),
        dict(name="pagerank-f64-L2", kind="pagerank", strategy="src_ring", slots=2, cfg=F64),
        dict(name="resume-owned-L2", kind="resume", strategy="owned", slots=2, cfg=F32,
             stop_at=10, every=5, checkpoint_dir=str(tmp / "resume")),
        dict(name="loss-edges-L2", kind="loss", strategy="edges", slots=2, cfg=F32,
             stop_at=10, every=5, checkpoint_dir=str(tmp / "loss"),
             plan="pagerank_step:device_lost@dev:1"),
        dict(name="refusals", kind="refusals"),
    ]
    for slots in SLOTS:
        cases += [
            dict(name=f"tfidf-L{slots}", kind="tfidf", slots=slots, chunk_docs=2,
                 cfg=dict(vocab_bits=10, idf_mode="smooth", l2_normalize=True)),
            dict(name=f"hits-L{slots}", kind="hits", slots=slots,
                 cfg=dict(iterations=100, tol=1e-8)),
            dict(name=f"cc-L{slots}", kind="cc", slots=slots),
            dict(name=f"ppr-L{slots}", kind="ppr", slots=slots, queries=queries,
                 cfg=dict(F32, iterations=10)),
        ]
    return cases


def _data() -> dict:
    with open(TINY) as f:
        return {"graph": GRAPH, "docs": f.read().splitlines()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"P{w}")
def group(request, tmp_path_factory):
    """Every case through one spawned group of ``P`` processes:
    ``(P, cases, each process's results)``."""
    world = request.param
    cases = _cases(world, tmp_path_factory.mktemp(f"mesh{world}"))
    outs = mp.spawn(cases, _data(), processes=world, device="cpu", timeout_s=DEADLINE_S)
    return world, {c["name"]: c for c in cases}, outs


def _held_to_one_process(group, name: str) -> dict:
    world, cases, outs = group
    case = cases[name]
    want = mp.run_case(case, _data(), mp.case_mesh(case, world, "cpu", spread=False))
    got = outs[0][name]
    for p in range(1, world):
        assert outs[p][name]["digests"] == got["digests"], f"process {p} differs"
    assert set(got["arrays"]) == set(want["arrays"]) and want["arrays"]
    for k, v in want["arrays"].items():
        assert got["arrays"][k].dtype == v.dtype and got["arrays"][k].shape == v.shape, k
        assert got["arrays"][k].tobytes() == v.tobytes(), f"{name}: {k} differs"
    assert got["info"]["processes"] == world and got["info"]["backend"] == "gloo"
    return got


@pytest.mark.parametrize("name", [c["name"] for c in _pagerank_cases()])
def test_pagerank_bit_equal_to_the_one_process_mesh(group, name):
    got = _held_to_one_process(group, name)
    assert got["info"]["iterations"] == 20
    assert np.isfinite(got["arrays"]["ranks"]).all()


@pytest.mark.parametrize("name", ["tfidf-L1", "tfidf-L2", "hits-L1", "hits-L2", "cc-L1",
                                  "cc-L2", "ppr-L1", "ppr-L2", "pagerank-tol-L2"])
def test_tfidf_and_workloads_bit_equal_to_the_one_process_mesh(group, name):
    got = _held_to_one_process(group, name)
    if name == "pagerank-tol-L2":
        assert 0 < got["info"]["iterations"] < 500  # every process stopped at one step


def test_float64_within_1e12_of_the_reference(group):
    """The float64 run against the JAX package's sharded runner at the
    same slot count (the conftest's host devices)."""
    world, cases, _ = group
    got = _held_to_one_process(group, "pagerank-f64-L2")
    case = cases["pagerank-f64-L2"]
    want = jps.run_pagerank_sharded(
        jg.synthetic_powerlaw(*GRAPH[:2], seed=GRAPH[2]), jcfg.PageRankConfig(**case["cfg"]),
        n_devices=2 * world, strategy=case["strategy"]).ranks
    assert np.abs(got["arrays"]["ranks"] - np.asarray(want)).max() <= 1e-12


def test_the_processes_import_the_port_only(group):
    world, _, outs = group
    for p in range(world):
        assert outs[p]["_process"]["rank"] == p
        assert outs[p]["_process"]["jax_loaded"] == []


def test_checkpoint_written_once_and_resumed_on_every_process(group):
    world, cases, outs = group
    got = _held_to_one_process(group, "resume-owned-L2")  # equal to the unbroken run
    assert got["info"]["iterations"] == 20
    for p in range(world):
        assert outs[p]["resume-owned-L2"]["info"]["resumed_at"] == [5]


def test_a_lost_slot_ends_every_process_without_a_shrink(group):
    """``device_lost@dev:1`` at the resumed run's step: every process
    raises ``ResilienceExhausted`` at ``pagerank_step`` naming checkpoint 5,
    with no ``degraded`` event; the one-process mesh of the same slots
    shrinks onto the survivors and finishes."""
    world, cases, outs = group
    for p in range(world):
        info = outs[p]["loss-edges-L2"]["info"]
        assert (info["raised"], info["site"]) == ("ResilienceExhausted", "pagerank_step"), info
        assert info["checkpoint"] == "ckpt_00000005.npz" and info["degraded"] == []
        assert info["secs_to_raise"] < DEADLINE_S
    case = dict(cases["loss-edges-L2"], checkpoint_dir=cases["loss-edges-L2"]["checkpoint_dir"]
                + "-one")
    one = mp.run_case(case, _data(), mp.case_mesh(case, world, "cpu", spread=False))
    assert one["info"]["raised"] is None
    assert ("pagerank_step", "mesh_shrink") in one["info"]["degraded"]


def test_the_group_refuses_uneven_and_interleaved_meshes(group):
    world, _, outs = group
    info = outs[0]["refusals"]["info"]
    assert "do not divide evenly" in info["uneven"]
    assert "contiguous slots, in process order" in info["interleaved"]
    assert f"{world + 1} slots do not divide evenly over {world} processes" in info["mesh_for"]


def test_a_killed_process_ends_its_peer_with_an_error(tmp_path):
    """Process 1 is killed at the resumed run's first segment: process 0's
    collective fails and its run ends in ``ResilienceExhausted`` naming
    checkpoint 5, well inside the deadline."""
    case = dict(name="peer", kind="loss", strategy="nodes", slots=1, cfg=F32, stop_at=10,
                every=5, checkpoint_dir=str(tmp_path / "peer"))
    outs = mp.spawn([case], _data(), processes=2, device="cpu", timeout_s=60.0,
                    may_die=(1,),
                    env=[{}, {"GRAFT_CHAOS": "pagerank_step:proc_kill@3"}])
    assert outs[1] is None
    info = outs[0]["peer"]["info"]
    assert info["raised"] == "ResilienceExhausted", info
    assert info["checkpoint"] == "ckpt_00000005.npz" and info["secs_to_raise"] < 60.0


# ----------------------------------------------------- init_distributed


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_init_distributed_resolves_its_arguments(monkeypatch, how):
    for k, v in dict(MASTER_ADDR="10.0.0.7", MASTER_PORT="29511", WORLD_SIZE="4",
                     RANK="3").items():
        monkeypatch.setenv(k, v)
    if how == "arguments":
        got = pmesh._resolve("127.0.0.1:1234", 2, 1, None)
        assert got == ("127.0.0.1", 1234, 2, 1, "gloo")
    else:
        assert pmesh._resolve(None, None, None, "gloo") == ("10.0.0.7", 29511, 4, 3, "gloo")


@pytest.mark.parametrize("args, match", [
    (("127.0.0.1:1234", 2, 0, "nccl"), "backend 'nccl' needs CUDA"),
    (("127.0.0.1:1234", 2, 2, None), "process 2 of 2"),
    (("127.0.0.1", 2, 0, None), "is not host:port"),
    (("127.0.0.1:1234", 2, 0, "mpi"), "use 'gloo' or 'nccl'"),
    ((None, 2, 0, None), r"\$MASTER_ADDR is not set"),
])
def test_init_distributed_refusals(monkeypatch, args, match):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match=match):
        pmesh.init_distributed(*args[:3], backend=args[3])
    assert not pmesh.is_distributed()


def test_one_process_meshes_are_unchanged():
    """Outside a group a mesh is one process's, as before: ids by position,
    process 0, every slot local; a multi-process slot list needs the
    group; ``init_distributed`` takes the reference's arguments first."""
    m = pmesh.mesh_for(4, pmesh.NODES_AXIS, "cpu")
    assert [(s.id, s.process) for s in m.slots] == [(i, 0) for i in range(4)]
    assert m.processes == 1 and m.positions == [0, 1, 2, 3] and m.backend is None
    with pytest.raises(ValueError, match="process group has 1"):
        pmesh.make_mesh(devices=[pmesh.Slot(i, torch.device("cpu"), i // 2) for i in range(4)])
    with pytest.raises(ValueError, match="do not divide evenly over 2 processes"):
        pmesh.make_mesh(devices=[pmesh.Slot(i, torch.device("cpu"), min(i, 1)) for i in range(3)])
    ref = list(inspect.signature(jmesh.init_distributed).parameters)
    assert list(inspect.signature(pmesh.init_distributed).parameters)[:3] == ref
