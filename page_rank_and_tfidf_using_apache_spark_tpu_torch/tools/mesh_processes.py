"""The sharded API over one mesh whose slots span several processes, case
by case.

:func:`spawn` starts ``processes`` processes (start method ``spawn``: no
process forks a CUDA context), each of which joins the group through
``parallel.init_distributed()`` from ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``, builds the case's mesh (``slots`` a process
of ``device``, ``cuda:0`` unless the caller passes ``"cpu"``), runs every
case through the public entry points and reports.  Every process reports
a SHA-256 digest of each result array; process 0 reports the arrays too.
One deadline bounds the whole group: a process that hangs, raises or dies
fails the call, and every process still running at the deadline is
killed.

:func:`run_case` is the same case in this process over any mesh, so a
caller holds the processes' results to the one-process mesh of the same
slots.  Cases (dicts, ``name`` and ``kind`` and the kind's keys):

- ``pagerank``: ``strategy``, ``cfg`` (``PageRankConfig`` keywords);
- ``resume``: ``pagerank`` stopped at ``stop_at`` with a checkpoint every
  ``every`` under ``checkpoint_dir``, then resumed to ``cfg``'s
  iterations (one-process: the unbroken run);
- ``loss``: ``pagerank`` stopped at ``stop_at`` with a checkpoint every
  ``every`` under ``checkpoint_dir``, then resumed under the chaos plan
  ``plan`` (else the process's ``GRAFT_CHAOS``): reports what it raised,
  the checkpoint it named, its ``degraded`` events and its seconds;
- ``tfidf``: ``run_tfidf_sharded`` over the corpus in chunks of
  ``chunk_docs``, ``cfg`` (``TfidfConfig`` keywords);
- ``hits``, ``cc``: the sharded workloads, ``cfg`` their configs' keywords;
- ``ppr``: ``queries`` (original node ids) and ``cfg``;
- ``refusals``: the meshes a group refuses, their messages.

``data["graph"]`` is ``(n_nodes, n_edges, seed)`` of
``io.graph.synthetic_powerlaw`` and the corpus ``data["docs"]`` (the lines)
or ``data["corpus"]``, ``(n_docs, tokens, seed)`` of
``io.text.synthetic_corpus_lines``; each process builds its own.  Each
result carries its kernel launches in the process (``launches``), its wall
seconds and, for PageRank, the last segment's iterations/s.  A process's
results also say, under ``_process``, whether anything had imported JAX
or the JAX package into it.
"""

from __future__ import annotations

import contextlib
import hashlib
import multiprocessing
import os
import queue as queue_mod
import socket
import sys
import time
import traceback

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh

NODES_KINDS = ("pagerank", "resume", "loss", "hits", "cc")
FORBIDDEN = ("jax", "jaxlib", "page_rank_and_tfidf_using_apache_spark_tpu")


def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def case_mesh(case: dict, processes: int, device, *, spread: bool = True) -> pmesh.Mesh:
    """The case's mesh: ``case["slots"]`` slots a process of ``device``
    (or of ``device[i]`` for slot ``i``, a list) over ``processes``
    processes; with ``spread=False`` the one-process mesh of the same
    slots."""
    per = int(case.get("slots", 1))
    axis = pmesh.NODES_AXIS if case["kind"] in NODES_KINDS else pmesh.DATA_AXIS
    devs = [device[i] if isinstance(device, (list, tuple)) else device
            for i in range(processes * per)]
    return pmesh.make_mesh(axis=axis, devices=[
        pmesh.Slot(i, torch.device(d), i // per if spread else 0) for i, d in enumerate(devs)])


def _graph(data: dict, cache: dict):
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw

    if "graph" not in cache:
        n, e, seed = data["graph"]
        cache["graph"] = synthetic_powerlaw(n, e, seed=seed)
    return cache["graph"]


def _docs(data: dict, cache: dict) -> list:
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.text import synthetic_corpus_lines

    if "docs" not in cache:
        cache["docs"] = (data["docs"] if "docs" in data
                         else synthetic_corpus_lines(*data["corpus"]))
    return cache["docs"]


def _rate(metrics) -> float | None:
    rates = [r["iters_per_sec"] for r in metrics.records if "iters_per_sec" in r]
    return float(rates[-1]) if rates else None


def run_case(case: dict, data: dict, mesh: pmesh.Mesh, cache: dict | None = None) -> dict:
    """One case over ``mesh`` in this process: ``{"arrays": {...},
    "info": {...}}``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        run_components_sharded,
        run_hits_sharded,
        run_pagerank_sharded,
        run_ppr_sharded,
        run_tfidf_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    cache = {} if cache is None else cache
    kind = case["kind"]
    kw = dict(case.get("cfg", {}))
    m = MetricsRecorder()
    arrays: dict = {}
    info: dict = {}
    if kind == "pagerank":
        res = run_pagerank_sharded(_graph(data, cache), tcfg.PageRankConfig(**kw), mesh=mesh,
                                   strategy=case["strategy"], metrics=m)
        arrays["ranks"] = res.ranks
        info.update(iterations=res.iterations, iters_per_sec=_rate(m))
    elif kind == "resume":
        g = _graph(data, cache)
        if mesh.processes == 1:
            res = run_pagerank_sharded(g, tcfg.PageRankConfig(**kw), mesh=mesh,
                                       strategy=case["strategy"], metrics=m)
        else:
            ck = dict(kw, checkpoint_every=case["every"], checkpoint_dir=case["checkpoint_dir"])
            run_pagerank_sharded(g, tcfg.PageRankConfig(**dict(ck, iterations=case["stop_at"])),
                                 mesh=mesh, strategy=case["strategy"])
            res = run_pagerank_sharded(g, tcfg.PageRankConfig(**ck), mesh=mesh,
                                       strategy=case["strategy"], metrics=m, resume=True)
            info["resumed_at"] = [r["start_iter"] for r in m.records
                                  if r.get("event") == "resume"]
        arrays["ranks"] = res.ranks
        info["iterations"] = res.iterations
    elif kind == "loss":
        g = _graph(data, cache)
        ck = dict(kw, checkpoint_every=case["every"], checkpoint_dir=case["checkpoint_dir"])
        run_pagerank_sharded(g, tcfg.PageRankConfig(**dict(ck, iterations=case["stop_at"])),
                             mesh=mesh, strategy=case["strategy"])
        elastic.reset_health()
        plan = chaos.inject(case["plan"]) if case.get("plan") else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with plan:
                res = run_pagerank_sharded(g, tcfg.PageRankConfig(**ck), mesh=mesh,
                                           strategy=case["strategy"], metrics=m, resume=True)
            info["raised"] = None
            arrays["ranks"] = res.ranks
        except ResilienceExhausted as exc:
            info.update(raised="ResilienceExhausted", site=exc.site,
                        checkpoint=os.path.basename(exc.last_checkpoint or ""))
        except Exception as exc:  # noqa: BLE001 — reported: the caller holds it
            info.update(raised=type(exc).__name__, error=str(exc)[:300])
        finally:
            elastic.reset_health()
        info["secs_to_raise"] = time.perf_counter() - t0
        info["degraded"] = [(r["site"], r["ladder"]) for r in m.records
                            if r.get("event") == "degraded"]
    elif kind == "tfidf":
        docs = _docs(data, cache)
        step = case["chunk_docs"]
        chunks = [docs[i:i + step] for i in range(0, len(docs), step)]
        out = run_tfidf_sharded(iter(chunks), tcfg.TfidfConfig(**kw), mesh=mesh, metrics=m)
        for f in ("doc", "term", "count", "df", "idf", "weight", "doc_lengths"):
            arrays[f] = np.asarray(getattr(out, f))
        info["n_docs"] = out.n_docs
    elif kind == "hits":
        res = run_hits_sharded(_graph(data, cache), tcfg.HitsConfig(**kw), mesh=mesh, metrics=m)
        arrays.update(hubs=res.hubs, authorities=res.authorities)
        info["iterations"] = res.iterations
    elif kind == "cc":
        res = run_components_sharded(_graph(data, cache), tcfg.ComponentsConfig(**kw),
                                     mesh=mesh, metrics=m)
        arrays["labels"] = res.labels
        info.update(iterations=res.iterations, n_components=res.n_components)
    elif kind == "ppr":
        res = run_ppr_sharded(_graph(data, cache), tcfg.PageRankConfig(**kw),
                              [list(q) for q in case["queries"]], mesh=mesh, metrics=m)
        arrays["ranks"] = res.ranks
        info["iterations"] = res.iterations
    elif kind == "refusals":
        dev = torch.device(case.get("device", "cpu"))
        tries = {
            "uneven": lambda: pmesh.make_mesh(devices=[
                pmesh.Slot(i, dev, min(i, pmesh.process_count() - 1))
                for i in range(pmesh.process_count() + 1)]),
            "interleaved": lambda: pmesh.make_mesh(devices=[
                pmesh.Slot(i, dev, i % pmesh.process_count())
                for i in range(2 * pmesh.process_count())]),
            "mesh_for": lambda: pmesh.mesh_for(pmesh.process_count() + 1, pmesh.NODES_AXIS,
                                               dev),
        }
        for name, fn in tries.items():
            try:
                fn()
                info[name] = None
            except ValueError as exc:
                info[name] = str(exc)
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    part = [r for r in m.records
            if r.get("event") in ("partition", "ppr_sharded", "super_chunk")]
    if part:
        info.update(processes=part[0]["processes"], backend=part[0]["backend"])
    return {"arrays": arrays, "info": info}


def _launches() -> dict:
    return {**pk.LAUNCHES, **sk.LAUNCHES}


def run_cases(cases: list, data: dict, processes: int, device: str) -> dict:
    """Every case over its mesh in this process of the group; each
    result's arrays replaced by their digests (process 0 keeps the arrays
    under ``arrays``)."""
    cache: dict = {}
    out = {}
    for case in cases:
        mesh = case_mesh(case, processes, device)
        pk.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        res = run_case(case, data, mesh, cache)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        res["info"].update(secs=time.perf_counter() - t0, launches=_launches())
        res["digests"] = {k: digest(v) for k, v in res["arrays"].items()}
        if pmesh.process_index() != 0:
            res.pop("arrays")
        out[case["name"]] = res
    out["_process"] = {"rank": pmesh.process_index(), "threads": torch.get_num_threads(),
                       "jax_loaded": sorted(m for m in sys.modules
                                            if m.split(".")[0] in FORBIDDEN)}
    return out


def _process_main(rank: int, world: int, cases: list, data: dict, device: str,
                  backend: str | None, timeout_s: float, reports) -> None:
    if device == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        pmesh.init_distributed(backend=backend, timeout_s=timeout_s)
        try:
            out = run_cases(cases, data, world, device)
        finally:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        reports.put((rank, "ok", out))
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        reports.put((rank, "error", traceback.format_exc()[-6000:]))


def spawn(cases: list, data: dict, *, processes: int, device: str = "cuda:0",
          backend: str | None = None, timeout_s: float = 120.0,
          env: list | None = None, may_die: tuple = ()) -> list:
    """Run ``cases`` over ``processes`` spawned processes; returns each
    process's :func:`run_cases` result, in rank order (None for a process
    of ``may_die`` that died).  ``env``: one dict of environment variables
    a process.  Raises ``RuntimeError`` naming every process that raised,
    died or missed the deadline of ``timeout_s`` seconds (the group's
    collectives time out at the same bound); no process outlives the
    call."""
    ctx = multiprocessing.get_context("spawn")
    reports = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(
        target=_process_main, name=f"mesh-process-{rank}", daemon=True,
        args=(rank, processes, cases, data, device, backend, timeout_s, reports))
        for rank in range(processes)]
    saved = dict(os.environ)
    try:
        for rank, p in enumerate(procs):
            # the environment a process starts with (a card's visibility
            # must be set before its first CUDA call)
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                              WORLD_SIZE=str(processes), RANK=str(rank),
                              **(env[rank] if env else {}))
            p.start()
            os.environ.clear()
            os.environ.update(saved)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    failures: list = []
    try:
        while len(got) < processes:
            left = deadline - time.monotonic()
            if left <= 0:
                failures.append(f"processes {sorted(set(range(processes)) - set(got))} "
                                f"reported nothing within {timeout_s} s")
                break
            try:
                rank, status, payload = reports.get(timeout=min(left, 0.5))
                got[rank] = (status, payload)
                if status != "ok":
                    # its peers wait on it in a collective: a short grace
                    deadline = min(deadline, time.monotonic() + 10.0)
                continue
            except queue_mod.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if dead:
                time.sleep(1.0)  # a report may still be in the pipe
                while True:
                    try:
                        rank, status, payload = reports.get_nowait()
                        got[rank] = (status, payload)
                    except queue_mod.Empty:
                        break
                for r in dead:
                    if r not in got and r in may_die:
                        got[r] = ("died", None)
                    elif r not in got:
                        failures.append(f"process {r} died (exit code {procs[r].exitcode})")
                if failures:
                    break
    finally:
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        reports.close()
    failures += [f"process {r} raised:\n{payload}" for r, (status, payload) in sorted(got.items())
                 if status == "error"]
    if failures:
        raise RuntimeError("the mesh's processes failed: " + "\n".join(failures))
    return [got[r][1] for r in range(processes)]
