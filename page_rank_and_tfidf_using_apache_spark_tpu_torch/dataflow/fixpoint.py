"""``fixpoint``: the iterate-to-convergence loop and the host driver that
runs it in checkpointed segments, under every fixpoint workload; and
``commit_barrier``, the commit point of the streaming ingest.

Counterpart of the JAX package's ``dataflow/fixpoint.py``: ``iterate``,
``default_delta``, ``commit_barrier``, ``checkpoint_salvage``,
``run_segments`` and ``run_single_chip_fixpoint``.  PyTorch runs eagerly,
so ``iterate`` is a Python loop that enqueues one step after another on the
device.  ``run_segments`` runs ``cfg.iterations`` in checkpoint-sized
segments for PageRank (``models/pagerank.py``), batched personalized
PageRank, HITS and connected components (``dataflow/ppr.py``, ``hits.py``,
``components.py``), with the JAX package's metrics records, spans and
checkpoint format.  Every segment dispatch runs under the retry executor
at the reference's site (``{prefix}_step``, ``rx.run_guarded``), and every
host pull at its own (``{prefix}_delta_sync``, ``_ckpt_pull``,
``_result_pull``, ``rx.device_get``): a transient fault retries.  A loss
that names its device walks the reference's single-device salvage
(:func:`make_cpu_salvage`, :func:`make_pull_salvage`, ``ElasticResult``):
it reloads the newest checkpoint, re-runs the uncommitted span on the CPU
from that host state and finishes the run there, reading nothing from the
card.  Anything else raises ``ResilienceExhausted`` naming the newest
checkpoint: a whole-backend loss (``lost``), and a kernel's own fault.
The reference's per-segment ``cpu`` rung (``make_cpu_invoke``), which
pulls the live carry off the device and runs the segment on the CPU, is
not ported: a carry that can still be read means the card still answers,
and the port does not move its work to the CPU while the tensors are
there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer


def commit_barrier(
    drain_all: Callable[[], None],
    commit: Callable[[], None],
    save_checkpoint: Callable[[], None] | None = None,
) -> None:
    """The drain-before-commit barrier of the staged ingest pipeline: every
    in-flight launch drains, then the device carry is pulled, then
    (optionally) the snapshot is written, so a checkpoint never holds carry
    contributions from chunks it does not record as ingested.  The
    ``ingest.commit_barrier`` span makes the drain's stall visible in a
    trace."""
    with obs.span("ingest.commit_barrier"):
        drain_all()
        commit()
        if save_checkpoint is not None:
            save_checkpoint()


def default_delta(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """L1 distance between successive carries."""
    return torch.sum(torch.abs(new - old))


def _first_tensor(carry) -> torch.Tensor:
    """The first tensor of a carry: the carry itself, else the first tensor
    of its first entry (a tuple, or a sharded runner's per-slot list)."""
    while not isinstance(carry, torch.Tensor):
        carry = carry[0]
    return carry


def iterate(
    step: Callable,
    carry0,
    *,
    iterations: int,
    tol: float = 0.0,
    delta_fn: Callable = default_delta,
):
    """Run ``step(carry) -> carry`` to a fixpoint.

    With ``tol == 0`` it runs exactly ``iterations`` steps with no host
    sync, and measures ``delta_fn(new, old)`` on the last step only.  With
    ``tol > 0`` it measures the delta every step and reads it on the host
    (one sync per step), stopping once it is ``<= tol``.  Returns
    ``(carry, iters_done, last_delta)``; ``last_delta`` is a 0-d tensor of
    the carry's dtype (float32 for a non-float carry), ``inf`` when
    ``iterations == 0``."""
    like = _first_tensor(carry0)
    dtype = like.dtype if like.is_floating_point() else torch.float32
    delta = torch.full((), float("inf"), dtype=dtype, device=like.device)
    carry = carry0
    if tol > 0.0:
        it = 0
        while it < iterations and float(delta) > tol:  # graftlint: disable=host-sync-in-loop (ROADMAP Queue 3: dataflow/fixpoint.iterate with tol > 0 syncs the host once a step)
            new = step(carry)
            delta = delta_fn(new, carry)
            carry = new
            it += 1
        return carry, it, delta
    for i in range(iterations):
        new = step(carry)
        if i == iterations - 1:
            delta = delta_fn(new, carry)
        carry = new
    return carry, iterations, delta


def checkpoint_salvage(cfg, init_state: Callable[[], np.ndarray]):
    """``(at_iter, state_np)`` from the newest checkpoint under
    ``cfg.checkpoint_dir`` (refused if another configuration wrote it),
    else ``(0, init_state())``."""
    if cfg.checkpoint_dir:
        latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
        if latest is not None:
            step, arrays, _ = ckpt.load_checkpoint(latest, cfg.config_hash())
            return int(step), arrays["ranks"]
    return 0, init_state()


def resume_state(cfg, metrics: MetricsRecorder, state: np.ndarray) -> int:
    """Load the newest checkpoint into ``state`` in place, in ``state``'s
    dtype, and return the iteration it was taken at (0 where there is
    none).  A checkpoint holds exactly the run's carry, so another shape
    means another graph (the config hash excludes the input) and raises
    rather than initializing part of the carry."""
    if not cfg.checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    start_iter, saved = checkpoint_salvage(cfg, lambda: None)
    if saved is None:
        return 0
    if saved.shape != state.shape:
        raise ValueError(
            f"checkpoint under {cfg.checkpoint_dir} holds a carry of shape "
            f"{saved.shape} but this run's is {state.shape}; refusing to "
            "resume from a different graph"
        )
    state[...] = saved
    metrics.record(event="resume", path=ckpt.latest_checkpoint(cfg.checkpoint_dir),
                   start_iter=start_iter)
    return start_iter


def make_cpu_salvage(
    cfg,
    metrics: MetricsRecorder,
    *,
    site_prefix: str,
    init_state: Callable[[], np.ndarray],
    cpu_exec: Callable,
    make_runner: Callable,
    extract_np: Callable,
):
    """The single-device salvage rung, shared by every fixpoint workload: a
    loss that names its device (``device_lost``), at the segment dispatch
    or first surfacing at the delta sync or the checkpoint pull, is
    acknowledged in the health registry, the newest checkpoint (else the
    initial carry) is reloaded, and the uncommitted span re-runs on the CPU
    from that host state.  Any other error (a loss with no device index,
    ``lost``: the whole backend; a kernel's own fault), and any loss under
    ``GRAFT_ELASTIC=0``, raises on to ``ResilienceExhausted``.

    ``cpu_exec(rerun_cfg, state_np) -> (state, iters, delta, invoke)`` runs
    the span on the CPU and returns the ``invoke`` every later segment
    uses.  Plug the result into :func:`run_segments`'s ``elastic_rebuild``.
    """

    def rebuild(exc, rd, done, seg_cfg):
        lost = elastic.unwrap_device_loss(exc)
        idx = elastic.device_index(lost) if lost is not None else None
        if not elastic.enabled() or idx is None:
            raise exc
        elastic.health().mark_lost(idx)
        at_iter, state = checkpoint_salvage(cfg, init_state)
        todo = done - at_iter + seg_cfg.iterations
        obs.emit("degraded", site=f"{site_prefix}_step", ladder="cpu",
                 salvage_iter=at_iter, rerun_iters=todo,
                 error=f"{type(exc).__name__}: {exc}"[:200])
        obs.counter("degraded")
        metrics.record(event="degraded", site=f"{site_prefix}_step",
                       ladder="cpu", salvage_iter=at_iter, rerun_iters=todo)
        with obs.span(f"{site_prefix}.cpu_salvage", at_iter=at_iter,
                      todo=todo):
            rerun_cfg = dataclasses.replace(
                seg_cfg, iterations=todo, checkpoint_every=0,
                checkpoint_dir=None,
            )
            rd2, iters, delta, invoke2 = cpu_exec(rerun_cfg, state)
        return ElasticResult(
            rd2, at_iter + int(iters) - done, float(delta),
            make_runner, invoke2, extract_np, {"backend": "cpu"},
        )

    return rebuild


def make_pull_salvage(
    cfg,
    metrics: MetricsRecorder,
    *,
    site_prefix: str,
    init_state: Callable[[], np.ndarray],
    cpu_exec: Callable,
    get_done: Callable[[], int],
):
    """The result-pull counterpart of :func:`make_cpu_salvage`: a loss that
    names its device, first surfacing at ``{site_prefix}_result_pull``
    where no segment is left to catch it, is acknowledged, the newest
    checkpoint reloaded, the uncommitted span re-run on the CPU, and the
    result pulled from there (the loss is acknowledged, so the pull's
    chaos injection does not fire again).  Returns a ``fallbacks`` rung
    for the final ``rx.device_get``."""

    def pull_salvage(exc):
        lost = elastic.unwrap_device_loss(exc)
        idx = elastic.device_index(lost) if lost is not None else None
        if not elastic.enabled() or idx is None:
            raise exc
        elastic.health().mark_lost(idx)
        at_iter, state = checkpoint_salvage(cfg, init_state)
        done = int(get_done())
        todo = done - at_iter
        site = f"{site_prefix}_result_pull"
        obs.emit("degraded", site=site, ladder="cpu",
                 salvage_iter=at_iter, rerun_iters=todo,
                 error=f"{type(exc).__name__}: {exc}"[:200])
        obs.counter("degraded")
        metrics.record(event="degraded", site=site, ladder="cpu",
                       salvage_iter=at_iter, rerun_iters=todo)
        with obs.span(f"{site_prefix}.cpu_salvage", at_iter=at_iter,
                      todo=todo):
            dtype = init_state().dtype
            if todo <= 0:
                return np.asarray(state).astype(dtype)
            rerun_cfg = dataclasses.replace(
                cfg, iterations=todo, checkpoint_every=0, checkpoint_dir=None
            )
            rd2, _iters, _delta, _invoke = cpu_exec(rerun_cfg, state)
            return rx.device_get(
                rd2, site=site, metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )

    return pull_salvage


class ElasticResult(NamedTuple):
    """What a salvage rung returns after it ran the failed segment on the
    CPU: the segment's outputs and the callables every later segment uses."""

    ranks_dev: object
    iters: int  # iterations gained over the count before the failure
    delta: float
    make_runner: Callable
    invoke: Callable
    extract_np: Callable
    metrics_extra: dict  # merged into every later segment record and checkpoint


def run_segments(
    cfg,
    metrics: MetricsRecorder,
    ranks_dev,
    start_iter: int,
    *,
    make_runner: Callable,
    invoke: Callable,
    extract_np: Callable[[object], np.ndarray],
    segments_allowed: bool = True,
    extra_metrics: dict | None = None,
    elastic_rebuild: Callable | None = None,
    site_prefix: str = "pagerank",
    save_checkpoint: Callable = ckpt.save_checkpoint,
):
    """Run ``cfg.iterations`` (from ``start_iter``) in checkpoint-sized
    segments.

    - ``make_runner(seg_cfg)`` builds the loop for one segment length;
      cached by length, so it is called at most twice (body segments and
      the tail).
    - ``invoke(runner, ranks_dev)`` runs one segment and returns
      ``(ranks_dev, iters_done, delta)``, the delta read on the host.
    - ``extract_np(ranks_dev)`` gives the checkpointable state array.

    ``cfg`` is duck-typed: any frozen config with ``iterations``, ``tol``,
    ``checkpoint_every``, ``checkpoint_dir`` and ``config_hash()``.
    ``checkpoint_every`` splits the run only where ``tol == 0`` and
    ``segments_allowed``: a tolerance run is one segment.  With ``tol ==
    0`` a segment boundary does not change the math (``iterate`` computes
    the delta on a segment's last step only), so a split run gives the
    unbroken run's bits.  Between segments the state goes to
    ``save_checkpoint`` (``utils/checkpoint.save_checkpoint``, or a
    multi-process mesh's writer) as ``{"ranks": payload}``.  Each
    segment records ``iter``, ``l1_delta``, ``secs`` and ``iters_per_sec``
    (and ``extra_metrics``, which is ``backend: "cpu"`` after a salvage) and each
    checkpoint a ``checkpoint`` event; the spans are ``{site_prefix}.segment`` and
    ``{site_prefix}.checkpoint``, the histogram
    ``{site_prefix}.segment_secs``.

    Each segment's ``invoke`` runs under ``rx.run_guarded`` at the
    ``{site_prefix}_step`` site, with the watchdog deadline of
    ``GRAFT_STEP_DEADLINE_S`` (default 0, none: a segment's healthy time
    grows with its length, so the sync deadline does not apply).  A chaos
    injection fires before ``invoke``, and ``invoke`` writes only fresh
    tensors, so a retry launches nothing twice.  Then the one rung,
    ``elastic_rebuild(exc, ranks_dev, done, seg_cfg)``
    (:func:`make_cpu_salvage`): it takes a loss that names its device and
    returns an :class:`ElasticResult`; this loop adopts its callables for
    every later segment (the runner cache dropped) and merges its
    ``metrics_extra`` (``backend: "cpu"``) into every later segment record
    and checkpoint.  A loss first surfacing at the checkpoint pull walks
    it too, with a zero-iteration segment: the live carry is gone, so the
    rung re-runs the uncommitted span from the newest checkpoint and the
    checkpoint is written from its state.  Any other error (a whole-backend
    ``lost``, a kernel's own fault), and a spent retry budget, raise
    ``ResilienceExhausted`` naming the newest checkpoint under
    ``cfg.checkpoint_dir``: the reference's per-segment ``cpu`` rung
    (``make_cpu_invoke``) is not ported (module docstring).  Checkpoints
    carry ``extra_metrics`` in their ``extra``.

    Returns ``(ranks_dev, done, last_delta)``.
    """
    segment = (
        cfg.checkpoint_every
        if (cfg.checkpoint_every > 0 and cfg.tol == 0.0 and segments_allowed)
        else cfg.iterations - start_iter
    )
    # GRAFT_SYNC_DEADLINE_S guards host syncs, whose healthy duration is
    # bounded; a segment's runtime grows with its length, so the dispatch
    # site takes its own knob (GRAFT_STEP_DEADLINE_S, default 0 = none).
    policy = dataclasses.replace(
        rx.RetryPolicy.from_env(),
        deadline_s=float(os.environ.get("GRAFT_STEP_DEADLINE_S", 0.0)),
    )
    runners: dict[int, Callable] = {}
    done = start_iter
    last_delta = float("inf")

    def adopt(res: ElasticResult) -> None:
        # every later segment runs where the salvage left the carry
        nonlocal make_runner, invoke, extract_np, extra_metrics
        make_runner, invoke, extract_np = (
            res.make_runner, res.invoke, res.extract_np
        )
        extra_metrics = {**(extra_metrics or {}), **res.metrics_extra}
        runners.clear()

    while done < cfg.iterations:
        todo = min(segment, cfg.iterations - done)
        seg_cfg = dataclasses.replace(
            cfg, iterations=todo, checkpoint_every=0, checkpoint_dir=None
        )
        if todo not in runners:
            runners[todo] = make_runner(seg_cfg)
        rungs: list = []
        if elastic_rebuild is not None:
            def elastic_rung(exc, seg_cfg=seg_cfg, rd=ranks_dev):
                res: ElasticResult = elastic_rebuild(exc, rd, done, seg_cfg)
                adopt(res)
                return res.ranks_dev, res.iters, res.delta

            rungs.append((None, elastic_rung))
        with Timer() as t, obs.span(f"{site_prefix}.segment", start=done, todo=todo):
            ranks_dev, iters, delta = rx.run_guarded(
                lambda r=runners[todo], rd=ranks_dev: invoke(r, rd),
                site=f"{site_prefix}_step", policy=policy, metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir, fallbacks=rungs,
            )
        done += int(iters)
        last_delta = float(delta)
        obs.histogram(f"{site_prefix}.segment_secs", t.elapsed)
        metrics.record(
            iter=done,
            l1_delta=last_delta,
            secs=t.elapsed,
            iters_per_sec=int(iters) / t.elapsed if t.elapsed > 0 else float("inf"),
            **(extra_metrics or {}),
        )
        if cfg.checkpoint_every > 0 and cfg.checkpoint_dir and done < cfg.iterations:
            with obs.span(f"{site_prefix}.checkpoint", iter=done):
                try:
                    payload = extract_np(ranks_dev)
                except Exception as exc:
                    # a loss first surfacing here: the live carry is gone,
                    # so the salvage re-runs the uncommitted span from the
                    # newest checkpoint and this one is written from it
                    # (it re-raises any other error)
                    if elastic_rebuild is None:
                        raise
                    res = elastic_rebuild(
                        exc, ranks_dev,
                        done, dataclasses.replace(seg_cfg, iterations=0),
                    )
                    adopt(res)
                    ranks_dev = res.ranks_dev
                    done += int(res.iters)  # 0 where the salvage was exact
                    payload = extract_np(ranks_dev)
                path = save_checkpoint(
                    cfg.checkpoint_dir, done,
                    {"ranks": payload}, cfg.config_hash(),
                    extra=dict(extra_metrics or {}),
                )
            metrics.record(event="checkpoint", path=path, iter=done)
        if cfg.tol > 0.0:
            # the runner stopped at the tolerance itself: one segment is
            # the whole run
            break

    metrics.scalar("iterations", done)
    metrics.scalar("l1_delta", last_delta)
    return ranks_dev, done, last_delta


def run_single_chip_fixpoint(
    cfg,
    metrics: MetricsRecorder,
    *,
    site_prefix: str,
    init_state: Callable[[], np.ndarray],
    make_runner: Callable,
    build_operands: Callable[[torch.device], tuple],
    call: Callable,
    device: str | torch.device | None = None,
    resume: bool = False,
):
    """The host driver of a fixpoint workload on one device (PPR, HITS and
    connected components run through it).

    - ``init_state()`` gives the initial carry on the host, in its dtype;
      with ``resume`` the newest checkpoint under ``cfg.checkpoint_dir``
      replaces it (:func:`resume_state`) and the run starts at its
      iteration;
    - ``build_operands(device)`` builds the non-carry operands (graph
      layout, teleport matrix, ...) on ``device`` from host state: once on
      the run's device, and again on the CPU inside the salvage, so a
      recovery never reads a lost device's memory (torch has no default
      device to switch, so the device is passed);
    - ``call(runner, operands, carry)`` runs the runner in the workload's
      argument order and returns ``(carry, iters, delta)`` with the delta
      a 0-d tensor.

    The carry goes up with ``torch.from_numpy(...).to(device)`` and comes
    back through ``rx.device_get``, so it keeps its dtype both ways.  Spans,
    each around the guarded site of the same name (``{site_prefix}_...``):
    ``{site_prefix}.delta_sync``, ``{site_prefix}.ckpt_pull``,
    ``{site_prefix}.result_pull``, those of :func:`run_segments`, and the
    salvage's ``{site_prefix}.cpu_salvage``.  Runs on ``cuda`` unless
    ``device`` says otherwise.

    Returns ``(state_np, iterations, last_delta)``.
    """
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    state0 = init_state()
    state_dtype = state0.dtype
    start_iter = resume_state(cfg, metrics, state0) if resume else 0
    with Timer() as t_put:
        operands = build_operands(dev)
    metrics.record(event="put_graph", preprocess_secs=t_put.elapsed)
    state_dev = torch.from_numpy(state0).to(dev)

    def make_invoke(ops_tuple):
        def invoke(runner, rd):
            rd, iters, delta = call(runner, ops_tuple, rd)
            with obs.span(f"{site_prefix}.delta_sync"):
                delta = float(rx.device_get(
                    delta, site=f"{site_prefix}_delta_sync", metrics=metrics,
                    checkpoint_dir=cfg.checkpoint_dir,
                ))
            return rd, iters, delta

        return invoke

    def extract_np(rd) -> np.ndarray:
        with obs.span(f"{site_prefix}.ckpt_pull"):
            return rx.device_get(
                rd, site=f"{site_prefix}_ckpt_pull", metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )

    def cpu_salvage_exec(rerun_cfg, state_np):
        cpu_ops = build_operands(cpu)
        rd_cpu = torch.from_numpy(np.asarray(state_np).astype(state_dtype))
        runner = make_runner(rerun_cfg)
        rd2, iters, delta = call(runner, cpu_ops, rd_cpu)
        return rd2, int(iters), float(delta), make_invoke(cpu_ops)

    state_dev, done, last_delta = run_segments(
        cfg, metrics, state_dev, start_iter,
        make_runner=make_runner,
        invoke=make_invoke(operands),
        extract_np=extract_np,
        elastic_rebuild=make_cpu_salvage(
            cfg, metrics, site_prefix=site_prefix, init_state=init_state,
            cpu_exec=cpu_salvage_exec, make_runner=make_runner,
            extract_np=extract_np,
        ),
        site_prefix=site_prefix,
    )
    with obs.span(f"{site_prefix}.result_pull"):
        state_np = rx.device_get(
            state_dev, site=f"{site_prefix}_result_pull", metrics=metrics,
            checkpoint_dir=cfg.checkpoint_dir,
            fallbacks=[(None, make_pull_salvage(
                cfg, metrics, site_prefix=site_prefix,
                init_state=init_state, cpu_exec=cpu_salvage_exec,
                get_done=lambda: done,
            ))],
        )
    return state_np, done, last_delta
