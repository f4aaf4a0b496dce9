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
checkpoint format.  The reference's guarded sites (``rx.run_guarded``,
``rx.device_get``) are plain calls under the same site names until the
retry executor is ported (ROADMAP Queue 1 item 3); its CPU re-lowering and
elastic salvage rungs (``make_cpu_invoke``, ``elastic_rebuild``,
``ElasticResult``) wait for items 3 and 12, and passing either raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
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
    return carry if isinstance(carry, torch.Tensor) else carry[0]


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
        while it < iterations and float(delta) > tol:
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
    make_cpu_invoke: Callable | None = None,
    elastic_rebuild: Callable | None = None,
    site_prefix: str = "pagerank",
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
    ``utils/checkpoint.save_checkpoint`` as ``{"ranks": payload}``.  The
    reference's ``extra_metrics`` tag (a sharded runner's device count) has
    no single-device caller and is left out.  Each segment records
    ``iter``, ``l1_delta``, ``secs`` and ``iters_per_sec`` and each
    checkpoint a ``checkpoint`` event; the spans are ``{site_prefix}.segment`` and
    ``{site_prefix}.checkpoint``, the histogram
    ``{site_prefix}.segment_secs``.

    ``make_cpu_invoke`` and ``elastic_rebuild``, the reference's
    degradation rungs, are not ported: passing either raises.

    Returns ``(ranks_dev, done, last_delta)``.
    """
    if make_cpu_invoke is not None or elastic_rebuild is not None:
        raise NotImplementedError(
            "run_segments: the CPU re-lowering rung (make_cpu_invoke) and the "
            "elastic salvage rung (elastic_rebuild) are not ported: ROADMAP "
            "Queue 1 items 3 and 12"
        )
    segment = (
        cfg.checkpoint_every
        if (cfg.checkpoint_every > 0 and cfg.tol == 0.0 and segments_allowed)
        else cfg.iterations - start_iter
    )
    runners: dict[int, Callable] = {}
    done = start_iter
    last_delta = float("inf")
    while done < cfg.iterations:
        todo = min(segment, cfg.iterations - done)
        seg_cfg = dataclasses.replace(
            cfg, iterations=todo, checkpoint_every=0, checkpoint_dir=None
        )
        if todo not in runners:
            runners[todo] = make_runner(seg_cfg)
        with Timer() as t, obs.span(f"{site_prefix}.segment", start=done, todo=todo):
            # the reference's guarded site {site_prefix}_step
            ranks_dev, iters, delta = invoke(runners[todo], ranks_dev)
        done += int(iters)
        last_delta = float(delta)
        obs.histogram(f"{site_prefix}.segment_secs", t.elapsed)
        metrics.record(
            iter=done,
            l1_delta=last_delta,
            secs=t.elapsed,
            iters_per_sec=int(iters) / t.elapsed if t.elapsed > 0 else float("inf"),
        )
        if cfg.checkpoint_every > 0 and cfg.checkpoint_dir and done < cfg.iterations:
            with obs.span(f"{site_prefix}.checkpoint", iter=done):
                path = ckpt.save_checkpoint(
                    cfg.checkpoint_dir, done,
                    {"ranks": extract_np(ranks_dev)}, cfg.config_hash(),
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
    build_operands: Callable[[], tuple],
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
    - ``build_operands()`` builds the non-carry operands (graph layout,
      teleport matrix, ...) on ``device``, once;
    - ``call(runner, operands, carry)`` runs the runner in the workload's
      argument order and returns ``(carry, iters, delta)`` with the delta
      a 0-d tensor.

    The carry goes up with ``torch.from_numpy(...).to(device)`` and comes
    back with ``.cpu().numpy()``, so it keeps its dtype both ways.  Spans:
    ``{site_prefix}.delta_sync``, ``{site_prefix}.ckpt_pull``,
    ``{site_prefix}.result_pull``, and those of :func:`run_segments`.
    Runs on ``cuda`` unless ``device`` says otherwise.

    Returns ``(state_np, iterations, last_delta)``.
    """
    dev = resolve_device(device)
    state0 = init_state()
    start_iter = resume_state(cfg, metrics, state0) if resume else 0
    with Timer() as t_put:
        operands = build_operands()
    metrics.record(event="put_graph", preprocess_secs=t_put.elapsed)
    state_dev = torch.from_numpy(state0).to(dev)

    def invoke(runner, rd):
        rd, iters, delta = call(runner, operands, rd)
        with obs.span(f"{site_prefix}.delta_sync"):
            # the reference's guarded site {site_prefix}_delta_sync
            delta = float(delta)
        return rd, iters, delta

    def extract_np(rd) -> np.ndarray:
        with obs.span(f"{site_prefix}.ckpt_pull"):
            return rd.cpu().numpy()

    state_dev, done, last_delta = run_segments(
        cfg, metrics, state_dev, start_iter,
        make_runner=make_runner, invoke=invoke, extract_np=extract_np,
        site_prefix=site_prefix,
    )
    with obs.span(f"{site_prefix}.result_pull"):
        state_np = state_dev.cpu().numpy()
    return state_np, done, last_delta
