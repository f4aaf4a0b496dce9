"""Sharded TF-IDF: data-parallel chunk ingest, one chunk a mesh slot, the
DF combined by one ``psum`` and the IDF computed once from it.

Counterpart of the JAX package's ``parallel/tfidf_sharded.py``.  Each slot
counts its own fixed-shape token chunk (documents never span chunks, so
per-chunk DF increments are exact) and one ``psum`` over the slots
combines the per-slot DF vectors: the DF ``reduceByKey``.  A "super-chunk"
is D chunks, one a slot, padded to one capacity.

The host loop is ``dataflow.ingest.chunked_ingest``, the staged pipeline of
the single-device stream: a tokenize thread feeds super-chunk groups, the
staging stage puts each slot's tokens on its device at the guarded
``ingest_h2d_put`` site, and the drain is one guarded pull a super-chunk
(``tfidf_shard_sync``), which is also its commit.  A lost slot anywhere in
the pipeline reaches one recovery point: the committed state is
checkpointed, the mesh is rebuilt over the surviving slots
(``elastic.plan_shrink``) and the in-flight groups are re-sliced over the
shrunk mesh from the host corpora the pipeline kept; committed chunks are
never reprocessed.  As on every rung of the port, only a loss that names
its slot is taken.

On a mesh whose slots span processes every process reads the whole chunk
stream and stages only its own slots' rows of each super-chunk; the DF
``psum`` and the drain gather every slot's counts onto each process, so
every process commits the same state and runs the second pass on its
first slot's device.  Process 0 writes the checkpoints; a loss raises on
every process, with no shrink.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ingest as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
    IngestState,
    TfidfOutput,
    _tokenized_chunks,
    finalize_tfidf,
    grow_chunk_cap,
    resume_ingest,
    save_ingest_checkpoint,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    first_process_writes,
    mesh_for,
    rebuild_mesh,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder


def _publish_device_timings(tensors: list, step: int) -> None:
    """Per-slot ready times of a super-chunk, for the trace's chunk
    timeline: each slot's device is waited on in slot order and the time
    since the call recorded (entry ``i`` is an upper bound where an earlier
    slot still ran; the max is exact).  Only under a traced run, and
    best-effort: any fault is left to the guarded pull that follows."""
    if obs.current_run() is None:
        return
    try:
        t0 = time.perf_counter()
        secs = []
        for t in tensors:
            if t.device.type == "cuda":
                torch.cuda.current_stream(t.device).synchronize()  # graftlint: disable=unguarded-host-sync,host-sync-in-loop (ROADMAP Queue 3, shared with the reference: per-shard fence for telemetry only; the guarded batched pull right after owns retry/deadline/degradation)
            secs.append(round(time.perf_counter() - t0, 6))
        obs.emit("device_timing", site="tfidf_super_chunk", step=step,
                 devices=len(secs), secs=secs)
    except Exception:  # noqa: BLE001 — telemetry never stops the ingest
        pass


def make_sharded_counts_kernel(mesh: Mesh, vocab: int):
    """``kernel(doc_ids, term_ids, valid)``: lists of ``[cap]`` tokens, one
    a local slot -> (per-slot ``ops.PaddedCounts``, the DF summed over all
    the slots on the first local slot's device)."""

    def kernel(doc_ids, term_ids, valid):
        counts = [ops.count_pairs(d, t, token_valid=v)
                  for d, t, v in zip(doc_ids, term_ids, valid)]
        df = coll.psum([ops.document_frequency(c, vocab) for c in counts], mesh=mesh)
        return counts, df[0]

    return kernel


def run_tfidf_sharded(
    doc_chunks: Iterable[Sequence[str]],
    cfg: TfidfConfig,
    *,
    n_devices: int | None = None,
    mesh: Mesh | None = None,
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> TfidfOutput:
    """Sharded counterpart of ``models.tfidf.run_tfidf_streaming``: the same
    chunk iterator, D chunks a step.  Checkpoints share the streaming
    path's format (``cfg.checkpoint_every`` counts input chunks), and
    ``resume=True`` skips the ingested prefix.  ``mesh`` defaults to
    ``n_devices`` visible cards; ``device="cpu"`` makes it ``n_devices``
    CPU slots.  The second pass runs on slot 0's device."""
    metrics = metrics or MetricsRecorder()
    if mesh is None:
        mesh = mesh_for(n_devices, DATA_AXIS, device)
    d = mesh.size
    axis = mesh.axis
    vocab = cfg.vocab_size

    cap = cfg.chunk_tokens
    kernel = make_sharded_counts_kernel(mesh, vocab)

    st = (resume_ingest(cfg, metrics) if resume
          else IngestState(df_total=np.zeros(vocab, np.float32)))
    last_ckpt = st.chunk_index
    secs0 = st.ingest_secs
    run_started = time.perf_counter()
    step = 0

    if cfg.pack_target_tokens > 0:
        doc_chunks = dflow.pack_doc_chunks(
            doc_chunks, cfg.pack_target_tokens,
            estimate=dflow.ngram_estimator(cfg.ngram))
    chunk_source = _tokenized_chunks(doc_chunks, cfg, st.chunk_index,
                                     st.n_docs)

    def grouped(src: Iterator) -> Iterator[list[tio.TokenizedCorpus]]:
        # one pipeline item = one super-chunk group of <= d corpora; ``d``
        # is read per group, so after a shrink the tail arrives re-sized
        buf: list[tio.TokenizedCorpus] = []
        for _, corpus in src:
            buf.append(corpus)
            if len(buf) >= d:
                yield buf
                buf = []
        if buf:
            yield buf

    def stage_group(group: list[tio.TokenizedCorpus]):
        """The H2D stage: the [D, cap] host arrays of one super-chunk, the
        local slots' rows each put on its slot's device through the guarded
        staging site.  The pipeline keeps the group's corpora until its
        drain commits them."""
        nonlocal cap
        need = max(c.n_tokens for c in group)
        cap, _ = grow_chunk_cap(need, cap, metrics)
        doc_ids = np.zeros((d, cap), np.int32)
        term_ids = np.zeros((d, cap), np.int32)
        valid = np.zeros((d, cap), bool)
        for i, c in enumerate(group):
            doc_ids[i, : c.n_tokens] = c.doc_ids
            term_ids[i, : c.n_tokens] = c.term_ids
            valid[i, : c.n_tokens] = True
        slots = mesh.slots
        local = mesh.positions

        def put():
            return tuple([torch.from_numpy(a[i]).to(slots[i].device, copy=True)
                          for i in local]
                         for a in (doc_ids, term_ids, valid))

        return group, dflow.staged_put(put, metrics=metrics)

    def launch_group(staged):
        nonlocal step
        group, (d_doc, d_term, d_valid) = staged
        t0 = time.perf_counter()
        counts, df = kernel(d_doc, d_term, d_valid)  # the pull waits in the drain
        rec = (group, step, counts, df, t0)
        step += 1
        return rec

    def drain_group(rec) -> None:
        group, step_i, counts, df, t0 = rec
        with obs.span("tfidf.super_chunk", step=step_i, chunk=st.chunk_index):
            _publish_device_timings([c.n_pairs for c in counts], step_i)
            # every slot's counts (gathered across processes), then one
            # batched pull a super-chunk; a transient fault re-pulls the
            # live tensors, a loss reaches the pipeline's recovery point
            every = [coll.gather_slots([getattr(c, f) for c in counts], mesh=mesh)
                     for f in ("doc", "term", "count", "n_pairs")]
            pulled, h_df = rx.device_get(
                (list(zip(*every)), df),
                site="tfidf_shard_sync", metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )
        st.df_total = st.df_total + h_df.astype(np.float32)
        for (h_doc, h_term, h_cnt, n_pairs), c in zip(pulled, group):
            k = int(n_pairs)
            # copies: parts hold k-sized arrays, not views of cap-sized ones
            st.parts.append((h_doc[:k].copy(), h_term[:k].copy(), h_cnt[:k].copy()))
            st.doc_length_parts.append(c.doc_lengths)
        st.n_docs += int(sum(c.n_docs for c in group))
        st.chunk_index += len(group)
        st.n_tokens += int(sum(c.n_tokens for c in group))
        metrics.record(
            event="super_chunk", step=step_i, devices=len(group),
            docs=st.n_docs, tokens=int(sum(c.n_tokens for c in group)),
            secs=time.perf_counter() - t0, processes=mesh.processes, backend=mesh.backend,
        )

    def checkpoint_due() -> bool:
        if not (cfg.checkpoint_every > 0 and cfg.checkpoint_dir):
            return False
        return st.chunk_index - last_ckpt >= cfg.checkpoint_every

    def save_ckpt() -> None:
        nonlocal last_ckpt
        st.ingest_secs = secs0 + (time.perf_counter() - run_started)
        first_process_writes(mesh, save_ingest_checkpoint, cfg, metrics, st,
                             extra_meta={"devices": d})
        last_ckpt = st.chunk_index

    def regrouped(remaining: Iterator) -> Iterator[list]:
        # re-slice: flatten the dying mesh's in-flight groups and regroup
        # them to the current width (a second shrink re-sizes again)
        return grouped((None, c) for group in remaining for c in group)

    def recover(exc, remaining, where):
        """The mesh-shrink recovery point: checkpoint the committed state
        first, rebuild the mesh over the surviving slots, and re-slice the
        in-flight groups over it.  A further loss in the replay re-enters
        here."""
        nonlocal mesh, d, kernel, last_ckpt
        if mesh.processes > 1:
            # no shrink across processes: every process raises at once (a
            # barrier for a last snapshot would wait on a dead peer)
            raise exc
        saved = None
        if cfg.checkpoint_dir and st.parts:
            st.ingest_secs = secs0 + (time.perf_counter() - run_started)
            save_ingest_checkpoint(cfg, metrics, st, extra_meta={"devices": d})
            last_ckpt = st.chunk_index
            saved = ckpt.latest_checkpoint(cfg.checkpoint_dir)

        def reraise():
            # hand the caller the freshest snapshot with the exhaustion
            if (saved is not None
                    and isinstance(exc, rx.ResilienceExhausted)
                    and exc.last_checkpoint is None):
                raise rx.ResilienceExhausted(
                    exc.site, exc.attempts, exc.last_error, saved
                ) from exc
            raise exc

        lost = elastic.unwrap_device_loss(exc)
        idx = elastic.device_index(lost) if lost is not None else None
        if not elastic.enabled() or idx is None:
            reraise()
        elastic.health().mark_lost(idx)
        plan = elastic.plan_shrink(list(mesh.slots))
        if plan is None:
            reraise()
        site = {"stage": dflow.H2D_PUT_SITE,
                "wait": dflow.H2D_WAIT_SITE}.get(where, "tfidf_shard_sync")
        with elastic.publish_shrink(site, plan, lost, metrics):
            # keep the dying mesh's axis name
            mesh = rebuild_mesh(plan.devices, axis)
            d = plan.new_count
            kernel = make_sharded_counts_kernel(mesh, vocab)
        return regrouped(remaining)

    with obs.span("tfidf.shard_stream", devices=d, resume_chunk=st.chunk_index):
        dflow.chunked_ingest(
            grouped(chunk_source),
            stage=stage_group,
            launch=launch_group,
            drain=drain_group,
            commit=lambda: None,  # the drain's pull is the commit: the DF
            # is psum'd and pulled a super-chunk, nothing stays on a slot
            ingest=cfg.ingest(),
            checkpoint_due=checkpoint_due,
            save_checkpoint=save_ckpt,
            recover=recover,
            metrics=metrics,
        )

    return finalize_tfidf(st, cfg, metrics, mesh.local_slots[0].device)
