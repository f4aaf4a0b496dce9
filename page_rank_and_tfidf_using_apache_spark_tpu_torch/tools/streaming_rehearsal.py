"""The Wikipedia-scale streaming-ingest rehearsal, on the port: the
counterpart of the JAX package's ``tools/streaming_rehearsal.py``
(BASELINE.json:11).  It pushes 1,000,000 small synthetic documents through
``models/tfidf.run_tfidf_streaming`` with checkpoints on, and records the
wall time, tokens/s, peak host RSS and the speedup of pipelined over serial
ingest.

The corpus is the reference's: :func:`synth_chunks` is a copy of its
generator (numpy only), Zipf(1.4) unigrams over a 50K-word pool, made
lazily chunk by chunk and hashed with bigrams, as the Wikipedia config's
bigram vocabulary.  The runs are the reference's three: serial and
pipelined ingest at 1/8 scale after an untimed serial warm-up, then the
full run, pipelined, with a checkpoint every ``--checkpoint-every`` chunks
into a temporary directory.  The two 1/8-scale runs must give the same
bits (the COO, the counts, DF, IDF and the weights; every depth of the
streaming path does): the tool exits 1, naming the arrays that differ,
before the full run where they do not.  :func:`corpus_tokens` counts the
tokens the generator's corpus holds, on the host.

Usage, from the repository root::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.streaming_rehearsal \\
        [--docs 1000000] [--device cuda|cpu] [--out FILE]

It runs on ``cuda`` unless given ``--device cpu`` and prints one JSON line
with the reference's keys, stamped with the backend (``"gpu"`` on the card),
the card's name and its power limit.  It writes a file only under ``--out``,
and refuses the repository's root ``rehearsal_metrics.json``, which is the
JAX package's record.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import tempfile
import time

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import tools
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.chaos_scenarios import REPO

VOCAB_WORDS = 50_000
# the JAX package's record of its own rehearsal, which this tool never writes
REFERENCE_RECORD = os.path.join(REPO, "rehearsal_metrics.json")


def synth_chunks(n_docs: int, docs_per_chunk: int, tokens_per_doc: int, seed: int):
    """Lazy synthetic corpus: Zipf unigrams over a 50K-word pool."""
    rng = np.random.default_rng(seed)
    words = np.char.add("w", np.arange(VOCAB_WORDS).astype("U6"))
    emitted = 0
    while emitted < n_docs:
        m = min(docs_per_chunk, n_docs - emitted)
        lens = np.maximum(rng.poisson(tokens_per_doc, m), 3).astype(np.int64)
        ids = rng.zipf(1.4, int(lens.sum())) % VOCAB_WORDS
        toks = words[ids]
        docs, pos = [], 0
        for ln in lens:
            docs.append(" ".join(toks[pos:pos + ln]))
            pos += ln
        yield docs
        emitted += m


def corpus_tokens(n_docs: int, docs_per_chunk: int, tokens_per_doc: int, seed: int,
                  ngram: int) -> int:
    """The tokens of the generator's corpus, counted on the host: a
    document of ``L`` words holds ``L - k + 1`` ``k``-grams for each ``k``
    up to ``ngram``."""
    total = 0
    for docs in synth_chunks(n_docs, docs_per_chunk, tokens_per_doc, seed):
        words = np.array([len(d.split()) for d in docs], dtype=np.int64)
        total += int(sum(np.maximum(words - k + 1, 0).sum() for k in range(1, ngram + 1)))
    return total


def differing_arrays(a, b) -> list:
    """The arrays of two ``TfidfOutput`` s whose bits differ."""
    return [f for f in ("doc", "term", "count", "weight", "df", "idf")
            if getattr(a, f).tobytes() != getattr(b, f).tobytes()]


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run_once(cfg, n_docs: int, docs_per_chunk: int, tokens_per_doc: int, seed: int,
             device):
    """One streaming run over the corpus: ``(out, timing, tokens, metrics)``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        run_tfidf_streaming,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    metrics = MetricsRecorder()
    t0 = time.perf_counter()
    out = run_tfidf_streaming(
        synth_chunks(n_docs, docs_per_chunk, tokens_per_doc, seed),
        cfg, metrics=metrics, device=device,
    )
    secs = time.perf_counter() - t0
    chunk_recs = [r for r in metrics.records if r.get("event") == "chunk"]
    tokens = sum(r["tokens"] for r in chunk_recs)
    fin = next((r for r in metrics.records if r.get("event") == "finalize"), None)
    timing = {
        "wall_secs": secs,
        # ingest only: the finalize pass is the same at every prefetch
        # depth, so serial-vs-pipelined ratios leave it out
        "ingest_secs": secs - (float(fin["secs"]) if fin else 0.0),
        "finalize_secs": float(fin["secs"]) if fin else 0.0,
        # per-chunk drain (device->host sync) and dispatch time
        "chunk_sync_secs": sum(float(r.get("secs", 0.0)) for r in chunk_recs),
        "chunk_dispatch_secs": sum(float(r.get("dispatch_secs", 0.0)) for r in chunk_recs),
    }
    return out, timing, tokens, metrics


def rehearse(args, device) -> dict:
    """The reference's three runs; returns the record, with the reference's
    keys.  Raises ``AssertionError`` where the 1/8-scale serial and
    pipelined runs differ in any bit."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig

    gen = (args.docs_per_chunk, args.tokens_per_doc, args.seed, device)
    with tempfile.TemporaryDirectory(prefix="rehearsal_ck_") as ckdir:
        base = dict(vocab_bits=args.vocab_bits, ngram=args.ngram, tf_mode="freq",
                    idf_mode="smooth", l2_normalize=True, chunk_tokens=1 << 19)
        # serial against pipelined at 1/8 scale, same generator seed, after
        # an untimed serial warm-up
        small = max(args.docs // 8, 1)
        run_once(TfidfConfig(**base, prefetch=0), small, *gen)
        serial, serial_t, small_tokens, _ = run_once(TfidfConfig(**base, prefetch=0),
                                                     small, *gen)
        pipelined, pipe_t, _, _ = run_once(TfidfConfig(**base, prefetch=2), small, *gen)
        differ = differing_arrays(serial, pipelined)
        if differ:
            raise AssertionError(f"1/8 scale: serial and pipelined ingest differ in {differ}")

        # the full rehearsal: checkpoints on, pipelined
        cfg = TfidfConfig(**base, prefetch=2, checkpoint_every=args.checkpoint_every,
                          checkpoint_dir=ckdir)
        out, full_t, tokens, metrics = run_once(cfg, args.docs, *gen)
        n_ckpts = sum(1 for r in metrics.records if r.get("event") == "checkpoint")

    secs = full_t["wall_secs"]
    record = {
        "n_docs": out.n_docs,
        "n_tokens": int(tokens),
        "nnz": out.nnz,
        "wall_secs": round(secs, 2),
        "ingest_secs": round(full_t["ingest_secs"], 2),
        "finalize_secs": round(full_t["finalize_secs"], 2),
        "chunk_sync_secs_total": round(full_t["chunk_sync_secs"], 2),
        "chunk_dispatch_secs_total": round(full_t["chunk_dispatch_secs"], 2),
        "tokens_per_sec": round(tokens / secs),
        "tokens_per_sec_ingest": round(tokens / max(full_t["ingest_secs"], 1e-9)),
        "peak_rss_mb": round(peak_rss_mb(), 1),
        "checkpoints_written": n_ckpts,
        # ingest-only ratio, finalize left out on both sides
        "pipeline_speedup_vs_serial": round(
            serial_t["ingest_secs"] / max(pipe_t["ingest_secs"], 1e-9), 3),
        "serial_ingest_secs_eighth_scale": round(serial_t["ingest_secs"], 2),
        "pipelined_ingest_secs_eighth_scale": round(pipe_t["ingest_secs"], 2),
        "serial_secs_eighth_scale": round(serial_t["wall_secs"], 2),
        "pipelined_secs_eighth_scale": round(pipe_t["wall_secs"], 2),
        "small_scale_tokens": int(small_tokens),
        "finalize": next((r for r in metrics.records if r.get("event") == "finalize"), None),
    }
    return record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="streaming_rehearsal",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--docs-per-chunk", type=int, default=8192)
    ap.add_argument("--tokens-per-doc", type=int, default=12)
    ap.add_argument("--vocab-bits", type=int, default=18)
    ap.add_argument("--ngram", type=int, default=2,
                    help="2 = uni+bigram (the Wikipedia config)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--checkpoint-every", type=int, default=32)
    tools.add_common_args(ap)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.out and os.path.abspath(args.out) == REFERENCE_RECORD:
        print(f"REFUSED: {args.out} is the JAX package's rehearsal record; "
              "write the port's elsewhere", file=sys.stderr)
        return 3
    started = tools.start(args)
    if started is None:
        return 3
    device, backend, stamp = started
    try:
        record = rehearse(args, device)
    except AssertionError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    return tools.emit(args, record, backend, stamp)


if __name__ == "__main__":
    sys.exit(main())
