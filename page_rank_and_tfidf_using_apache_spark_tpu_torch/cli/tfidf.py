"""TF-IDF CLI — the reference's ``spark-submit tfidf.py <corpus>`` entry
point.  Runs on ``cuda`` unless ``--device`` says otherwise.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.tfidf \
        corpus_dir --output weights.tsv --idf-mode classic
    python -m ...cli.tfidf corpus.txt --lines --query someword --top-k 3
    python -m ...cli.tfidf corpus.txt --lines --streaming --chunk-docs 1000 \
        --checkpoint-dir ck --checkpoint-every 4 [--resume] --save-index idx

The flags and defaults are the JAX CLI's.  An unset knob resolves through
the tuned profile of the device's backend (``--tuned-profile``, else
``$GRAFT_TUNED_PROFILE``, else the port's committed
``tuned_profile_<backend>.json``; ``off`` disables it), then
``TUNABLE_DEFAULTS``.  Its flag for a path the port does not run yet (the
mesh) is accepted and refused: the command exits non-zero naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.text import (
    fnv1a_64,
    hash_to_vocab,
    iter_corpus_chunks,
    iter_corpus_dir,
    iter_corpus_lines,
    load_corpus_dir,
    load_corpus_lines,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
    resume_point,
    run_tfidf,
    run_tfidf_streaming,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import manifest
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.tfidf import TfidfResult, score_query
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import save_index
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    TfidfConfig,
    tuned_config,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
    backend_name,
    resolve_device,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.profiling import trace

# Flags of the JAX CLI whose paths are not ported yet: flag -> (what it
# needs, ROADMAP Queue 1 item).  Each defaults to None, so a given flag is
# one that is not None.
LATER_FLAGS = {
    "--mesh": ("multi-GPU ingest", 11),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tfidf",
        description="TF-IDF over a text corpus (hashed vocabulary), in PyTorch on one GPU.",
    )
    p.add_argument("input", help="corpus directory (one doc per file) or flat file")
    p.add_argument("--lines", action="store_true",
                   help="input is a flat file with one document per line")
    p.add_argument("--output", help="write '<doc>\\t<term_id>\\t<weight>' lines here")
    p.add_argument("--vocab-bits", type=int, default=18)
    p.add_argument("--ngram", type=int, choices=[1, 2], default=1)
    p.add_argument("--tf-mode", choices=["raw", "freq", "lognorm"], default="raw")
    p.add_argument("--idf-mode", choices=["classic", "mllib", "smooth"], default="classic")
    p.add_argument("--l2-normalize", action="store_true")
    p.add_argument("--min-token-len", type=int, default=1)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--chunk-docs", type=int, default=1024,
                   help="docs per streaming chunk")
    p.add_argument("--chunk-tokens", type=int, default=0,
                   help="fixed token capacity per chunk (0 = auto)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="chunks between checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--prefetch", type=int, default=None,
                   help="tokenized chunks the tokenizer thread may run ahead, "
                        "and launches in flight (0 = serial; default: "
                        "tuned profile, then TUNABLE_DEFAULTS)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="H2D-staged chunks the transfer thread may hold: "
                        "chunk N+1's copy runs under chunk N's compute "
                        "(0 = stage inline; default: tuned profile, then "
                        "TUNABLE_DEFAULTS)")
    p.add_argument("--pack-target", type=int, default=None, metavar="TOKENS",
                   help="re-pack incoming chunks to ~TOKENS tokens each "
                        "before padding (0 = keep the source chunking; a "
                        "resume must use the same value; default: tuned "
                        "profile, then TUNABLE_DEFAULTS)")
    p.add_argument("--tuned-profile", default=None, metavar="PATH",
                   help="tuned-profile artifact to resolve unset knobs "
                        "from ('off' disables profile loading; default: "
                        "$GRAFT_TUNED_PROFILE, then the port's committed "
                        "tuned_profile_<backend>.json)")
    p.add_argument("--save-index", default=None, metavar="DIR",
                   help="write the result as the next servable index "
                        "version under DIR (serving/artifact.py)")
    p.add_argument("--index-ranks", default=None, metavar="NPY",
                   help="with --save-index: bundle this [n_docs] PageRank "
                        "prior (.npy) into the index")
    p.add_argument("--no-index-bm25", action="store_true",
                   help="with --save-index: skip the BM25 weights (bundled "
                        "by default: same postings, another weighting)")
    p.add_argument("--bm25-k1", type=float, default=1.5,
                   help="BM25 k1 (term-frequency saturation; default 1.5)")
    p.add_argument("--bm25-b", type=float, default=0.75,
                   help="BM25 b (length normalization; default 0.75)")
    p.add_argument("--query", nargs="+", default=None, metavar="TERM",
                   help="score docs against these terms, print top-k")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    p.add_argument("--metrics-json")
    p.add_argument("--profile-dir",
                   help="torch.profiler Chrome trace output dir (host and card)")
    p.add_argument("--trace-dir", default=None,
                   help="obs run-telemetry dir: write <name>.<pid>.trace.jsonl"
                        " + manifest here (default: $GRAFT_TRACE_DIR)")
    later = p.add_argument_group("not ported yet (each exits non-zero naming its ROADMAP item)")
    for flag, (what, item) in LATER_FLAGS.items():
        later.add_argument(flag, default=None, metavar="VALUE",
                           help=f"{what}: ROADMAP Queue 1 item {item}")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [f for f in LATER_FLAGS if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        parser.error("; ".join(f"{f} ({LATER_FLAGS[f][0]}) is not ported yet: "
                               f"ROADMAP Queue 1 item {LATER_FLAGS[f][1]}" for f in given))
    # The traced run covers the whole command (no-op without
    # --trace-dir/GRAFT_TRACE_DIR), as in the pagerank CLI.
    # knob resolution ladder: explicit flag > tuned profile of the
    # requested device's backend (same-backend only, ProvenanceError
    # otherwise) > TUNABLE_DEFAULTS; the manifest records the profile, or
    # why it was refused
    profile, snapshot, refused = manifest.resolve_tuned_profile(
        backend_name(args.device), args.tuned_profile)
    with manifest.recording_profile(snapshot), obs.run("tfidf", trace_dir=args.trace_dir):
        if refused is not None:
            raise refused
        return _main(args, profile)


def _main(args, profile) -> int:
    device = resolve_device(args.device)
    metrics = MetricsRecorder()

    if args.streaming:
        # lazy iteration: the corpus never materializes on the host
        docs = (iter_corpus_lines if args.lines else iter_corpus_dir)(args.input)
        names: list[str] = []
    else:
        docs, names = (load_corpus_lines if args.lines else load_corpus_dir)(args.input)
    cfg = tuned_config(
        TfidfConfig, profile,
        vocab_bits=args.vocab_bits,
        ngram=args.ngram,
        tf_mode=args.tf_mode,
        idf_mode=args.idf_mode,
        l2_normalize=args.l2_normalize,
        min_token_len=args.min_token_len,
        chunk_tokens=args.chunk_tokens,
        prefetch=args.prefetch,
        pipeline_depth=args.pipeline_depth,
        pack_target_tokens=args.pack_target,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )
    # On resume, probe the checkpoint for the restart chunk so the chunker
    # never reads the ingested prefix into memory; its document count rides
    # along, so a changed --chunk-docs raises instead of skipping the
    # wrong documents.  Under a pack target (a flag or a tuned profile) the
    # checkpoint counts re-packed chunks, not the chunker's: the prefix is
    # read again, re-packed the same way, and skipped after packing (the
    # JAX CLI skips source chunks here and refuses the resume).
    skip, skip_docs = 0, None
    if args.streaming and args.resume and not cfg.pack_target_tokens:
        skip = resume_point(cfg)
        if skip:
            meta = ckpt.peek_meta(ckpt.latest_checkpoint(cfg.checkpoint_dir))
            skip_docs = int(meta["extra"]["n_docs"])
    with trace(args.profile_dir):
        if args.streaming:
            out = run_tfidf_streaming(
                iter_corpus_chunks(docs, args.chunk_docs, skip_chunks=skip,
                                   expect_skipped_docs=skip_docs),
                cfg, metrics=metrics, resume=args.resume, device=device,
            )
        else:
            out = run_tfidf(docs, cfg, metrics=metrics, doc_names=names, device=device)

    if args.save_index:
        ranks = np.load(args.index_ranks) if args.index_ranks else None
        bm25 = (None if args.no_index_bm25 or out.count is None
                else Bm25Config(k1=args.bm25_k1, b=args.bm25_b))
        path = save_index(args.save_index, out, cfg, ranks=ranks, bm25=bm25)
        print(json.dumps({"index": path, "bm25": bm25 is not None}), file=sys.stderr)

    if args.output:
        with open(args.output, "w") as f:
            for d, t, w in zip(out.doc, out.term, out.weight):
                f.write(f"{names[d] if d < len(names) else d}\t{t}\t{w:.10g}\n")

    if args.query:
        q = np.zeros(cfg.vocab_size, np.float32)
        terms = [t.lower() if cfg.lowercase else t for t in args.query]
        q[hash_to_vocab(fnv1a_64(terms), cfg.vocab_bits)] = 1.0
        res = TfidfResult(
            doc=torch.from_numpy(out.doc).to(device), term=torch.from_numpy(out.term).to(device),
            weight=torch.from_numpy(out.weight).to(device),
            idf=torch.from_numpy(out.idf).to(device), df=torch.from_numpy(out.df).to(device),
        )
        k = min(args.top_k, max(out.n_docs, 1))
        scores, idx = score_query(res, torch.from_numpy(q).to(device),
                                  n_docs=max(out.n_docs, 1), k=k)
        for s, i in zip(scores.tolist(), idx.tolist()):
            if s > 0:
                print(f"{names[i] if i < len(names) else i}\t{s:.10g}")

    print(json.dumps({"docs": out.n_docs, "nnz": out.nnz}), file=sys.stderr)
    if args.metrics_json:
        metrics.dump(args.metrics_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
