"""TF-IDF CLI — the reference's ``spark-submit tfidf.py <corpus>`` entry
point, batch path.  Runs on ``cuda`` unless ``--device`` says otherwise.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.tfidf \
        corpus_dir --output weights.tsv --idf-mode classic
    python -m ...cli.tfidf corpus.txt --lines --query someword --top-k 3

The JAX package's flags for paths the port does not run yet (streaming,
checkpoints, the serving index, BM25, the mesh, the tuned profile,
tracing) are accepted and refused: the command exits non-zero naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.text import (
    fnv1a_64,
    hash_to_vocab,
    load_corpus_dir,
    load_corpus_lines,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.tfidf import TfidfResult, score_query
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

# Flags of the JAX CLI whose paths are not ported yet: flag -> (what it
# needs, ROADMAP Queue 1 item).  Each defaults to None, so a given flag is
# one that is not None.
LATER_FLAGS = {
    "--streaming": ("streaming ingest", 8),
    "--chunk-docs": ("streaming ingest", 8),
    "--chunk-tokens": ("streaming ingest", 8),
    "--prefetch": ("streaming ingest", 8),
    "--pipeline-depth": ("streaming ingest", 8),
    "--pack-target": ("streaming ingest", 8),
    "--checkpoint-dir": ("streaming checkpoints", 8),
    "--checkpoint-every": ("streaming checkpoints", 8),
    "--resume": ("streaming checkpoints", 8),
    "--save-index": ("the serving index", 9),
    "--index-ranks": ("the serving index", 9),
    "--no-index-bm25": ("BM25", 10),
    "--bm25-k1": ("BM25", 10),
    "--bm25-b": ("BM25", 10),
    "--mesh": ("multi-GPU ingest", 11),
    "--tuned-profile": ("the tuned profile", 5),
    "--profile-dir": ("tracing", 4),
    "--trace-dir": ("tracing", 4),
}
_SWITCHES = {"--streaming", "--resume", "--no-index-bm25"}


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
    p.add_argument("--query", nargs="+", default=None, metavar="TERM",
                   help="score docs against these terms, print top-k")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    p.add_argument("--metrics-json")
    later = p.add_argument_group("not ported yet (each exits non-zero naming its ROADMAP item)")
    for flag, (what, item) in LATER_FLAGS.items():
        help_ = f"{what}: ROADMAP Queue 1 item {item}"
        if flag in _SWITCHES:
            later.add_argument(flag, action="store_true", default=None, help=help_)
        else:
            later.add_argument(flag, default=None, metavar="VALUE", help=help_)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [f for f in LATER_FLAGS if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        parser.error("; ".join(f"{f} ({LATER_FLAGS[f][0]}) is not ported yet: "
                               f"ROADMAP Queue 1 item {LATER_FLAGS[f][1]}" for f in given))
    device = resolve_device(args.device)
    metrics = MetricsRecorder()

    docs, names = (load_corpus_lines if args.lines else load_corpus_dir)(args.input)
    cfg = TfidfConfig(
        vocab_bits=args.vocab_bits,
        ngram=args.ngram,
        tf_mode=args.tf_mode,
        idf_mode=args.idf_mode,
        l2_normalize=args.l2_normalize,
        min_token_len=args.min_token_len,
    )
    out = run_tfidf(docs, cfg, metrics=metrics, doc_names=names, device=device)

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
