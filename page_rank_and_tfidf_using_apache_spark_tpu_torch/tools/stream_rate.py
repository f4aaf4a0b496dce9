"""Streaming TF-IDF throughput of the config-5 stand-in (100,000 synthetic
documents of 180 tokens, bigrams, 512-document chunks packed to 2^18
tokens, the default pipeline, checkpointing off), for one or more
checkouts of the port, each in its own process, in the order given.

Naming the same checkouts in turn (``A B B A``) compares two versions
within one call on one card.  Each process builds the corpus, runs the
stream once untimed, then ``--reps`` timed runs, and prints one JSON line:
the checkout, the card's name and power limit, the tokens, chunks and
commit barriers of a run, and each run's seconds and tokens/s.

Usage::

    python page_rank_and_tfidf_using_apache_spark_tpu_torch/tools/stream_rate.py \\
        --trees PARENT_CHECKOUT . . PARENT_CHECKOUT [--reps 3] [--docs 100000]

A checkout is a directory that holds the port's package.  Runs on the
card; ``--device cpu`` (with a small ``--docs``) runs it on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CHUNK_DOCS, CHUNK_TOKENS, TOKENS, SEED, BITS = 512, 1 << 18, 180, 11, 18


def card() -> str:
    """``name, power limit`` as nvidia-smi gives them, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({type(exc).__name__})"


def worker(tree: str, reps: int, docs: int, device: str) -> dict:
    """The measurement, in this process, of the port under ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    lines = tio.synthetic_corpus_lines(docs, TOKENS, SEED)
    chunks = [lines[i:i + CHUNK_DOCS] for i in range(0, len(lines), CHUNK_DOCS)]
    cfg = tcfg.TfidfConfig(vocab_bits=BITS, chunk_tokens=CHUNK_TOKENS,
                           pack_target_tokens=CHUNK_TOKENS, ngram=2)
    tm.run_tfidf_streaming(iter(chunks), cfg, device=device)  # the allocators' first blocks
    secs, rates = [], []
    for _ in range(reps):
        m = MetricsRecorder()
        sink = obs.MemorySink()
        obs.bus().attach(sink)
        try:
            t0 = time.perf_counter()
            tm.run_tfidf_streaming(iter(chunks), cfg, metrics=m, device=device)
            s = time.perf_counter() - t0
        finally:
            obs.bus().detach(sink)
        tokens = sum(r["tokens"] for r in m.records if r.get("event") == "chunk")
        n_chunks = sum(1 for r in m.records if r.get("event") == "chunk")
        commits = sum(1 for e in sink.events if e["kind"] == "ingest_commit")
        secs.append(s)
        rates.append(tokens / s)
    return {"tree": tree, "card": card() if device != "cpu" else "cpu", "docs": docs,
            "tokens": tokens, "chunks": n_chunks, "commits": commits, "secs": secs,
            "tokens_per_s": rates}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.reps, args.docs, args.device)))
        return 0
    rc = 0
    for tree in args.trees:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--reps", str(args.reps), "--docs", str(args.docs), "--device", args.device],
            capture_output=True, text=True,
        )
        sys.stderr.write(done.stderr[-2000:])
        lines = done.stdout.strip().splitlines()
        print(lines[-1] if lines else json.dumps({"tree": tree, "rc": done.returncode}))
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
