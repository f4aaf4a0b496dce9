"""Serving CLI — the long-lived query process over a built index.  Runs on
``cuda`` unless ``--device`` says otherwise.

Usage::

    # build an index once
    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.tfidf \
        corpus.txt --lines --save-index /data/index

    # serve queries against it (one query per line, space-separated terms)
    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.serve \
        /data/index --queries queries.txt --top-k 10 [--scoring impacted]

With ``--queries -`` (the default) queries stream from stdin, so the
process can sit behind a pipe indefinitely — the index is mapped once,
its postings stay on the device, and every request rides the padded
micro-batch path.  A segmented index directory (delta segments under a
manifest, ``serving/segments.py``) serves its whole live set.  Output: one
``<query#>\t<doc>\t<score>`` line per hit; a summary JSON (stats and
latency percentiles) lands on stderr at exit.  With ``GRAFT_METRICS_PORT``
set, the process serves ``/snapshot.json`` and ``/metrics`` while it runs.

The flags are the JAX CLI's, plus ``--device``.  ``--tuned-profile`` is
accepted and refused: the command exits non-zero naming the ROADMAP item
that ports it; an unset knob takes its ``TUNABLE_DEFAULTS`` value.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
    ServeConfig,
    ServerShutdown,
    TfidfServer,
    load_index,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import percentile

# Flags of the JAX CLI whose paths are not ported yet: flag -> (what it
# needs, ROADMAP Queue 1 item).  Each defaults to None, so a given flag is
# one that is not None.
LATER_FLAGS = {
    "--tuned-profile": ("the tuned profile", 5),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve",
        description="Serve top-k TF-IDF queries from a built index, in PyTorch on one GPU.",
    )
    p.add_argument("index", help="index directory (serving.artifact layout)")
    p.add_argument("--version", type=int, default=None,
                   help="serve this index version (default: LATEST)")
    p.add_argument("--queries", default="-",
                   help="file of queries, one per line ('-' = stdin)")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--max-batch", type=int, default=None,
                   help="micro-batch cap (padded shapes are powers of two; "
                        "default: TUNABLE_DEFAULTS)")
    p.add_argument("--max-query-terms", type=int, default=16)
    p.add_argument("--cache-size", type=int, default=1024,
                   help="hot-query LRU entries (0 disables)")
    p.add_argument("--ranker", choices=["tfidf", "bm25", "prior"],
                   default="tfidf",
                   help="default scoring weights per request (the index "
                        "must bundle BM25 weights for bm25 — cli.tfidf "
                        "--save-index does by default; 'prior' blends the "
                        "index's PageRank prior per request, needs "
                        "--prior-alpha > 0).  A query line may override "
                        "per request with an '@tfidf '/'@bm25 '/'@prior ' "
                        "prefix — the A/B switch.")
    p.add_argument("--rank-alpha", type=float, default=0.0,
                   help="blend the index's PageRank prior into EVERY "
                        "request (score + alpha * rank; needs an index "
                        "built with ranks)")
    p.add_argument("--prior-alpha", type=float, default=0.0,
                   help="per-REQUEST PageRank-prior scale: enables the "
                        "'prior' ranker (@prior prefix) for exactly the "
                        "queries that opt in")
    p.add_argument("--scoring", choices=["coo", "impacted"], default="coo",
                   help="serving path: 'coo' scores every query batch "
                        "against the full postings; 'impacted' slices only "
                        "the batch's query terms' posting runs from the "
                        "CSC-by-term layout (equal results, work "
                        "proportional to the query, not the corpus)")
    p.add_argument("--impact-bucket-width", type=int, default=None,
                   help="fixed bucket width the impacted planner pads "
                        "posting runs to (default: TUNABLE_DEFAULTS)")
    p.add_argument("--no-mmap", action="store_true",
                   help="copy the index into RAM instead of mapping it")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda)")
    p.add_argument("--trace-dir", default=None,
                   help="obs run-telemetry dir (default: $GRAFT_TRACE_DIR)")
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
    with obs.run("serve", trace_dir=args.trace_dir):
        return _main(args)


def _main(args) -> int:
    # A segmented index directory (delta commits of the streaming ingest)
    # serves its whole live set — merged on the device; a plain artifact
    # directory serves its LATEST version.
    if args.version is None and sgm.manifest_version(args.index) is not None:
        index = sgm.load_segment_set(args.index, mmap=not args.no_mmap)
    else:
        index = load_index(args.index, version=args.version,
                           mmap=not args.no_mmap)
    # an unset knob takes the config's default (TUNABLE_DEFAULTS)
    knobs = {"max_batch": args.max_batch,
             "impact_bucket_width": args.impact_bucket_width}
    cfg = ServeConfig(
        top_k=args.top_k,
        max_query_terms=args.max_query_terms,
        cache_size=args.cache_size,
        rank_alpha=args.rank_alpha,
        prior_alpha=args.prior_alpha,
        scoring=args.scoring,
        **{k: v for k, v in knobs.items() if v is not None},
    )
    # Live SLO telemetry: with GRAFT_METRICS_PORT set, the serve process
    # exposes /snapshot.json + /metrics over the default hub (fed from the
    # bus's serve_request events) while it runs.
    exporter = obs.export.serve_metrics_from_env()
    if exporter is not None:
        print(json.dumps({"metrics_url": exporter.url}), file=sys.stderr, flush=True)
    source = sys.stdin if args.queries == "-" else open(args.queries)
    lat: list[float] = []
    shutdown = False

    # Graceful SIGTERM: raising from the handler aborts whatever blocking
    # read/wait the main thread is in (PEP 475 does not retry when the
    # handler raises), we stop accepting, drain every already-accepted
    # request, and the server's stop() fails anything left with the typed
    # ServerShutdown — a supervisor's TERM never hangs a piped client.
    def _on_sigterm(signum, frame):
        raise ServerShutdown("SIGTERM")

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        prev_sigterm = None  # not the main thread (tests drive _main directly)
    try:
        # stdin is request/response: a client writing one query and
        # waiting for output must get its answer before this process
        # reads the next line.  A query FILE is throughput mode: keep a
        # full batch in flight.
        interactive = source is sys.stdin
        with TfidfServer(index, cfg, device=args.device) as srv:
            pending = []
            try:
                for qid, line in enumerate(source):
                    terms = line.split()
                    if not terms:
                        continue
                    ranker = args.ranker
                    if terms[0] in ("@tfidf", "@bm25", "@prior"):  # per-request A/B
                        ranker = terms[0][1:]
                        terms = terms[1:]
                        if not terms:
                            continue
                    try:
                        pending.append((qid, srv.submit(terms, ranker=ranker)))
                    except ValueError as exc:
                        # one bad line (e.g. '@bm25' against an index without
                        # BM25 weights) must not kill the serve process —
                        # report it and keep draining the stream
                        print(f"query {qid}: {exc}", file=sys.stderr)
                        continue
                    if interactive:
                        while pending:
                            _drain_one(pending, lat)
                    else:
                        # drain in submit order: eagerly when already
                        # resolved, blocking only to bound the window
                        while pending and pending[0][1].done:
                            _drain_one(pending, lat)
                        while len(pending) > cfg.max_batch:
                            _drain_one(pending, lat)
            except ServerShutdown:
                shutdown = True
                obs.emit("serve_sigterm", pending=len(pending))
            # accepted requests drain to completion even on SIGTERM; any
            # future the stopping server failed surfaces typed, not hung
            while pending:
                try:
                    _drain_one(pending, lat)
                except ServerShutdown as exc:
                    print(f"shutdown: request failed: {exc}", file=sys.stderr)
            stats = srv.stats()
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if source is not sys.stdin:
            source.close()
        if exporter is not None:
            exporter.stop()
    stats["shutdown"] = "sigterm" if shutdown else None
    stats["p50_ms"], stats["p99_ms"] = _percentiles_ms(lat)
    print(json.dumps(stats), file=sys.stderr)
    return 0


def _drain_one(pending: list, lat: list[float]) -> None:
    qid, fut = pending.pop(0)
    scores, docs = fut.result()
    lat.append(fut.latency_s or 0.0)
    for s, d in zip(scores, docs):
        if float(s) > 0:
            print(f"{qid}\t{int(d)}\t{float(s):.10g}")
    # stdout is block-buffered behind a pipe; a request/response client
    # must see its answer now, not at process exit
    sys.stdout.flush()


def _percentiles_ms(lat: list[float]) -> tuple[float | None, float | None]:
    if not lat:
        return None, None
    xs = sorted(lat)
    return (round(percentile(xs, 0.50) * 1e3, 3),
            round(percentile(xs, 0.99) * 1e3, 3))


if __name__ == "__main__":
    sys.exit(main())
