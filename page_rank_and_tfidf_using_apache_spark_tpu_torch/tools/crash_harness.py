"""Crash-consistency harness: SIGKILL a committing process at every write
boundary and prove reload always serves a consistent generation.

Counterpart of the JAX package's ``tools/crash_harness.py``: the same four
scenarios and kill discipline over the port's own ``serving/segments.py``,
``utils/checkpoint.py`` and ``serving/fabric.commit_floor``.  It is a
filesystem protocol: the workers run on the CPU and touch no device.
``tests/test_torch_fabric.py`` holds its boundary counts to the
reference's.

The harness replays the real segment commit protocols with a SIGKILL
delivered at each write boundary (renames and deletions, the
reader-visible filesystem mutations) and asserts the crash-window
contract:

- the segmented index **reloads** after every kill (no torn manifest, no
  dangling pointer);
- the reloaded set serves **byte-identically** to either the pre-kill
  generation or the committed post-kill generation — never a mix, never
  a torn set (checked as a content hash over everything serving reads:
  per-segment postings, re-weighted tables, doc ranges, global DF, and
  the generation floor);
- a post-recovery ``serving.segments.gc_orphans`` pass deletes every
  orphan the kill left behind (tmp files, half-staged dirs, sealed-but-
  unnamed segments, unflipped manifests) and a second pass finds zero.

Scenarios:

- ``append``   — seal a delta segment + ``commit_append`` (the streaming
                 ingest commit path)
- ``replace``  — ``commit_replace`` of a pre-sealed merged segment,
                 including the generation-deferred GC deletes
- ``merge``    — a full ``SegmentMerger.merge_once`` tick (merge + seal +
                 commit_replace)
- ``floor``    — the serving fabric's generation-floor commit
                 (``serving.fabric.commit_floor``: the rolling-restart
                 barrier no replica may serve below).  A single-rename
                 protocol BY DESIGN — one staged tmp + ``durable_replace``
                 — so its probe is allowed exactly one boundary: the
                 harness proves a kill at that boundary leaves the OLD
                 floor serving, never a torn floor file.

The kill mechanism patches ``os.replace`` / ``os.unlink`` /
``shutil.rmtree`` in the child to deliver ``SIGKILL`` *before* the N-th
mutation executes, so every inter-syscall crash window is visited; a
probe run first counts the boundaries.

Usage (from the repository root)::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.crash_harness
    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.crash_harness \
        --scenarios append --max-kills 3
    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.crash_harness --json

Exit 0: every kill point survived.  Exit 1: a torn state, a reload
failure, or a leftover orphan.  The parent is stdlib-only; workers import
the package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

_SCENARIOS = ("append", "replace", "merge", "floor")

# Write-boundary floor per scenario probe: every manifest commit protocol
# spans multiple reader-visible mutations, but the generation-floor
# commit is one atomic rename by design — that atomicity is the property
# under test, not a shrunken protocol.
_MIN_BOUNDARIES = {"floor": 1}


# ===========================================================================
# worker side (runs in a child process; imports the package)
# ===========================================================================


# The repository root (the package's parent): workers run as ``python -m``
# from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_MODULE = "page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.crash_harness"


def _worker_env_guard() -> None:
    # determinism: no chaos plan, no tracing
    for k in ("GRAFT_CHAOS", "GRAFT_TRACE_DIR"):
        os.environ.pop(k, None)


def _mk_output(n_docs: int, vocab_bits: int, seed: int, terms_per_doc: int = 3):
    """A tiny synthetic TfidfOutput (unique terms per doc, raw counts +
    doc lengths) — enough for seal/commit/merge/load without touching a
    device."""
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        TfidfOutput,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.segments import (
        _host_idf,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import IdfMode
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import (
        MetricsRecorder,
    )

    rng = np.random.default_rng(seed)
    vocab = 1 << vocab_bits
    doc = np.repeat(np.arange(n_docs, dtype=np.int32), terms_per_doc)
    term = np.concatenate([
        np.sort(rng.permutation(vocab)[:terms_per_doc].astype(np.int32))
        for _ in range(n_docs)
    ])
    order = np.lexsort((doc, term))
    doc, term = doc[order], term[order]
    count = rng.integers(1, 5, size=doc.shape[0]).astype(np.float32)
    doc_lengths = np.zeros(n_docs, np.int32)
    np.add.at(doc_lengths, doc, count.astype(np.int32))
    df = np.bincount(term, minlength=vocab).astype(np.float32)
    idf = _host_idf(df, n_docs, IdfMode.SMOOTH, np.dtype(np.float32))
    return TfidfOutput(
        n_docs=n_docs, vocab_bits=vocab_bits, doc=doc, term=term,
        weight=count.copy(), df=df, idf=idf, metrics=MetricsRecorder(),
        count=count, doc_lengths=doc_lengths,
    )


def _cfg():
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        TfidfConfig,
    )

    return TfidfConfig(vocab_bits=6)


def _state_path(base: str) -> str:
    return os.path.join(base, "state.json")


def _idx(base: str) -> str:
    return os.path.join(base, "idx")


def worker_setup(base: str, scenario: str) -> int:
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
        segments as sgm,
    )

    cfg = _cfg()
    d = _idx(base)
    state: dict = {"scenario": scenario, "config_hash": cfg.config_hash()}
    refs = []
    doc_base = 0
    n_segs = 1 if scenario == "append" else 3
    for i in range(n_segs):
        out = _mk_output(4, cfg.vocab_bits, seed=100 + i)
        ref = sgm.seal_segment(d, out, cfg, doc_base=doc_base, bm25=None)
        sgm.commit_append(d, ref, cfg.config_hash())
        refs.append(ref)
        doc_base += out.n_docs
    state["doc_base"] = doc_base
    if scenario == "floor":
        # a replica restarted mid-rolling-swap reads THIS file to decide
        # what it may serve; the op advances it to the next generation
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            fabric as fab,
        )

        fab.commit_floor(d, 1)
    if scenario in ("replace", "merge"):
        # one COMMITTED merge so the op-window commit_replace carries
        # generation-deferred deletes (it GCs what THIS commit replaced)
        ab = sgm.merge_segments(d, (refs[0], refs[1]), cfg)
        sgm.commit_replace(d, (refs[0].name, refs[1].name), ab)
        if scenario == "replace":
            # pre-seal the next merged segment so the op is ONLY the
            # commit_replace protocol
            abc = sgm.merge_segments(d, (ab, refs[2]), cfg)
            state["merged_ref"] = abc.to_json()
            state["old_names"] = [ab.name, refs[2].name]
    with open(_state_path(base), "w") as f:
        json.dump(state, f)
    print(json.dumps({"setup": scenario, "segments": n_segs}))
    return 0


def _arm_kill(kill_at: int) -> dict:
    """Patch the reader-visible mutation syscalls to SIGKILL this process
    right BEFORE the ``kill_at``-th one executes (-1 = never: count only)."""
    counter = {"n": 0}

    def wrap(orig):
        def inner(*args, **kwargs):
            if counter["n"] == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
            counter["n"] += 1
            return orig(*args, **kwargs)

        return inner

    os.replace = wrap(os.replace)
    os.unlink = wrap(os.unlink)
    shutil.rmtree = wrap(shutil.rmtree)
    return counter


def worker_op(base: str, scenario: str, kill_at: int) -> int:
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
        segments as sgm,
    )

    cfg = _cfg()
    d = _idx(base)
    with open(_state_path(base)) as f:
        state = json.load(f)
    counter = _arm_kill(kill_at)
    if scenario == "append":
        out = _mk_output(4, cfg.vocab_bits, seed=777)
        ref = sgm.seal_segment(d, out, cfg, doc_base=state["doc_base"],
                               bm25=None)
        sgm.commit_append(d, ref, state["config_hash"])
    elif scenario == "replace":
        ref = sgm.SegmentRef.from_json(state["merged_ref"])
        sgm.commit_replace(d, tuple(state["old_names"]), ref)
    elif scenario == "merge":
        merger = sgm.SegmentMerger(d, cfg, max_segments=1)
        if not merger.merge_once():
            print("merge_once found nothing to merge", file=sys.stderr)
            return 1
    elif scenario == "floor":
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            fabric as fab,
        )

        fab.commit_floor(d, 2)
    else:
        print(f"unknown scenario {scenario}", file=sys.stderr)
        return 1
    print(json.dumps({"boundaries": counter["n"]}))
    return 0


def _scan_orphans(d: str) -> list[str]:
    """Independent re-scan (same rules as gc_orphans) — what a clean
    recovery must leave behind: nothing."""
    import re

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
        segments as sgm,
    )

    manifest_re = re.compile(r"^manifest_(\d{6})\.json$")
    cur = sgm.latest_manifest(d)
    keep = set()
    cur_version = 0
    if cur is not None:
        cur_version = cur.version
        keep = {s.name for s in cur.segments}
        keep |= set(sgm._replaced_by(d, cur.version))
    bad = []
    for n in sorted(os.listdir(d)):
        if n.endswith(".tmp"):
            bad.append(n)
        elif (m := manifest_re.match(n)) and int(m.group(1)) > cur_version:
            bad.append(n)
    seg_root = os.path.join(d, sgm.SEGMENTS_SUBDIR)
    if os.path.isdir(seg_root):
        for n in sorted(os.listdir(seg_root)):
            p = os.path.join(seg_root, n)
            if n.endswith(".tmp") or n.startswith("."):
                bad.append(f"segments/{n}")
            elif os.path.isdir(p) and n not in keep:
                bad.append(f"segments/{n}")
    return bad


def worker_verify(base: str) -> int:
    """Reload, hash everything serving reads, GC orphans, assert a second
    sweep finds none.  Prints {"hash", "version", "gc_deleted"}."""
    import hashlib

    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
        segments as sgm,
    )

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
        fabric as fab,
    )

    d = _idx(base)
    segset = sgm.load_segment_set(d)  # must ALWAYS load: torn set = crash
    h = hashlib.sha256()
    # the generation floor is part of what serving reads (a replica below
    # it refuses queries): a kill around the floor commit must leave the
    # old floor or the new floor in the hash, never anything else —
    # read_floor maps a missing/unparseable file to 0, so torn JSON would
    # show up as a third hash and fail the pre-or-post check
    h.update(str(fab.read_floor(d)).encode())
    h.update(str(segset.n_docs).encode())
    h.update(np.ascontiguousarray(segset.df_global).tobytes())
    for seg in segset.segments:
        h.update(f"{seg.ref.doc_base}:{seg.ref.n_docs}".encode())
        h.update(np.ascontiguousarray(seg.index.doc).tobytes())
        h.update(np.ascontiguousarray(seg.index.term).tobytes())
        for ranker in sorted(seg.weights):
            h.update(ranker.encode())
            h.update(np.ascontiguousarray(seg.weights[ranker]).tobytes())
        if seg.term_offsets is not None:
            h.update(np.ascontiguousarray(seg.term_offsets).tobytes())
    deleted: list = []
    if os.environ.get("CRASH_HARNESS_VERIFY_GC", "1") != "0":
        # post-kill recovery: GC the crash debris, then prove a second
        # sweep (and an independent re-scan) find nothing left
        # min_age_s=0: post-kill there is no writer left — every orphan
        # is crash debris regardless of how fresh its mtime is
        deleted = sgm.gc_orphans(d, min_age_s=0)
        second = sgm.gc_orphans(d, min_age_s=0)
        leftovers = _scan_orphans(d)
        if second or leftovers:
            print(f"orphans survived recovery GC: {second or leftovers}",
                  file=sys.stderr)
            return 1
        reloaded = sgm.load_segment_set(d)  # GC must not break the live set
        if reloaded.version != segset.version:
            print("gc_orphans changed the committed generation",
                  file=sys.stderr)
            return 1
    print(json.dumps({"hash": h.hexdigest(), "version": segset.version,
                      "gc_deleted": len(deleted)}))
    return 0


# ===========================================================================
# parent side (stdlib-only orchestration)
# ===========================================================================


def _run_worker(mode: str, base: str, scenario: str | None = None,
                kill_at: int | None = None,
                expect_kill: bool = False, gc: bool = True) -> dict | None:
    cmd = [sys.executable, "-m", _MODULE, "--worker", mode, "--dir", base]
    if scenario is not None:
        cmd += ["--scenario", scenario]
    env = dict(os.environ)
    # scrub our own control knobs too: an exported CRASH_HARNESS_VERIFY_GC=0
    # leaking in from the outer shell would silently disable every
    # post-kill orphan-GC assertion while the run still prints green
    for k in ("GRAFT_CHAOS", "GRAFT_TRACE_DIR",
              "CRASH_HARNESS_KILL_AT", "CRASH_HARNESS_VERIFY_GC"):
        env.pop(k, None)
    if kill_at is not None:
        env["CRASH_HARNESS_KILL_AT"] = str(kill_at)
    if not gc:
        env["CRASH_HARNESS_VERIFY_GC"] = "0"
    proc = subprocess.run(cmd, env=env, cwd=_ROOT, capture_output=True,
                          text=True, timeout=300)
    if expect_kill:
        if proc.returncode != -signal.SIGKILL:
            raise RuntimeError(
                f"worker {mode}/{scenario} kill_at={kill_at} expected "
                f"SIGKILL, exited {proc.returncode}:\n{proc.stderr[-2000:]}"
            )
        return None
    if proc.returncode != 0:
        raise RuntimeError(
            f"worker {mode}/{scenario} failed rc={proc.returncode}:\n"
            f"{proc.stderr[-2000:]}"
        )
    last = proc.stdout.strip().splitlines()[-1]
    return json.loads(last)


def _copy_state(src: str, dst: str) -> None:
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)


def run_scenario(base_dir: str, scenario: str,
                 max_kills: int | None) -> dict:
    pre = os.path.join(base_dir, scenario, "pre")
    os.makedirs(pre, exist_ok=True)
    _run_worker("setup", pre, scenario)
    # hash-only verifies: the pre state may legitimately hold a sealed-
    # but-uncommitted segment the op is about to commit — recovery GC
    # (which would sweep it) belongs to the post-kill verifies only
    pre_hash = _run_worker("verify", pre, gc=False)["hash"]

    probe = os.path.join(base_dir, scenario, "probe")
    _copy_state(pre, probe)
    boundaries = _run_worker("op", probe, scenario, kill_at=-1)["boundaries"]
    post_hash = _run_worker("verify", probe, gc=False)["hash"]
    if pre_hash == post_hash:
        raise RuntimeError(f"{scenario}: op changed nothing — bad scenario")
    if boundaries < _MIN_BOUNDARIES.get(scenario, 2):
        raise RuntimeError(
            f"{scenario}: only {boundaries} boundaries — protocol shrank?")

    ks = list(range(boundaries))
    if max_kills is not None and max_kills < boundaries:
        # spread the budgeted kills across the window, endpoints included
        ks = sorted({
            round(i * (boundaries - 1) / max(max_kills - 1, 1))
            for i in range(max_kills)
        })
    kills = []
    outcomes = {"pre": 0, "post": 0}
    for k in ks:
        work = os.path.join(base_dir, scenario, f"kill{k:02d}")
        _copy_state(pre, work)
        _run_worker("op", work, scenario, kill_at=k, expect_kill=True)
        got = _run_worker("verify", work)
        if got["hash"] == pre_hash:
            outcome = "pre"
        elif got["hash"] == post_hash:
            outcome = "post"
        else:
            raise RuntimeError(
                f"{scenario}: kill at boundary {k} left a TORN state "
                f"(hash {got['hash'][:12]} is neither pre nor post)")
        outcomes[outcome] += 1
        kills.append({"k": k, "outcome": outcome,
                      "gc_deleted": got["gc_deleted"]})
        shutil.rmtree(work, ignore_errors=True)
    if outcomes["pre"] == 0:
        raise RuntimeError(
            f"{scenario}: no kill point preserved the pre generation — "
            "the kill windows are not covering the commit")
    return {"boundaries": boundaries, "kills": kills,
            "served_pre": outcomes["pre"], "served_post": outcomes["post"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", default=",".join(_SCENARIOS),
                    help=f"comma list of {_SCENARIOS} (default: all)")
    ap.add_argument("--max-kills", type=int, default=None,
                    help="bound kill points per scenario (spread across "
                         "the window); default: every boundary")
    ap.add_argument("--dir", default=None,
                    help="work dir (default: a fresh tempdir, removed on "
                         "success)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--keep", action="store_true",
                    help="keep the work dir")
    # internal worker plumbing
    ap.add_argument("--worker", choices=("setup", "op", "verify"),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--scenario", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        _worker_env_guard()
        base = args.dir
        if args.worker == "setup":
            return worker_setup(base, args.scenario)
        if args.worker == "op":
            kill_at = int(os.environ.get("CRASH_HARNESS_KILL_AT", "-1"))
            return worker_op(base, args.scenario, kill_at)
        return worker_verify(base)

    scenarios = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    for s in scenarios:
        if s not in _SCENARIOS:
            print(f"unknown scenario {s!r} (choose from {_SCENARIOS})",
                  file=sys.stderr)
            return 2
    base_dir = args.dir or tempfile.mkdtemp(prefix="crash_harness_")
    os.makedirs(base_dir, exist_ok=True)
    t0 = time.time()
    report: dict = {}
    try:
        for s in scenarios:
            report[s] = run_scenario(base_dir, s, args.max_kills)
    except RuntimeError as exc:
        print(f"crash_harness: FAIL: {exc}", file=sys.stderr)
        print(f"work dir kept for inspection: {base_dir}", file=sys.stderr)
        return 1
    report["wall_secs"] = round(time.time() - t0, 2)
    if not args.keep and args.dir is None:
        shutil.rmtree(base_dir, ignore_errors=True)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for s in scenarios:
            r = report[s]
            print(f"crash_harness: {s}: {len(r['kills'])} kill(s) over "
                  f"{r['boundaries']} boundaries — "
                  f"{r['served_pre']} served pre / {r['served_post']} post, "
                  "0 torn, 0 orphans after recovery GC")
        print(f"crash_harness: OK ({report['wall_secs']}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
