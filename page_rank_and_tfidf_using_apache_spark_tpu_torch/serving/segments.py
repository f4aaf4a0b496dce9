"""Lucene-style delta segments over the versioned array-dir artifact:
the ingest→servable path in seconds, not a full rebuild.

Counterpart of the JAX package's ``serving/segments.py``, copied so the
port never imports that package.  Its code is held to the reference's by
``tests/test_torch_segments.py``, but for one addition: ``merge_segments``
and :class:`SegmentMerger` take the segments' ``device``, on which the
merge seals its BM25 table (the reference merges on its default backend,
the caller's own; the port's default is ``cuda``).  A segmented directory
written by either package loads in the other.

A *segmented index directory* holds immutable segment artifacts plus a
versioned manifest naming the live set::

    index_dir/
      LATEST                 -> "manifest_000007.json"  (atomic pointer)
      manifest_000007.json   {"segments": [{name, doc_base, n_docs, ...}]}
      segments/
        v0001/  v0002/ ...   self-contained impacted-list artifacts
                             (serving/artifact.py layout, counts=True)

Spark-Streaming/Lucene correspondence: a streaming commit point *seals* a
segment (Lucene: ``IndexWriter.commit`` flushing an immutable segment; the
analog of a micro-batch landing in a sink), the manifest flip is the
`segments_N` generation file, and the background :class:`SegmentMerger`
is the tiered merge policy compacting small segments so the live set — and
the per-query merge fan-out — stays bounded.

Each segment carries **segment-local DF** plus raw counts and doc lengths
(``save_index(..., counts=True)``), which is exactly what makes the set
self-describing: index-wide statistics are the *sum* of the live segments'
local statistics, so :func:`load_segment_set` re-weights every segment's
postings under global DF/N at load time — scoring across segments matches
a monolithic rebuild's semantics (global IDF drift included) without ever
re-ingesting committed documents.  Documents never span segments; each
segment owns the contiguous global doc-id range ``[doc_base, doc_base +
n_docs)``.

Concurrency: manifest commits are read-modify-write (append a sealed
segment / replace merged ones), serialized through the module commit lock
so an ingest seal and a background merge can never resurrect each other's
replaced segments.  Segment *artifacts* are immutable — readers holding an
older manifest keep valid (mmap'd) files; only segments replaced by a
committed merge are garbage-collected.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import threading
import time

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import TfidfOutput
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.artifact import (
    ServableIndex,
    _term_sorted,
    build_term_offsets,
    load_index,
    save_index,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    IdfMode,
    TfidfConfig,
    TfMode,
)

SEGMENTS_SUBDIR = "segments"
_MANIFEST_RE = re.compile(r"^manifest_(\d{6})\.json$")

# Retry site of the background compaction: a transient fault mid-merge
# retries; a persistent one skips the tick — the live set just stays
# unmerged until the next pass.
MERGE_SITE = "segment_merge"

# Serializes manifest read-modify-write commits (ingest append vs merge
# replace) within one process; artifact writes themselves are atomic.
_COMMIT_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class SegmentRef:
    """One live segment as the manifest names it."""

    name: str  # version dir name under segments/ (e.g. "v0001")
    doc_base: int  # global doc-id base of this segment's range
    n_docs: int
    nnz: int

    def to_json(self) -> dict:
        # an explicit literal, not dataclasses.asdict: the tier-5
        # schema-pair-drift check validates written vs read manifest keys
        # lexically, so the writer side must be visible to the AST
        return {"name": self.name, "doc_base": self.doc_base,
                "n_docs": self.n_docs, "nnz": self.nnz}

    @classmethod
    def from_json(cls, d: dict) -> "SegmentRef":
        return cls(name=d["name"], doc_base=int(d["doc_base"]),
                   n_docs=int(d["n_docs"]), nnz=int(d["nnz"]))


@dataclasses.dataclass(frozen=True)
class Manifest:
    """One committed generation of the live segment set, base-ordered."""

    version: int
    config_hash: str
    segments: tuple[SegmentRef, ...]

    @property
    def n_docs(self) -> int:
        return sum(s.n_docs for s in self.segments)

    @property
    def nnz(self) -> int:
        return sum(s.nnz for s in self.segments)


def _manifest_name(version: int) -> str:
    return f"manifest_{version:06d}.json"


def manifest_version(directory: str) -> int | None:
    """Cheap poll of the committed manifest generation (None = the
    directory is not a segmented index yet): reads only the pointer."""
    ptr = os.path.join(directory, "LATEST")
    try:
        with open(ptr) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    m = _MANIFEST_RE.match(name)
    return int(m.group(1)) if m else None


def latest_manifest(directory: str) -> Manifest | None:
    ver = manifest_version(directory)
    if ver is None:
        return None
    with open(os.path.join(directory, _manifest_name(ver))) as f:
        d = json.load(f)
    return Manifest(
        version=int(d["version"]),
        config_hash=d["config_hash"],
        segments=tuple(SegmentRef.from_json(s) for s in d["segments"]),
    )


def _replaced_by(directory: str, version: int) -> tuple[str, ...]:
    """Segment dir names the given manifest generation replaced (its
    deferred-GC list); () when none or the file is gone."""
    try:
        with open(os.path.join(directory, _manifest_name(version))) as f:
            return tuple(json.load(f).get("replaced", ()))
    except (FileNotFoundError, json.JSONDecodeError):
        return ()


def _write_manifest(directory: str, manifest: Manifest,
                    replaced: tuple[str, ...] = ()) -> int:
    """Atomically write the manifest file, then flip LATEST — a reader
    either sees the previous generation whole or this one whole.
    ``replaced`` records the segment dirs this generation superseded;
    they are garbage-collected one generation LATER (commit_replace), so
    a reader between ``latest_manifest()`` and opening the files always
    finds them."""
    name = _manifest_name(manifest.version)
    payload = {
        "version": manifest.version,
        "config_hash": manifest.config_hash,
        "n_docs": manifest.n_docs,
        "nnz": manifest.nnz,
        "replaced": list(replaced),
        "segments": [s.to_json() for s in manifest.segments],
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        # the LATEST flip below makes this manifest pointer-visible: fsync
        # file + parent dir before the flip can name it (tier 5)
        ckpt.durable_replace(tmp, os.path.join(directory, name))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    ckpt._write_pointer(directory, name)
    obs.emit("segment_commit", version=manifest.version,
             segments=len(manifest.segments), n_docs=manifest.n_docs,
             nnz=manifest.nnz)
    obs.counter("segment_commits")
    return manifest.version


def seal_segment(
    directory: str,
    output: TfidfOutput,
    cfg: TfidfConfig,
    *,
    doc_base: int,
    ranks: np.ndarray | None = None,
    bm25: Bm25Config | None = Bm25Config(),
    extra: dict | None = None,
) -> SegmentRef:
    """Seal one immutable delta segment (NOT yet live — commit it with
    :func:`commit_append`).  ``output`` holds ONLY the delta documents,
    locally 0-indexed; ``doc_base`` places them in the global id space."""
    with obs.span("segment.seal", doc_base=doc_base, n_docs=output.n_docs,
                  nnz=output.nnz):
        path = save_index(
            os.path.join(directory, SEGMENTS_SUBDIR), output, cfg,
            ranks=ranks, bm25=bm25, counts=True,
            extra={"doc_base": int(doc_base), **(extra or {})},
        )
    return SegmentRef(name=os.path.basename(path), doc_base=int(doc_base),
                      n_docs=int(output.n_docs), nnz=int(output.nnz))


def commit_append(directory: str, ref: SegmentRef,
                  config_hash: str) -> int:
    """Commit a sealed segment into the live set: manifest generation
    version+1 with ``ref`` appended, LATEST flipped.  Returns the new
    manifest version — the moment the segment is *servable*."""
    with _COMMIT_LOCK:
        cur = latest_manifest(directory)
        if cur is not None and cur.config_hash != config_hash:
            raise ValueError(
                f"segmented index {directory} was committed under config "
                f"{cur.config_hash}; refusing to append a {config_hash} "
                "segment across semantic changes"
            )
        segs = (cur.segments if cur else ()) + (ref,)
        version = (cur.version if cur else 0) + 1
        return _write_manifest(directory, Manifest(
            version=version, config_hash=config_hash,
            segments=tuple(sorted(segs, key=lambda s: s.doc_base)),
        ))


def commit_replace(directory: str, old_names: tuple[str, ...],
                   new_ref: SegmentRef) -> int:
    """Commit a merge: the named segments leave the live set, the merged
    segment (covering exactly their doc range) enters it.  Replaced
    segment directories are deleted one generation DEFERRED: this commit
    deletes what the PREVIOUS generation replaced, and records its own
    replacements for the next one — so a reader that resolved the
    just-superseded manifest still finds every file it names."""
    with _COMMIT_LOCK:
        cur = latest_manifest(directory)
        if cur is None:
            raise FileNotFoundError(f"no committed manifest under {directory}")
        names = set(old_names)
        missing = names - {s.name for s in cur.segments}
        if missing:
            raise ValueError(f"segments not live, cannot replace: {missing}")
        gc_now = _replaced_by(directory, cur.version)
        segs = tuple(s for s in cur.segments if s.name not in names)
        segs = tuple(sorted(segs + (new_ref,), key=lambda s: s.doc_base))
        version = _write_manifest(directory, Manifest(
            version=cur.version + 1, config_hash=cur.config_hash,
            segments=segs,
        ), replaced=tuple(old_names))
    for name in gc_now:
        shutil.rmtree(os.path.join(directory, SEGMENTS_SUBDIR, name),
                      ignore_errors=True)
    return version


def gc_orphans(directory: str, *, min_age_s: float = 60.0) -> list[str]:
    """Crash-recovery sweep (operators run it after any unclean
    shutdown): delete
    on-disk state that no committed generation names — ``*.tmp`` files a
    killed writer left behind, half-staged ``.vNNNN.*`` tmp directories,
    sealed segment directories that never made it into a manifest, and
    manifest generations NEWER than the LATEST pointer (a crash between
    the manifest write and the pointer flip).  The committed generation's
    segments and its deferred-GC (``replaced``) list are kept, so the
    sweep is safe beside readers of the current generation.

    The commit lock serializes the sweep against manifest commits, but
    sealing happens OUTSIDE that lock — a segment being sealed right now
    is indistinguishable from crash debris by name alone.  ``min_age_s``
    is the guard: only candidates whose mtime is at least that old are
    deleted (default 60s — far past any seal-to-commit window), so the
    sweep is safe on a LIVE index beside in-flight seals and merges.
    Pass ``min_age_s=0`` only when no writer can be running (the crash
    harness's post-kill verify).  Returns the deleted paths."""
    deleted: list[str] = []

    def _old_enough(path: str) -> bool:
        if min_age_s <= 0:
            return True
        try:
            return time.time() - os.path.getmtime(path) >= min_age_s
        except OSError:
            return False  # vanished underneath us — nothing to delete

    with _COMMIT_LOCK:
        cur = latest_manifest(directory)
        cur_version = 0
        keep: set[str] = set()
        if cur is not None:
            cur_version = cur.version
            keep = {s.name for s in cur.segments}
            keep |= set(_replaced_by(directory, cur.version))
        try:
            names = os.listdir(directory)
        except FileNotFoundError:
            return []
        for n in sorted(names):
            p = os.path.join(directory, n)
            if not _old_enough(p):
                continue
            if n.endswith(".tmp") and os.path.isfile(p):
                os.unlink(p)
                deleted.append(p)
            elif (m := _MANIFEST_RE.match(n)) and int(m.group(1)) > cur_version:
                os.unlink(p)  # written but never flipped to: unreachable
                deleted.append(p)
        seg_root = os.path.join(directory, SEGMENTS_SUBDIR)
        try:
            seg_names = os.listdir(seg_root)
        except FileNotFoundError:
            seg_names = []
        for n in sorted(seg_names):
            p = os.path.join(seg_root, n)
            if not _old_enough(p):
                continue
            if n.endswith(".tmp") and os.path.isfile(p):
                os.unlink(p)
                deleted.append(p)
            elif n.startswith(".") and os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)  # mkdtemp staging dir
                deleted.append(p)
            elif os.path.isdir(p) and n not in keep:
                shutil.rmtree(p, ignore_errors=True)  # sealed, never named
                deleted.append(p)
    if deleted:
        obs.emit("segment_gc_orphans", directory=directory,
                 deleted=len(deleted), version=cur_version)
        obs.counter("segment_orphan_gcs")
    return deleted


def _seg_version(name: str) -> int:
    return int(name.lstrip("v"))


def load_segment(directory: str, ref: SegmentRef, *,
                 mmap: bool = True) -> ServableIndex:
    return load_index(os.path.join(directory, SEGMENTS_SUBDIR),
                      version=_seg_version(ref.name), mmap=mmap)


# ------------------------------------------------- global-stat re-weighting


def _host_idf(df: np.ndarray, n_docs: int, mode: IdfMode,
              dtype) -> np.ndarray:
    """Host mirror of ops.tfidf.idf_vector over the SUMMED (global) DF."""
    n = dtype.type(max(n_docs, 1))
    safe = np.maximum(df, 1.0).astype(dtype)
    if mode is IdfMode.CLASSIC:
        idf = np.log(n / safe)
    elif mode is IdfMode.MLLIB:
        idf = np.log((n + 1.0) / (df.astype(dtype) + 1.0))
    elif mode is IdfMode.SMOOTH:
        idf = np.log((1.0 + n) / (1.0 + df.astype(dtype))) + 1.0
    else:
        raise ValueError(f"unknown idf mode {mode}")
    return np.where(df > 0, idf, 0.0).astype(dtype)


def _host_tfidf_weights(seg: ServableIndex, idf_global: np.ndarray,
                        cfg: TfidfConfig) -> np.ndarray:
    dtype = idf_global.dtype
    count = np.asarray(seg.count, dtype)
    doc = np.asarray(seg.doc)
    dl = np.asarray(seg.doc_lengths)
    if cfg.tf_mode is TfMode.RAW:
        tf = count
    elif cfg.tf_mode is TfMode.FREQ:
        tf = count / np.maximum(dl[doc].astype(dtype), 1.0)
    else:  # LOGNORM
        tf = np.where(count > 0, 1.0 + np.log(np.maximum(count, 1.0)),
                      0.0).astype(dtype)
    w = tf * idf_global[np.asarray(seg.term)]
    if cfg.l2_normalize:
        sq = np.zeros(seg.n_docs, dtype)
        np.add.at(sq, doc, w * w)
        w = w / np.sqrt(np.maximum(sq, 1e-30))[doc]
    return w.astype(dtype)


def _host_bm25_weights(seg: ServableIndex, df_global: np.ndarray,
                       n_total: int, avgdl: float,
                       bm25: Bm25Config) -> np.ndarray:
    """Host mirror of dataflow.bm25.bm25_weights under INDEX-WIDE stats
    (global df, global N, global average doc length)."""
    dtype = df_global.dtype
    count = np.asarray(seg.count, dtype)
    dl = np.asarray(seg.doc_lengths)[np.asarray(seg.doc)].astype(dtype)
    df_pair = df_global[np.asarray(seg.term)]
    n = dtype.type(max(n_total, 1))
    idf = np.log1p((n - df_pair + 0.5) / (df_pair + 0.5))
    tf = count * (bm25.k1 + 1.0) / (
        count + bm25.k1 * (1.0 - bm25.b + bm25.b * dl / dtype.type(avgdl))
    )
    return (idf * tf).astype(dtype)


@dataclasses.dataclass(frozen=True)
class LoadedSegment:
    """One live segment ready for a server to device_put: the artifact
    plus its global placement and the index-wide re-weighted tables."""

    index: ServableIndex
    ref: SegmentRef
    weights: dict  # ranker -> np.ndarray [nnz] under GLOBAL statistics
    # int64 [vocab + 1] host slice table; None ONLY for a legacy
    # (pre-offsets, non-term-sorted) artifact — such a set serves via
    # the COO path only (the server refuses scoring="impacted" on it)
    term_offsets: np.ndarray | None


def _safe_offsets(index: ServableIndex, vocab: int) -> np.ndarray | None:
    """CSC offsets for a loaded artifact — derived ONLY when the postings
    really are term-sorted.  A legacy chunk-major streaming artifact is
    not, and bincount-derived offsets over it would describe runs that do
    not exist: silently wrong impacted scores.  None = COO-only."""
    if index.term_offsets is not None:
        return np.asarray(index.term_offsets)
    term = np.asarray(index.term)
    if _term_sorted(np.asarray(index.doc), term):
        return build_term_offsets(term, vocab)
    return None


@dataclasses.dataclass(frozen=True)
class SegmentSet:
    """The loaded live set of one manifest generation — what a server
    serves across (and hot-swaps to on refresh)."""

    directory: str
    manifest: Manifest
    segments: tuple[LoadedSegment, ...]
    cfg: TfidfConfig
    df_global: np.ndarray

    @property
    def version(self) -> int:
        return self.manifest.version

    @property
    def n_docs(self) -> int:
        return self.manifest.n_docs

    @property
    def nnz(self) -> int:
        return self.manifest.nnz

    @property
    def vocab_bits(self) -> int:
        return self.cfg.vocab_bits

    @property
    def has_bm25(self) -> bool:
        return all("bm25" in s.weights for s in self.segments)

    @property
    def has_ranks(self) -> bool:
        return all(s.index.ranks is not None for s in self.segments)


def load_segment_set(directory: str, *, mmap: bool = True,
                     expect_config_hash: str | None = None) -> SegmentSet:
    """Load the committed live set and re-weight every segment's postings
    under index-wide statistics (global DF = Σ segment-local DF, global
    N = Σ segment docs, global avgdl) so cross-segment scoring matches a
    monolithic rebuild — the whole point of carrying segment-local DF."""
    manifest = raw = None
    for attempt in range(3):
        manifest = latest_manifest(directory)
        if manifest is None:
            raise FileNotFoundError(
                f"no committed segment manifest under {directory!r} "
                "(seal one with serving.segments.seal_segment + "
                "commit_append)"
            )
        if (expect_config_hash is not None
                and manifest.config_hash != expect_config_hash):
            raise ValueError(
                f"segmented index {directory} was committed under config "
                f"{manifest.config_hash}, but current config is "
                f"{expect_config_hash}; refusing to serve across semantic "
                "changes"
            )
        try:
            raw = [load_segment(directory, ref, mmap=mmap)
                   for ref in manifest.segments]
            break
        except FileNotFoundError:
            # a concurrent merge superseded this generation and its
            # deferred GC caught up with a segment we were about to open
            # — the NEWEST manifest's files cannot be GC'd before a
            # further commit, so re-resolving wins immediately
            if attempt == 2:
                raise
    with obs.span("segment.load_set", version=manifest.version,
                  segments=len(manifest.segments)):
        cfg = raw[0].cfg
        dtype = np.asarray(raw[0].weight[:0]).dtype
        df_global = np.zeros(cfg.vocab_size, dtype)
        n_total = manifest.n_docs
        total_len = 0
        rescore = all(
            s.count is not None and s.doc_lengths is not None for s in raw
        )
        for s in raw:
            df_global += np.asarray(s.df, dtype)
            if rescore:
                total_len += int(np.asarray(s.doc_lengths).sum())
        avgdl = max(total_len / max(n_total, 1), 1.0)
        idf_global = _host_idf(df_global, n_total, cfg.idf_mode,
                               np.dtype(dtype))
        loaded = []
        for s, ref in zip(raw, manifest.segments):
            if rescore:
                weights = {"tfidf": _host_tfidf_weights(s, idf_global, cfg)}
                bm25_cfg = s.extra.get("bm25_config")
                if bm25_cfg is not None:
                    weights["bm25"] = _host_bm25_weights(
                        s, df_global, n_total, avgdl, Bm25Config(**bm25_cfg)
                    )
            else:
                # a plain (counts-less) artifact wrapped as a one-segment
                # set: serve its stored tables verbatim
                weights = {"tfidf": np.ascontiguousarray(s.weight)}
                if s.bm25_weight is not None:
                    weights["bm25"] = np.ascontiguousarray(
                        s.bm25_weight.astype(dtype)
                    )
            loaded.append(LoadedSegment(
                index=s, ref=ref, weights=weights,
                term_offsets=_safe_offsets(s, cfg.vocab_size),
            ))
    return SegmentSet(directory=directory, manifest=manifest,
                      segments=tuple(loaded), cfg=cfg, df_global=df_global)


def wrap_index_as_set(index: ServableIndex) -> SegmentSet:
    """A plain monolithic :class:`ServableIndex` as a one-segment live
    set (doc_base 0) — the server's uniform internal representation."""
    ref = SegmentRef(name=os.path.basename(index.path), doc_base=0,
                     n_docs=index.n_docs, nnz=index.nnz)
    dtype = np.asarray(index.weight[:0]).dtype
    weights = {"tfidf": np.ascontiguousarray(index.weight)}
    if index.bm25_weight is not None:
        weights["bm25"] = np.ascontiguousarray(
            index.bm25_weight.astype(dtype))
    offsets = _safe_offsets(index, index.vocab_size)
    manifest = Manifest(version=index.version,
                        config_hash=index.cfg.config_hash(),
                        segments=(ref,))
    return SegmentSet(
        directory=os.path.dirname(index.path), manifest=manifest,
        segments=(LoadedSegment(index=index, ref=ref, weights=weights,
                                term_offsets=offsets),),
        cfg=index.cfg, df_global=np.asarray(index.df, dtype),
    )


# ------------------------------------------------------------------ merging


def merge_segments(directory: str, refs: tuple[SegmentRef, ...],
                   cfg: TfidfConfig, device: str | None = None) -> SegmentRef:
    """Compact adjacent segments into one sealed segment covering their
    combined contiguous doc range (NOT yet live — commit with
    :func:`commit_replace`).  Postings are re-sorted (term, doc) over the
    merged id space; local DF adds exactly (each (term, doc) pair lives in
    exactly one segment)."""
    refs = tuple(sorted(refs, key=lambda r: r.doc_base))
    for a, b in zip(refs, refs[1:]):
        if a.doc_base + a.n_docs != b.doc_base:
            raise ValueError(
                f"segments are not doc-contiguous: {a.name} ends at "
                f"{a.doc_base + a.n_docs}, {b.name} starts at {b.doc_base}"
            )
    base = refs[0].doc_base
    segs = [load_segment(directory, r, mmap=False) for r in refs]
    for s in segs:
        if s.count is None or s.doc_lengths is None:
            raise ValueError(
                f"segment {s.path} carries no raw counts — only "
                "counts=True segments are mergeable"
            )
    dtype = np.asarray(segs[0].weight[:0]).dtype
    doc = np.concatenate([
        np.asarray(s.doc, np.int64) + (r.doc_base - base)
        for s, r in zip(segs, refs)
    ]).astype(np.int32)
    term = np.concatenate([np.asarray(s.term) for s in segs])
    count = np.concatenate([np.asarray(s.count, dtype) for s in segs])
    perm = np.lexsort((doc, term))
    doc, term, count = doc[perm], term[perm], count[perm]
    doc_lengths = np.concatenate(
        [np.asarray(s.doc_lengths, np.int32) for s in segs])
    df = np.zeros(cfg.vocab_size, dtype)
    for s in segs:
        df += np.asarray(s.df, dtype)
    n_docs = sum(r.n_docs for r in refs)
    idf = _host_idf(df, n_docs, cfg.idf_mode, np.dtype(dtype))
    ranks = None
    if all(s.ranks is not None for s in segs):
        ranks = np.concatenate([np.asarray(s.ranks) for s in segs])
    # the merged weight table under SEGMENT-LOCAL stats, like any sealed
    # segment's (serve-time re-weighting under global stats supersedes it)
    w = _host_tfidf_weights(
        dataclasses.replace(
            segs[0], doc=doc, term=term, count=count,
            doc_lengths=doc_lengths, n_docs=n_docs,
        ),
        idf, cfg,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import (
        MetricsRecorder,
    )

    out = TfidfOutput(
        n_docs=n_docs, vocab_bits=cfg.vocab_bits, doc=doc, term=term,
        weight=w, df=df, idf=idf, metrics=MetricsRecorder(),
        count=count, doc_lengths=doc_lengths, device=device,
    )
    bm25_cfg = segs[0].extra.get("bm25_config")
    return seal_segment(
        directory, out, cfg, doc_base=base, ranks=ranks,
        bm25=Bm25Config(**bm25_cfg) if bm25_cfg is not None else None,
        extra={"merged_from": [r.name for r in refs]},
    )


def plan_merge(manifest: Manifest,
               max_segments: int) -> tuple[SegmentRef, ...] | None:
    """Tiered-merge policy: while the live set exceeds ``max_segments``,
    compact the ADJACENT pair with the smallest combined nnz (small
    deltas coalesce first; the big old segment is left alone until its
    neighbors grow comparable — Lucene's size-tiered intuition)."""
    segs = sorted(manifest.segments, key=lambda s: s.doc_base)
    if len(segs) <= max_segments:
        return None
    best = min(range(len(segs) - 1),
               key=lambda i: segs[i].nnz + segs[i + 1].nnz)
    return (segs[best], segs[best + 1])


class SegmentMerger:
    """Background compaction thread (``segment-merge``): every
    ``interval_s`` it loads the committed manifest and, while the live set
    exceeds ``max_segments``, merges the smallest adjacent pair and commits
    the replacement — under the resilience executor at the
    ``segment_merge`` site, so transient chaos retries and a persistent
    fault skips the tick (the set just stays unmerged; nothing
    serving-side depends on a merge happening)."""

    def __init__(self, directory: str, cfg: TfidfConfig, *,
                 max_segments: int = 4, interval_s: float = 1.0,
                 device: str | None = None):
        self.directory = directory
        self.cfg = cfg
        self.device = device
        self.max_segments = max(int(max_segments), 1)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._merges = 0
        self._errors = 0
        self._thread: threading.Thread | None = None

    def start(self) -> "SegmentMerger":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="segment-merge", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self) -> "SegmentMerger":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def merges(self) -> int:
        with self._lock:
            return self._merges

    def merge_once(self) -> bool:
        """One compaction step (also the testable unit): merge + commit
        the planned pair, True when a merge landed."""
        manifest = latest_manifest(self.directory)
        if manifest is None:
            return False
        pair = plan_merge(manifest, self.max_segments)
        if pair is None:
            return False
        with obs.span("segment.merge", a=pair[0].name, b=pair[1].name,
                      nnz=pair[0].nnz + pair[1].nnz):
            ref = rx.run_guarded(
                lambda: merge_segments(self.directory, pair, self.cfg, self.device),
                site=MERGE_SITE,
            )
            commit_replace(self.directory, (pair[0].name, pair[1].name), ref)
        with self._lock:
            self._merges += 1
        obs.emit("segment_merged", into=ref.name,
                 merged=[pair[0].name, pair[1].name], nnz=ref.nnz)
        obs.counter("segment_merges")
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                # drain the backlog: repeated merges until within policy
                while self.merge_once():
                    if self._stop.is_set():
                        break
            except Exception as exc:  # noqa: BLE001 — a failed merge must
                # never take serving down; the next tick retries from the
                # committed manifest (merge is idempotent-by-replacement)
                with self._lock:
                    self._errors += 1
                obs.emit("segment_merge_failed",
                         error=f"{type(exc).__name__}: {exc}"[:200])
                obs.counter("segment_merge_failures")
                time.sleep(min(self.interval_s, 0.2))
