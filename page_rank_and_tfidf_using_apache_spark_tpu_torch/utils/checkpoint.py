"""Checkpoints and versioned array directories on disk.

Counterpart of the JAX package's ``utils/checkpoint.py``, copied so the
port never imports that package; its code is held to the reference's by
``tests/test_torch_checkpoint.py``, so both packages read and write the
same files: a checkpoint written by either resumes in the other, and an
index the port saves loads in the JAX package's ``serving.load_index``.

Two formats share one metadata schema (``{step, config_hash, extra}``)
and one atomic ``LATEST`` pointer:

- ``ckpt_%08d.npz``: a flat ``.npz`` snapshot of state arrays plus the
  metadata, written to a temporary file, fsync'd and renamed into place,
  so a kill mid-write never corrupts the latest checkpoint; loading one
  under a different ``config_hash`` raises;
- ``v%04d/``: one ``.npy`` per array and a ``META.json``, loadable with
  ``np.load(mmap_mode="r")`` (the serving index).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs


_META_KEY = "__ckpt_meta__"
_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")
_VDIR_RE = re.compile(r"^v(\d{4})$")


def _fsync_path(path: str) -> None:
    """fsync one existing file or directory by path (open, fsync, close)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(directory: str) -> None:
    """Flush a directory's entry table — the other half of a durable
    rename.  ``os.replace`` makes the swap atomic for concurrent READERS,
    but only an fsync of the parent directory makes the new entry itself
    survive a power loss; without it a crash can roll the directory back
    to a state where the pointer names a payload that never got linked."""
    _fsync_path(directory or ".")


def durable_replace(src: str, dst: str) -> None:
    """The commit idiom for pointer-visible writes: fsync the staged payload — a file, or
    a staged directory plus every file in it — atomically rename it into
    place, then fsync the destination's parent directory so the rename
    itself is durable.  Readers never see a torn payload (the rename is
    atomic) AND a crash after return can never lose state that a pointer
    flip — possibly this very call — has made reachable."""
    if os.path.isdir(src):
        # every file AND every directory entry table, bottom-up — a
        # nested member renamed into place un-fsynced would be exactly
        # the lost-payload class this helper exists to close
        for dirpath, _dirnames, filenames in os.walk(src, topdown=False):
            for name in sorted(filenames):
                _fsync_path(os.path.join(dirpath, name))
            _fsync_path(dirpath)
    else:
        _fsync_path(src)
    os.replace(src, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def _write_pointer(directory: str, name: str, pointer: str = "LATEST") -> None:
    """Durably flip the directory's pointer file to ``name`` — the same
    tmp-file hygiene as the checkpoint payload write (a failure between
    mkstemp and replace must not leak the tempfile), with the flip itself
    fsync'd: a pointer that names only fsync'd payloads but is not itself
    durable can still vanish on power loss, silently rolling back a
    commit the caller already reported."""
    ptr = os.path.join(directory, pointer)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(name)
        durable_replace(tmp, ptr)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(
    directory: str,
    step: int,
    arrays: dict[str, np.ndarray],
    config_hash: str,
    extra: dict[str, Any] | None = None,
    keep: int | None = None,
) -> str:
    """Atomically write ``step``'s state; returns the checkpoint path.

    ``keep`` bounds how many ``.npz`` snapshots stay on disk (oldest pruned
    after the LATEST pointer flips); None reads ``GRAFT_CKPT_KEEP``
    (default 8), and 0 keeps everything.
    """
    os.makedirs(directory, exist_ok=True)
    meta = {"step": int(step), "config_hash": config_hash, "extra": extra or {}}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                **{k: np.asarray(v) for k, v in arrays.items()},
                **{_META_KEY: np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)},
            )
        # fsync + atomic rename + parent-dir fsync: the LATEST flip below
        # makes this payload pointer-visible, so the write must be durable
        # BEFORE the pointer can name it
        durable_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _write_pointer(directory, os.path.basename(path))
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        nbytes = None  # a concurrent gc may beat us to it — tolerated above
    obs.emit("checkpoint_save", path=path, step=int(step), bytes=nbytes)
    obs.counter("checkpoint_saves")
    if keep is None:
        keep = int(os.environ.get("GRAFT_CKPT_KEEP", 8))
    if keep > 0:
        gc_checkpoints(directory, keep=keep)
    return path


def gc_checkpoints(directory: str, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` snapshots (by step number).

    The file the LATEST pointer names is always kept, whatever its step —
    a resumable run must never have its pointer dangling.  Returns the
    deleted paths (for logging/tests).
    """
    if keep <= 0:
        raise ValueError(f"keep must be >= 1, got {keep}")
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    snaps = sorted(
        (int(m.group(1)), n) for n in names if (m := _CKPT_RE.match(n))
    )
    pinned: str | None = None
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            pinned = f.read().strip()
    deleted: list[str] = []
    for _, name in snaps[:-keep] if len(snaps) > keep else []:
        if name == pinned:
            continue
        path = os.path.join(directory, name)
        try:
            os.unlink(path)
            deleted.append(path)
        except FileNotFoundError:
            pass  # concurrent gc — already gone
    if deleted:
        obs.emit("checkpoint_gc", directory=directory, deleted=len(deleted),
                 keep=keep)
    return deleted


def latest_checkpoint(directory: str) -> str | None:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None


def peek_meta(path: str) -> dict[str, Any]:
    """Read only a checkpoint's metadata ``{step, config_hash, extra}`` —
    npz members load lazily, so this never touches the state arrays.
    Cheap enough for resume-point probing and partial-run accounting."""
    with np.load(path) as z:
        return json.loads(bytes(z[_META_KEY]).decode())


# --------------------------------------------------------------------------
# Versioned array directories (the serving-artifact substrate).
#
# ``.npz`` snapshots are zip containers: loading one decompresses every
# member into fresh host memory, which is exactly wrong for a long-lived
# server that wants the postings tables paged in on demand.  This second
# format keeps the SAME metadata schema ({step, config_hash, extra}) and
# the SAME atomic-pointer discipline, but stores each array as a bare
# ``<name>.npy`` inside a ``v%04d`` directory — ``np.load(mmap_mode="r")``
# then maps the file instead of copying it, so N server processes share
# one page cache and startup touches no array bytes at all.
# --------------------------------------------------------------------------


def save_array_dir(
    directory: str,
    version: int,
    arrays: dict[str, np.ndarray],
    config_hash: str,
    extra: dict[str, Any] | None = None,
) -> str:
    """Atomically write ``v{version:04d}/`` with one mmap-loadable ``.npy``
    per array plus a ``META.json`` sidecar; flips the LATEST pointer last,
    so a reader never sees a half-written version.  Returns the version
    directory path."""
    os.makedirs(directory, exist_ok=True)
    name = f"v{version:04d}"
    final = os.path.join(directory, name)
    if os.path.exists(final):
        raise FileExistsError(f"artifact version already exists: {final}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".{name}.")
    try:
        for key, value in arrays.items():
            np.save(os.path.join(tmp, f"{key}.npy"), np.asarray(value))
        meta = {"step": int(version), "config_hash": config_hash,
                "extra": extra or {}}
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
            f.write("\n")
        # fsync every member + the staged dir + the parent: the dir must
        # appear whole AND durable before the LATEST flip names it
        durable_replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    _write_pointer(directory, name)
    nbytes = sum(
        os.path.getsize(os.path.join(final, f)) for f in os.listdir(final)
    )
    obs.emit("artifact_save", path=final, version=int(version), bytes=nbytes)
    obs.counter("artifact_saves")
    return final


def latest_array_dir(directory: str) -> str | None:
    """Resolve the LATEST pointer to a version directory (None when the
    directory holds no committed version)."""
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    return path if os.path.isdir(path) else None


def next_version(directory: str) -> int:
    """1 + the highest committed version number in ``directory`` (1 when
    empty) — what a writer should pass to :func:`save_array_dir`."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return 1
    versions = [int(m.group(1)) for n in names if (m := _VDIR_RE.match(n))]
    return max(versions, default=0) + 1


def load_array_dir(
    path: str,
    expect_config_hash: str | None = None,
    *,
    mmap: bool = True,
) -> tuple[int, dict[str, np.ndarray], dict[str, Any]]:
    """Load a version directory: (version, arrays, extra).  With ``mmap``
    (the default) every array is an ``np.memmap`` view — pages fault in on
    first touch, nothing is copied up front.  Raises on config-hash
    mismatch, same contract as :func:`load_checkpoint`."""
    with open(os.path.join(path, "META.json")) as f:
        meta = json.load(f)
    if expect_config_hash is not None and meta["config_hash"] != expect_config_hash:
        raise ValueError(
            f"artifact {path} was written under config {meta['config_hash']}, "
            f"but current config is {expect_config_hash}; refusing to serve "
            "across semantic changes"
        )
    arrays = {
        n[:-4]: np.load(os.path.join(path, n),
                        mmap_mode="r" if mmap else None)
        for n in sorted(os.listdir(path))
        if n.endswith(".npy")
    }
    obs.emit("artifact_load", path=path, version=int(meta["step"]))
    return meta["step"], arrays, meta["extra"]


def load_checkpoint(
    path: str, expect_config_hash: str | None = None
) -> tuple[int, dict[str, np.ndarray], dict[str, Any]]:
    """Returns (step, arrays, extra). Raises on config-hash mismatch."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    if expect_config_hash is not None and meta["config_hash"] != expect_config_hash:
        raise ValueError(
            f"checkpoint {path} was written under config {meta['config_hash']}, "
            f"but current config is {expect_config_hash}; refusing to resume "
            "across semantic changes"
        )
    obs.emit("checkpoint_resume", path=path, step=int(meta["step"]))
    return meta["step"], arrays, meta["extra"]
