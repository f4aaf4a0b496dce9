"""ctypes bindings to the native C++ host kernels (``native/fastio.cpp``).

Counterpart of the JAX package's ``utils/native.py``, with its own copy of
the C++ source (held byte-identical by ``tests/test_torch_native.py``):
the host-side ingest loops that are Python bottlenecks at scale, the
tokenizer+hasher and the SNAP edge-list parser, plus the (dst, src) radix
sort with dedup behind ``io/graph.from_edges``.

The library is built with ``g++`` on first use into this package's
``_build/`` (rebuilt when the source is newer) and loaded with ``ctypes``.
Every entry point returns ``None`` where the library is unavailable (no
``g++``, a failed build), and its caller takes the numpy path, which gives
the same bits.  The choice is never silent: :func:`available` says whether
the library loaded, :func:`unavailable_reason` why not, and
``io/text.tokenize_corpus`` and the graph loaders record which path ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "fastio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libfastio.so")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failure: str | None = None


def _build() -> None:
    """Compile ``fastio.cpp`` to a private name and rename it into place, so
    a process that loads the library never reads a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f"libfastio.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], check=True,  # graftlint: disable=blocking-under-lock (ROADMAP Queue 3, shared with the reference: a build-once guard; the lock is held across the g++ build ON PURPOSE so concurrent loaders wait for one build instead of racing duplicate compilers at the same .so path)
                       capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    """Build (once) and load the shared library; None if unavailable."""
    global _lib, _failure
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC):
                _build()
            lib = ctypes.CDLL(LIB_PATH)
            _declare(lib)
            _lib = lib
        except subprocess.CalledProcessError as e:
            _failure = f"g++ exited {e.returncode}: {e.stderr.strip()[-2000:]}"
        except (OSError, AttributeError) as e:
            # AttributeError: a stale library missing a newer symbol
            _failure = f"{type(e).__name__}: {e}"
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c_i64 = ctypes.c_int64
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)

    lib.parse_edges_count.argtypes = [p_u8, c_i64]
    lib.parse_edges_count.restype = c_i64
    lib.parse_edges_fill.argtypes = [p_u8, c_i64, p_i64, p_i64]
    lib.parse_edges_fill.restype = c_i64

    lib.sort_dedup_edges.argtypes = [p_i64, p_i64, c_i64, c_i64]
    lib.sort_dedup_edges.restype = c_i64

    lib.tokenize_hash_count.argtypes = [p_u8, c_i64, p_i64, c_i64, c_i64, c_i64, c_i64]
    lib.tokenize_hash_count.restype = c_i64
    lib.tokenize_hash_fill.argtypes = [
        p_u8, c_i64, p_i64, c_i64, c_i64, c_i64, c_i64, c_i64, p_i32, p_i32, p_i32,
    ]
    lib.tokenize_hash_fill.restype = c_i64


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built or loaded; None if it loaded."""
    _load()
    return _failure


def parse_edge_file(path: str) -> np.ndarray | None:
    """SNAP edge file → int64 [E, 2] array of (src, dst); None if the native
    layer is unavailable or the file holds something the numpy parser
    rejects (the caller's numpy path then raises its own error)."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    buf = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = lib.parse_edges_count(buf, data.size)
    if n < 0:
        return None
    src = np.empty(n, dtype=np.int64)
    dst = np.empty(n, dtype=np.int64)
    got = lib.parse_edges_fill(
        buf, data.size,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if got != n:
        return None
    return np.stack([src, dst], axis=1)


def sort_dedup_edges(
    src: np.ndarray, dst: np.ndarray, *, dedup: bool = True
) -> tuple[np.ndarray, np.ndarray] | None:
    """(dst, src) radix sort + optional dedup of compacted int64 edge arrays
    in C++; None if the native layer is unavailable or ids exceed 2^31
    (the caller falls back to ``np.lexsort``, which gives the same bits).

    MUTATES ``src``/``dst`` in place when they are already contiguous
    int64 (``from_edges`` owns fresh copies).  On failure (-1) the inputs
    are untouched: validation happens before any write."""
    lib = _load()
    if lib is None or src.size == 0:
        return None
    src_c = np.ascontiguousarray(src, dtype=np.int64)
    dst_c = np.ascontiguousarray(dst, dtype=np.int64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.sort_dedup_edges(
        src_c.ctypes.data_as(p_i64), dst_c.ctypes.data_as(p_i64),
        src_c.size, int(dedup),
    )
    if n < 0:
        return None
    return src_c[:n], dst_c[:n]


def tokenize_and_hash(
    docs,
    *,
    vocab_bits: int,
    ngram: int,
    lowercase: bool,
    min_token_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Tokenize + FNV-1a-hash a batch of docs in C++.

    Returns (doc_ids int32 [T], term_ids int32 [T], doc_lengths int32 [D])
    equal to the numpy path of ``io/text.py``, or None if unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    enc = [d.encode("utf-8") for d in docs]
    lens = np.fromiter((len(b) for b in enc), dtype=np.int64, count=len(enc))
    blob = np.frombuffer(b"".join(enc), dtype=np.uint8) if enc else np.empty(0, np.uint8)
    # ctypes must never see a NULL data pointer from a zero-length array
    blob = np.ascontiguousarray(blob) if blob.size else np.zeros(1, np.uint8)
    lens_c = np.ascontiguousarray(lens) if lens.size else np.zeros(1, np.int64)

    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)

    total = lib.tokenize_hash_count(
        blob.ctypes.data_as(p_u8), int(blob.size if enc else 0),
        lens_c.ctypes.data_as(p_i64), len(enc),
        int(ngram), int(lowercase), int(min_token_len),
    )
    if total < 0:
        return None
    doc_ids = np.empty(total, dtype=np.int32)
    term_ids = np.empty(total, dtype=np.int32)
    doc_lengths = np.empty(max(len(enc), 1), dtype=np.int32)
    got = lib.tokenize_hash_fill(
        blob.ctypes.data_as(p_u8), int(blob.size if enc else 0),
        lens_c.ctypes.data_as(p_i64), len(enc),
        int(ngram), int(lowercase), int(min_token_len), int(vocab_bits),
        doc_ids.ctypes.data_as(p_i32) if total else ctypes.cast(None, p_i32),
        term_ids.ctypes.data_as(p_i32) if total else ctypes.cast(None, p_i32),
        doc_lengths.ctypes.data_as(p_i32),
    )
    if got != total:
        return None
    return doc_ids, term_ids, doc_lengths[: len(enc)]
