"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, on first use, into
``_build/`` beside ``csrc/`` (listed in ``.gitignore``), and loaded with
``ctypes``.  Missing libraries are built together, one ``nvcc`` process per
source, all started at once.  A library older than its source, or than any
shared header ``csrc/*.cuh``, is rebuilt.
Nothing here runs at import time: this module imports on a machine with no
CUDA toolkit, and only a launch on a CUDA tensor reaches :func:`library`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLL = ctypes.POINTER(ctypes.c_longlong)
# C signatures of every exported function: name -> (restype, argtypes).
SIGNATURES: dict[str, dict[str, tuple]] = {
    "cumsum": {
        "cumsum_scratch_len": (_LL, [_LL]),
        "cumsum_f32": (_I, [_P, _P, _P, _LL, _P]),
        "cumsum_f64": (_I, [_P, _P, _P, _LL, _P]),
        "cumsum_error_string": (ctypes.c_char_p, [_I]),
    },
    "spmv": {
        "spmv_scratch_len": (_LL, [_LL, _LL, _I]),
        "spmv_tile_len": (_I, []),
        "spmv_f32": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _P]),
        "spmv_f64": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _P]),
        "spmv_error_string": (ctypes.c_char_p, [_I]),
    },
    "rowsum": {
        "rowsum_f32": (_I, [_P, _P, _LL, _I, _P]),
        "rowsum_f64": (_I, [_P, _P, _LL, _I, _P]),
        "rowsum_plan": (_I, [_I, _I, _PLL, _PLL]),
        "rowsum_error_string": (ctypes.c_char_p, [_I]),
    },
    "segment": {
        "segment_scratch_len": (_LL, [_LL, _LL]),
        "segment_block_items": (_I, []),
        "segment_gather_f32": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _P]),
        "segment_gather_f64": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _P]),
        "segment_values_f32": (_I, [_P, _P, _P, _P, _LL, _LL, _P]),
        "segment_values_f64": (_I, [_P, _P, _P, _P, _LL, _LL, _P]),
        "segment_error_string": (ctypes.c_char_p, [_I]),
    },
    "gather": {
        "gather_f32": (_I, [_P, _P, _P, _I, _LL, _I, _I, _I, _P]),
        "gather_table_limit": (_I, []),
        "gather_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of this package are built from csrc/ on first use")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether ``lib<name>.so`` is missing or older than ``<name>.cu`` or any
    ``csrc/*.cuh`` (a source may include any of them)."""
    lib = lib_path(name)
    if not lib.exists():
        return True
    sources = [SRC_DIR / f"{name}.cu", *SRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names=tuple(SIGNATURES), *, force: bool = False) -> dict[str, dict]:
    """Compile ``names`` (the stale ones, or all with ``force``) in
    parallel.  Returns ``{name: {"seconds": s, "log": nvcc output}}`` for
    what was built; raises ``RuntimeError`` with the compiler's output if
    any build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        # write to a private name and rename, so a reader never loads a
        # half-written library
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed (with
    every other stale library, in parallel), with its C signatures set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build(tuple(n for n in SIGNATURES if _stale(n)))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
