"""Build and load the CUDA kernels (``csrc/ccp_eval.cu``).

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The build happens at
first use, from the checkout's own sources, into ``build/repro_torch/`` at
the repository root; the library's file name carries a hash of the source
and flags, so an edited source is rebuilt.  A missing ``nvcc`` or a failed
build raises.  ``library()`` is safe to call from several threads (the
daemon's): one lock covers the check, the build and the load.
``totals()`` counts what this process built and loaded, in the shape of
the reference's executable-cache totals, for the daemon's STATS.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "ccp_eval.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# signatures of the C interface (pointers and the stream as void*)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rt_connectivity": [_P, _P, _P, _I, _I, _P],
    "rt_connectivity_span": [_I, _I, _I, _P, _P, _P, _P, _I, _P],
    "rt_ccp_eval": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "rt_ccp_eval_dpsub": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    "rt_grow_pair": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "rt_bconnectivity": [_P, _P, _P, _P, _I, _I, _I, _P],
    "rt_bconnectivity_span": [_I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    "rt_bccp_eval": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rt_bccp_eval_decode": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _P],
    "rt_btree_eval": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rt_btree_eval_decode": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                             _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_bgeneral_eval": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rt_bgeneral_eval_decode": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _P],
    "rt_btree_eval_prune": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                            _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "rt_bgeneral_eval_prune": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                               _I, _I, _P],
    "rt_phase_a_blocks": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rt_commit_keys": [_P, _P, _I, _P, _P, _I, _P],
}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
BUILD_INFO: dict = {}     # {"seconds", "path", "log", "cached"} of the load
_COUNTS = {"loads": 0, "builds": 0}     # this process's, under _LOCK


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    if _LIB is not None:
        return _LIB
    with _LOCK:
        return _LIB if _LIB is not None else _load()


def _load() -> ctypes.CDLL:
    """Build (unless a library of this source and these flags exists) and
    load; the caller holds ``_LOCK``."""
    global _LIB
    t0 = time.perf_counter()
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"ccp_eval_{digest}.so"
    log, cached = "", out.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SRC}:\n{log}")
        os.replace(tmp, out)
        _COUNTS["builds"] += 1
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(out),
                      log=log, cached=cached)
    _COUNTS["loads"] += 1
    _LIB = lib
    return lib


def totals() -> dict:
    """``{"keys", "compiles", "retraces"}`` for this process: the CUDA
    libraries loaded, the ``nvcc`` builds run, and 0 (torch does not
    trace).  The keys are those of the reference's executable-cache
    totals, so a client of either package reads the daemon's STATS."""
    with _LOCK:
        return {"keys": _COUNTS["loads"], "compiles": _COUNTS["builds"],
                "retraces": 0}
