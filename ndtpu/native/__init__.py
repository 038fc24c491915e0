"""Native (C++) host-side components, loaded through ctypes.

Capability parity: the reference's runtime is C++ end to end; the pieces
that genuinely belong on the host in the re-engineering — the data
loader (SURVEY.md §3.1 "Dataset reader") and the symbolic sparse orderings
(§3.2 "Sparse ordering libs") — are implemented natively here, with pure-
Python fallbacks so the package degrades gracefully without a toolchain.

The shared library builds lazily on first use (g++ -O3 -shared) and is
cached next to the sources; ``ndtpu_native_available()`` reports status.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["ndtpu_native_available", "load_library", "parse_carmen_native",
           "rcm_order", "amd_order"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libndtpu_native.so")
_SOURCES = ["carmen_parser.cpp", "ordering.cpp"]
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= newest_src):
        return None
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", _LIB_PATH + ".tmp"] + srcs
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(_LIB_PATH + ".tmp", _LIB_PATH)
        return None
    except FileNotFoundError:
        return "g++ not found"
    except subprocess.CalledProcessError as err:
        return err.stderr.decode(errors="replace")[:2000]
    except subprocess.TimeoutExpired:
        return "native build timed out"


def load_library():
    """The ctypes library handle, building on demand; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        _build_error = _build()
        if _build_error is not None:
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.carmen_parse.restype = ctypes.c_void_p
        lib.carmen_parse.argtypes = [ctypes.c_char_p]
        lib.carmen_num_scans.argtypes = [ctypes.c_void_p]
        lib.carmen_max_beams.argtypes = [ctypes.c_void_p]
        lib.carmen_fill.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_float,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.carmen_free.argtypes = [ctypes.c_void_p]
        lib.carmen_meta.restype = ctypes.c_int
        lib.carmen_meta.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        for name in ("rcm_order", "amd_order"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
        _lib = lib
        return _lib


def ndtpu_native_available() -> bool:
    return load_library() is not None


def parse_carmen_native(path: str, max_range: float = 81.9):
    """Native CARMEN parse -> the same CarmenLog the Python parser returns.

    Raises RuntimeError if the native library is unavailable (callers fall
    back to :func:`ndtpu.data.carmen.read_carmen`).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    h = lib.carmen_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        t = lib.carmen_num_scans(h)
        if t == 0:
            raise ValueError(f"no laser lines found in {path}")
        mb = lib.carmen_max_beams(h)
        ranges = np.empty((t, mb), np.float32)
        n_beams = np.empty(t, np.int32)
        lp = np.empty((t, 3), np.float64)
        op = np.empty((t, 3), np.float64)
        ts = np.empty(t, np.float64)
        lib.carmen_fill(h, ranges.reshape(-1), np.float32(max_range),
                        n_beams, lp.reshape(-1), op.reshape(-1), ts)
        meta = np.empty(3, np.float64)
        has_meta = lib.carmen_meta(h, meta)
    finally:
        lib.carmen_free(h)
    from ndtpu.data.carmen import CarmenLog
    sa, fv, mr = (meta if has_meta else (np.nan, np.nan, np.nan))
    return CarmenLog(ranges=ranges, n_beams=n_beams, laser_pose=lp,
                     odom_pose=op, timestamps=ts, start_angle=float(sa),
                     fov=float(fv), log_max_range=float(mr))


def _order(name: str, edges_i, edges_j, n_vertices: int) -> np.ndarray:
    ei = np.ascontiguousarray(edges_i, np.int32)
    ej = np.ascontiguousarray(edges_j, np.int32)
    out = np.empty(n_vertices, np.int32)
    lib = load_library()
    if lib is not None:
        rc = getattr(lib, name)(ei, ej, len(ei), n_vertices, out)
        if rc == 0:
            return out
    # Pure-python fallback: scipy RCM (both callers tolerate any permutation).
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    a = coo_matrix((np.ones(len(ei)), (ei, ej)),
                   shape=(n_vertices, n_vertices))
    return np.asarray(reverse_cuthill_mckee(
        (a + a.T).tocsr(), symmetric_mode=True), np.int32)


def rcm_order(edges_i, edges_j, n_vertices: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (position -> vertex)."""
    return _order("rcm_order", edges_i, edges_j, n_vertices)


def amd_order(edges_i, edges_j, n_vertices: int) -> np.ndarray:
    """Greedy minimum-degree elimination ordering (position -> vertex)."""
    return _order("amd_order", edges_i, edges_j, n_vertices)
