"""ctypes binding for the native (C++) SAH BVH builder.

The reference's host build is pure python and takes minutes on the 23k-tri
character meshes (SURVEY.md §7 hard-part 6); our numpy builder takes ~1s
and this C++ builder ~100ms while producing *identical* arrays (the split
rule, float semantics, and node ordering are replicated exactly —
tests/test_native_bvh.py asserts equality against accel/bvh.py).

The shared library is built on demand with g++ (csrc/Makefile) into
``csrc/build/``, under a name keyed by the hash of the source and Makefile
and by the host, so a ``-march=native`` build is only ever loaded on the
machine that compiled it, always from the committed source. If the
toolchain or build fails, callers fall back to the numpy builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "csrc")


def _library_path() -> str:
    """``csrc/build/liblpt_native-<source hash>-<host hash>.so``."""
    src = hashlib.sha256()
    for name in ("bvh_builder.cpp", "Makefile"):
        with open(os.path.join(_CSRC, name), "rb") as f:
            src.update(f.read())
    host = hashlib.sha256(
        f"{platform.node()}|{platform.machine()}".encode()).hexdigest()
    return os.path.join(_CSRC, "build", f"liblpt_native-{src.hexdigest()[:16]}"
                        f"-{host[:8]}.so")


_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            so = _library_path()
            if not os.path.exists(so):
                # build under a private name, then rename: concurrent
                # processes never load a half-written library
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["make", "-C", _CSRC, "-s", f"OUT={tmp}"],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.lpt_build_bvh.restype = ctypes.c_int
            lib.lpt_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float),   # plow
                ctypes.POINTER(ctypes.c_float),   # phigh
                ctypes.POINTER(ctypes.c_float),   # centroid
                ctypes.c_int64,                   # n
                ctypes.c_int32, ctypes.c_int32,   # max_depth, max_leaf
                ctypes.POINTER(ctypes.c_int32),   # left
                ctypes.POINTER(ctypes.c_int32),   # right
                ctypes.POINTER(ctypes.c_float),   # low
                ctypes.POINTER(ctypes.c_float),   # high
                ctypes.POINTER(ctypes.c_int32),   # data
                ctypes.POINTER(ctypes.c_int32),   # cut
                ctypes.POINTER(ctypes.c_int32),   # prim
                ctypes.POINTER(ctypes.c_int64),   # counts
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(plow, phigh, centroid, max_depth: int, max_leaf: int):
    """Run the C++ builder; returns the same tuple layout the numpy path
    assembles, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None

    plow = np.ascontiguousarray(plow, np.float32)
    phigh = np.ascontiguousarray(phigh, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    n = plow.shape[0]
    cap = 2 * n + 8
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    low = np.empty((cap, 3), np.float32)
    high = np.empty((cap, 3), np.float32)
    data = np.empty(cap, np.int32)
    cut = np.empty(n + 2, np.int32)
    prim = np.empty(n, np.int32)
    counts = np.zeros(2, np.int64)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.lpt_build_bvh(
        fp(plow), fp(phigh), fp(centroid), n, max_depth, max_leaf,
        ip(left), ip(right), fp(low), fp(high), ip(data), ip(cut), ip(prim),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    m = int(counts[0])
    n_leaves = int(counts[1])
    return (left[:m].copy(), right[:m].copy(), low[:m].copy(),
            high[:m].copy(), data[:m].copy(), cut[:n_leaves + 1].copy(),
            prim.copy())
