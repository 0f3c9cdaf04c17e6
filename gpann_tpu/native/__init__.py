"""Native (C++) host components, bound via ctypes.

Role parity: the reference's runtime around the compute kernels is C++
(parlaylib scheduling, KaMinPar partitioning host logic). Here the device owns
the compute; these C++ ops cover the irregular host-side graph work where
NumPy/Python loops are orders of magnitude too slow on the single-core build
host. Every native op has a NumPy fallback (``available() == False`` path)
so the framework runs without a toolchain.

Build: lazy ``make`` on first import (``gpann_tpu/native/Makefile``), cached
as ``libgpann_native.so`` next to the sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libgpann_native.so")
_SRCS = [os.path.join(_HERE, "src", "graph_ops.cc"),
         os.path.join(_HERE, "src", "synth_gen.cc")]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
        "-std=c++17",
        *_SRCS, "-o", _LIB_PATH,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("GPANN_NO_NATIVE"):
        return None
    src_mtime = max(os.path.getmtime(s) for s in _SRCS)
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < src_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.synth_hard2_chunk.restype = None
    lib.synth_hard2_chunk.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, f32p, f32p, f64p, ctypes.c_int32, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.heavy_edge_matching.restype = ctypes.c_int64
    lib.heavy_edge_matching.argtypes = [
        ctypes.c_int64, i64p, i32p, f32p, f32p, ctypes.c_float,
        ctypes.c_uint64, i64p,
    ]
    lib.bfs_grow_partition.restype = ctypes.c_int32
    lib.bfs_grow_partition.argtypes = [
        ctypes.c_int64, i64p, i32p, f32p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_uint64, i32p,
    ]
    lib.force_balance.restype = ctypes.c_int32
    lib.force_balance.argtypes = [
        ctypes.c_int64, i64p, i32p, f32p, f32p, ctypes.c_int32,
        ctypes.c_double, i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def heavy_edge_matching(indptr, indices, weights, node_w, max_node_w, seed):
    """partner[i] = matched partner or i. Native or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(indptr) - 1
    partner = np.empty(n, np.int64)
    lib.heavy_edge_matching(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(weights, np.float32),
        np.ascontiguousarray(node_w, np.float32),
        float(max_node_w), int(seed) & (2**64 - 1), partner,
    )
    return partner


def bfs_grow_partition(indptr, indices, node_w, k, cap, seed):
    lib = _load()
    if lib is None:
        return None
    n = len(indptr) - 1
    part = np.full(n, -1, np.int32)
    lib.bfs_grow_partition(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(node_w, np.float32),
        int(k), float(cap), int(seed) & (2**64 - 1), part,
    )
    return part


def synth_hard2_chunk(seed, row0, m, d, centers, scales, cdf, dtype,
                      q_scale):
    """[m, d] chunk of the 'hard2' dataset starting at global row ``row0``
    (counter-based streams: chunking-independent). Returns None when the
    native library is unavailable — eval/synth.py falls back to its numpy
    oracle implementation of the identical algorithm."""
    lib = _load()
    if lib is None:
        return None
    np_dtype = {"f32": np.float32, "u8": np.uint8, "i8": np.int8}[dtype]
    out = np.empty((m, d), np_dtype)
    lib.synth_hard2_chunk(
        int(seed) & (2**64 - 1), int(row0), int(m), int(d), len(cdf),
        np.ascontiguousarray(centers, np.float32),
        np.ascontiguousarray(scales, np.float32),
        np.ascontiguousarray(cdf, np.float64),
        {"f32": 0, "u8": 1, "i8": 2}[dtype], float(q_scale),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def force_balance(indptr, indices, weights, node_w, k, cap, part):
    lib = _load()
    if lib is None:
        return None
    part = np.ascontiguousarray(part, np.int32).copy()
    lib.force_balance(
        len(indptr) - 1,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(weights, np.float32),
        np.ascontiguousarray(node_w, np.float32),
        int(k), float(cap), part,
    )
    return part
