"""ctypes bridge to the native C++ runtime pieces (native/).

The reference keeps its whole host runtime in C++ (scene build + BVH,
scene.cpp/bvh.cu); here the hot host-side kernel — BVH construction for
million-triangle meshes — has a C++ implementation
(native/bvh_builder.cpp) loaded as a plain shared library.  The numpy
builder (models/bvh.py) stays as the always-available fallback and as the
semantic reference: both must produce bit-identical arrays
(tests/test_native.py).

The library is built on demand with ``make`` the first time it is needed
and cached next to its source; set ``PT_NO_NATIVE=1`` to force the
pure-numpy path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpt_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PT_NO_NATIVE"):
            return None
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.pt_build_bvh.restype = ctypes.c_int
            lib.pt_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.pt_build_sah_treelets.restype = ctypes.c_int
            lib.pt_build_sah_treelets.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray):
    """C++ build; returns (node_min, node_max, skip, prim, depth) or None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    P = pmin.shape[0]
    N = 2 * P - 1
    node_min = np.empty((N, 3), np.float32)
    node_max = np.empty((N, 3), np.float32)
    skip = np.empty(N, np.int32)
    prim = np.empty(N, np.int32)
    depth = ctypes.c_int32(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.pt_build_bvh(
        pmin.ctypes.data_as(fp), pmax.ctypes.data_as(fp),
        ctypes.c_int64(P),
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        skip.ctypes.data_as(ip), prim.ctypes.data_as(ip),
        ctypes.byref(depth))
    if rc != 0:
        return None
    return node_min, node_max, skip, prim, int(depth.value)


def build_sah_treelets_native(prim_min: np.ndarray, prim_max: np.ndarray,
                              leaf_size: int):
    """C++ binned-SAH treelet build (native/sah_treelets.cpp); returns the
    models/sah.py::SAHTreelets field tuple (node_min, node_max, skip,
    leaf_of_node, order, leaf_start, leaf_count, depth) or None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    P = int(pmin.shape[0])
    N = 2 * P - 1 if P > 1 else 1
    node_min = np.empty((N, 3), np.float32)
    node_max = np.empty((N, 3), np.float32)
    skip = np.empty(N, np.int32)
    leaf_of = np.empty(N, np.int32)
    order = np.empty(P, np.int64)
    leaf_start = np.empty(P, np.int64)
    leaf_count = np.empty(P, np.int64)
    counts = np.zeros(3, np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    rc = lib.pt_build_sah_treelets(
        pmin.ctypes.data_as(fp), pmax.ctypes.data_as(fp),
        ctypes.c_int64(P), ctypes.c_int64(leaf_size),
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        skip.ctypes.data_as(ip), leaf_of.ctypes.data_as(ip),
        order.ctypes.data_as(lp), leaf_start.ctypes.data_as(lp),
        leaf_count.ctypes.data_as(lp), counts.ctypes.data_as(lp))
    if rc != 0:
        return None
    n, b, depth = int(counts[0]), int(counts[1]), int(counts[2])
    return (node_min[:n].copy(), node_max[:n].copy(), skip[:n].copy(),
            leaf_of[:n].copy(), order, leaf_start[:b].copy(),
            leaf_count[:b].copy(), depth)
