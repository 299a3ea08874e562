"""ctypes binding of the host BVH builder (csrc/host/rtvs_native.cpp).

Restates raytracevs_tpu/io/native.py (``build_bvh_native``) for the port,
and binds the port's own collapse into wide nodes (``collapse_bvh_native``).
The library is compiled by g++ at first use, with the flags of the JAX
package's csrc/Makefile, into raytracevs_tpu_torch/_build/ (named by a hash
of the source and flags, so an edited source rebuilds). There is no numpy
fallback: the JAX package's median-split fallback builds a different tree,
so a missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "rtvs_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def find_cxx() -> str:
    """The C++ compiler: $CXX, else g++ from PATH; raises if none."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the host BVH builder cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librtvs_native_{h.hexdigest()[:16]}.so")


def build(path: str) -> None:
    """Compile the builder into `path` (a temp file, then an atomic rename)."""
    cxx = find_cxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed with exit code {proc.returncode}:\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, path)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The builder's library, compiled first if this source has none."""
    path = library_path()
    if not os.path.exists(path):
        build(path)
    lib = ctypes.CDLL(path)
    lib.rtvs_build_bvh.restype = ctypes.c_int
    lib.rtvs_build_bvh.argtypes = [_FP, _FP, _FP, ctypes.c_int, ctypes.c_int,
                                   _FP, _FP, _IP, _IP, _IP, _IP, _IP]
    lib.rtvs_collapse_bvh.restype = ctypes.c_int
    lib.rtvs_collapse_bvh.argtypes = [_IP, _IP, _IP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      _IP, _IP, _IP]
    return lib


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int):
    """Binned-SAH threaded BVH over triangles [T,3] x 3.

    Returns (bbox_min, bbox_max, hit_next, miss_next, tri_start, tri_count,
    tri_order); raises if the library cannot be built or the build fails."""
    lib = load_library()
    t = len(v0)
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    if not (v0.shape == v1.shape == v2.shape == (t, 3)):
        raise ValueError(f"build_bvh_native: triangle arrays {v0.shape} {v1.shape} {v2.shape}")
    cap = max(2 * t, 1)
    bbox_min = np.zeros((cap, 3), np.float32)
    bbox_max = np.zeros((cap, 3), np.float32)
    hit_next = np.zeros(cap, np.int32)
    miss_next = np.zeros(cap, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    tri_order = np.zeros(t, np.int32)

    def fp(a):
        return a.ctypes.data_as(_FP)

    def ip(a):
        return a.ctypes.data_as(_IP)

    n_nodes = lib.rtvs_build_bvh(fp(v0), fp(v1), fp(v2), t, leaf_size, fp(bbox_min),
                                 fp(bbox_max), ip(hit_next), ip(miss_next), ip(tri_start),
                                 ip(tri_count), ip(tri_order))
    if n_nodes <= 0:
        raise RuntimeError(f"rtvs_build_bvh failed ({n_nodes}) on {t} triangles, "
                           f"leaf size {leaf_size}")
    s = slice(0, n_nodes)
    return (bbox_min[s], bbox_max[s], hit_next[s], miss_next[s], tri_start[s], tri_count[s],
            tri_order)


def collapse_bvh_native(tri_start: np.ndarray, tri_count: np.ndarray, miss_next: np.ndarray,
                        root: int, wide: int):
    """The wide nodes of the threaded tree at fine node `root` (rtvs_collapse_bvh).

    Returns (child [W,wide] i32, src [W,wide] i32, need); raises if the
    library cannot be built or the arrays are not a threaded tree."""
    lib = load_library()
    n = len(miss_next)
    tri_start, tri_count, miss_next = (np.ascontiguousarray(a, np.int32)
                                       for a in (tri_start, tri_count, miss_next))
    if not (tri_start.shape == tri_count.shape == miss_next.shape == (n,)):
        raise ValueError(f"collapse_bvh_native: node arrays {tri_start.shape} "
                         f"{tri_count.shape} {miss_next.shape}")
    child = np.empty((n, wide), np.int32)
    src = np.empty((n, wide), np.int32)
    need = np.zeros(1, np.int32)
    ip = (lambda a: a.ctypes.data_as(_IP))
    count = lib.rtvs_collapse_bvh(ip(tri_start), ip(tri_count), ip(miss_next), n, int(root),
                                  wide, ip(child), ip(src), ip(need))
    if count <= 0:
        raise RuntimeError(f"rtvs_collapse_bvh failed ({count}) on {n} nodes, root {root}")
    return child[:count].copy(), src[:count].copy(), int(need[0])
