"""Build the CUDA kernels of csrc/ into one shared library and load it.

The sources are compiled by nvcc for sm_90a into a plain-C shared library,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library lands in raytracevs_tpu_torch/_build/, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. The build runs at the first kernel launch of a process, never at
import. A missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# --fmad=false: no fused multiply-adds, so each kernel rounds exactly as its
# plain PyTorch version (separate mul and add kernels) does on the card.
# -Xptxas -v: registers, spills and local memory per kernel, kept in the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library's entry points: (argtypes), all return int
# (a cudaError_t; 0 is success).
SIGNATURES = {
    # ftab, itab, out, width, height, S, P, B, L, spp, max_bounces,
    # max_iters, max_soft, flags, aspect, stream
    "rtvs_render_accum": (_P, _P, _P) + (_I,) * 11 + (_F, _P),
    # state, curr, motion, motion_spec, view_z, roughness, out, H, W, stream
    "rtvs_reproject_accumulate": (_P,) * 7 + (_I,) * 2 + (_P,),
    # img6, out6, H, W, stream
    "rtvs_anti_firefly": (_P, _P, _I, _I, _P),
    # img6, view_z, normal3, guide2, out6, H, W, stride, stream
    "rtvs_atrous_pass": (_P,) * 5 + (_I,) * 3 + (_P,),
    # shadow2, obj_id, view_z, normal3, out2, H, W, stream
    "rtvs_shadow_denoise": (_P,) * 5 + (_I,) * 2 + (_P,),
}


def find_nvcc() -> str:
    """nvcc from PATH, $CUDA_HOME/bin or /usr/local/cuda/bin; raises if none."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librtvs_kernels_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    return library_path()[:-3] + ".log"


def build(path: str) -> None:
    """Compile every csrc/*.cu into `path` (atomically: a temp file, then rename)."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cus = [p for p in _sources() if p.endswith(".cu")]
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *cus]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = path[:-3] + ".log"
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode} (log {log}):\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, path)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if this source state has none."""
    path = library_path()
    if not os.path.exists(path):
        build(path)
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
