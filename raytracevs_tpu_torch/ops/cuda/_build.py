"""Build the CUDA kernels of csrc/ into one shared library and load it.

The sources are compiled by nvcc for sm_90a, one nvcc per .cu file, all
started together, and linked into a plain-C shared library, loaded with
ctypes (no PyTorch headers, so a build takes seconds). The
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
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library's entry points: (argtypes), all return int
# (a cudaError_t; 0 is success).
# ftab, itab, out, width, height, row0, rows, S, P, B, L, spp, max_bounces,
# max_iters, max_soft, flags, aspect
_ACCUM = (_P, _P, _P) + (_I,) * 13 + (_F,)
# ftab, itab, order, count, acc, hits, lanes, then as _ACCUM from width
_PHASE_B = (_P,) * 6 + (_I,) * 14 + (_F,)
# the mesh tables (nodes, plane, n0, n1, n2, e1, e2, inst, inst_tbl, T, I,
# Nn: nulls and 0 without meshes), threaded, counts [COUNT_ROWS, 4] (null:
# the plain build), stream
_MESH = (_P,) * 9 + (_I,) * 4 + (_P, _P)
SIGNATURES = {
    # K1, K7 (out [46, H, W]) and K8 (megakernel.py::launch_args)
    "rtvs_render_accum": _ACCUM + _MESH,
    "rtvs_render_phase_a": _ACCUM + _MESH,
    "rtvs_render_phase_b": _PHASE_B + _MESH,
    # nodes, plane, inst, inst_tbl, T, I, Nn, threaded, n, o, d, tmin, tmax,
    # skip_active, skip_inst, thick_inst, t, tri, u, v, inst, hit, thick_hit,
    # thick_t, stream
    "rtvs_mesh_closest": (_P,) * 4 + (_I,) * 5 + (_P, _P, _F, _F) + (_P,) * 12,
    # nodes, plane, inst, inst_tbl, T, I, Nn, threaded, n, o, d, max_dist,
    # blocked, vis, color, occ, stream
    "rtvs_mesh_shadow": (_P,) * 4 + (_I,) * 5 + (_P,) * 8,
    # state, curr, motion, motion_spec, view_z, roughness, out, H, W, halo,
    # row0, global_h, stream
    "rtvs_reproject_accumulate": (_P,) * 7 + (_I,) * 5 + (_P,),
    # img6, view_z, normal3, guide2, out6, H, W, stream
    "rtvs_atrous": (_P,) * 5 + (_I,) * 2 + (_P,),
    # img6 and its plane stride, the rows above and below each with theirs,
    # view_z, normal3 and its plane stride, guide2 and its, out6, rows, W,
    # row0, global_h, aux_row0, stride, anti_firefly, stream
    "rtvs_atrous_pass": (_P, _I) * 3 + (_P, _P, _I, _P, _I, _P) + (_I,) * 7 + (_P,),
    # shadow2, obj_id, view_z, normal3, out2, H, W, stream
    "rtvs_shadow_denoise": (_P,) * 5 + (_I,) * 2 + (_P,),
    # curr8, view_z, sqrt_rough, out8, H, W, stream
    "rtvs_reblur_prepass": (_P,) * 4 + (_I,) * 2 + (_P,),
    # acc, cam_right, cam_up, cam_forward, cam_pos, view_proj, prev_view_proj,
    # out30, obj_id, H, W, photon debug mode, 1 / spp, max(max_bounces, 1),
    # width / 2, height / 2, stream
    "rtvs_assemble": (_P,) * 9 + (_I,) * 3 + (_F,) * 4 + (_P,),
    # int out[15]: K3's shared bytes a block, K3's and K4's blocks an SM,
    # then K3-pass's shared bytes and blocks an SM, strides 1, 2, 4, each
    # without and with the clamp
    "rtvs_denoise_occupancy": (_P,),
    # ftab, itab, S, P, B, M, L, total, offset, n, store_pos, store_dir,
    # store_color, store_power, store_mask, stream
    "rtvs_photon_trace": (_P, _P) + (_I,) * 8 + (_P,) * 5 + (_P,),
    # W, H, pos, nrm, hit, metal, trans, ph_pos, ph_dir, ph_col, ph_pow,
    # ph_valid, n, cell_start, cell_count, count, radius, intensity, spp,
    # replace, scale, color, primary, diffuse, specular, shadow, stream
    "rtvs_photon_gather": (_I, _I) + (_P,) * 10 + (_I,) + (_P,) * 5 + (_F, _I, _F)
                          + (_P,) * 6,
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librtvs_kernels_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    return library_path()[:-3] + ".log"


def build(path: str) -> None:
    """Compile every csrc/*.cu, each in its own nvcc started at once, and
    link the objects into `path` (atomically: a temp file, then rename)."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, cu] for cu, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]  # waits for each
    runs = [(c, p.returncode, out, err) for c, p, (out, err) in zip(cmds, procs, outs)]
    if all(rc == 0 for _, rc, _, _ in runs):
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        runs.append((cmd, proc.returncode, proc.stdout, proc.stderr))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    log = path[:-3] + ".log"
    with open(log, "w") as f:
        for cmd, _, out, err in runs:
            f.write(" ".join(cmd) + "\n" + out + err)
    failed = [(cmd, rc, err) for cmd, rc, _, err in runs if rc != 0]
    if failed:
        cmd, rc, err = failed[0]
        raise RuntimeError(f"nvcc failed with exit code {rc} (log {log}): {' '.join(cmd)}\n"
                           + err[-4000:])
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
