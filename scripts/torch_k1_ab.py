"""The render kernels K1, K1-mesh, K7 and K8, the photon trace K5 and the
denoiser's K3 and K4 of this tree against another checkout's, on one CUDA
card, and the host's scene update of both.

Builds the kernel library of another checkout of the port (for example the
parent commit, unpacked with `git archive`) and of this tree, each from cold
into a directory of its own, both builds started together, and times each.
It loads the other checkout's package under another name beside this one, so
each library is called through its own wrappers and tables, and times
(chip_smoke.py's scenes, 1920x1080): K1 on the demo scene and K1-mesh on
the mesh demo scene at spp 2 and spp 1, K7 and K8 on both at spp 1 (K8 on
its own tree's K7 planes and sorted order), and K5 on the demo scene at its
16,384 photons (the launch alone, of a tree whose K5 emits in the kernel
or of one whose K5 takes emission's tensors), the photon pass as each
tree's frame runs it (the emission and K5, ops/photon.py::
trace_photon_slice, on the frame's tables where that tree's K5 takes
them; then K6 and the fold-in of the caustic into the colour and
diffuse planes, or K6 adding it into them in place), K3 (atrous) and
K4 (shadow_denoise) on the 1080p G-buffer
of chip_smoke.py's phase 4 (one wrapper call each: one launch, or as many
as that checkout's wrapper makes), and K3-pass's three passes (stride 1
with the clamp, 2, 4) on the second of four 270-row slabs of it as each
tree's sharded denoise runs them (its slab form, the neighbours' rows as
views; or, where the tree has none, the whole-frame form on the slab
extended by the pass's reach, its rows cropped after the timed call),
with the device's time alone of each, calling the libraries in turns (other,
this, then back) for `--rounds` rounds: each render call is one call of
that tree's public wrapper (render_accum, render_phase_a, render_phase_b)
on tables packed beforehand, one launch with the wrapper's host work (its
checks and the output's allocation, tens of microseconds), timed by CUDA
events. Every call's planes must equal the first call's bit for bit.

Then the host, each tree in turns, the device synchronised around each
call: frame 0 of the mesh demo scene in a new Engine (update_scene with
the SAH builds, and in this tree the collapse into wide nodes), three
times; then `--frames` orbiting frames (update_scene, which retransforms,
and to_device alone), with each frame's difference this - other of their
sum; then this tree's parts: to_device's uploads and gathers, the
collapse of the 199,712-triangle BLAS alone, and the wide table's work a
frame (the kept combined table's check and the box gather).

With --stages N, it then times each stage of a 1080p frame of the five
columns of chip_smoke.py's phase 7 (analytic, mesh, caustics, mesh spp 1,
two-phase mesh spp 1), N orbiting frames a column, through each tree's
own chip_smoke.py::stage_times in a process of its own, the trees in
turns (other, this, this, other, other, this), and prints each stage's
median over frames 1..N-1 in each run, the median of a tree's three
runs, and each column's sum of those, with and without update_scene
(the host's, whose time spreads most between processes).

It prints each time, the median and range per library, ptxas's
registers, stack, spills and shared memory of the render and denoiser
kernels in each build, the card's name and power limit, and as its last
line a JSON object of the results.

    python3 scripts/torch_k1_ab.py --other DIR [--rounds 5] [--frames 40] [--cases REGEX]
                                   [--stages N]

--cases keeps the kernel cases whose label matches the regular expression
(for example '^K7', '^K[34]' or 'demo scene, spp 2'; all by default);
--frames 0 skips the host's part.

It needs one CUDA device, nvcc, and the other checkout at DIR (with its
chip_smoke.py for --stages).
"""
import argparse
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# Run in a checkout: build its library from cold into argv[1].
BUILD = r"""
import json, shutil, sys, time
from raytracevs_tpu_torch.ops.cuda import _build as B
out = sys.argv[1]
shutil.rmtree(out, ignore_errors=True)
B.BUILD_DIR = out
t0 = time.perf_counter()
B.load_library()
print(json.dumps({"path": B.library_path(), "s": time.perf_counter() - t0}))
"""
KERNELS = ("render_accum_kernel", "render_phase_b_kernel", "photon_trace_kernel",
           "photon_gather_kernel", "atrous_kernel", "atrous_pass_kernel", "anti_firefly_kernel",
           "shadow_kernel")
# a kernel's name in a mangled symbol: its length before it, then E or I
KERNEL_RE = re.compile(r"\d(%s)[EI]" % "|".join(KERNELS))


# Run in a checkout: phase 7's stage times of the five columns, as JSON.
STAGES = r"""
import json, sys
import chip_smoke as CS
import raytracevs_tpu_torch as P
from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
from raytracevs_tpu_torch.ops.cuda import megakernel as MK
from raytracevs_tpu_torch.post import denoise as PD
from raytracevs_tpu_torch.scene import data as D
frames = int(sys.argv[1])
cols = {"analytic": ((CS.demo_scene,), {}), "mesh": ((CS.mesh_demo_scene, CS.MESH_DEMO), {}),
        "caustics": ((CS.demo_scene,), {"overrides": CS.CAUSTICS}),
        "mesh spp 1": ((CS.mesh_demo_scene, CS.MESH_DEMO, CS.SPP1), {}),
        "two-phase mesh spp 1": ((CS.mesh_demo_scene, CS.MESH_DEMO, CS.SPP1),
                                 {"two_phase": True})}
print(json.dumps({k: CS.stage_times(P, D, MK, K, PD, frames, *a, **kw)
                  for k, (a, kw) in cols.items()}))
"""
# Run in a checkout: build its kernel library where its Engine loads it from.
BUILD_DEFAULT = r"""
from raytracevs_tpu_torch.ops.cuda import _build
_build.load_library()
"""


def stages_ab(trees, frames):
    """Phase 7's stage times of each tree (the module docstring), in turns;
    prints them and returns {tree: {column: {stage: [median a run]}}}."""
    for p in [subprocess.Popen([sys.executable, "-c", BUILD_DEFAULT], cwd=t)
              for t in trees.values()]:
        if p.wait() != 0:
            raise RuntimeError("a tree's kernel build failed")
    runs = {tn: [] for tn in trees}
    for tn in ("other", "this", "this", "other", "other", "this"):
        proc = subprocess.run([sys.executable, "-c", STAGES, str(frames)], cwd=trees[tn],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"stage times of {tn} failed: {proc.stderr[-3000:]}")
        runs[tn].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    out = {tn: {} for tn in trees}
    for col in runs["this"][0]:
        sums = {}
        for tn in trees:
            meds = {}
            for run in runs[tn]:
                for stage, ms in run[col].items():
                    meds.setdefault(stage, []).append(statistics.median(ms[1:]))
            out[tn][col] = meds
            for stage, m in meds.items():
                print(f"stages {col}, {tn}: {stage}: median {statistics.median(m):.3f} ms "
                      f"(runs {[round(x, 3) for x in m]})", flush=True)
            sums[tn] = [sum(statistics.median(m) for st, m in meds.items()
                            if not st.startswith("compare:")
                            and (keep or not st.startswith("update_scene"))) for keep in (1, 0)]
        for i, what in enumerate(("", " without update_scene")):
            a, b = sums["other"][i], sums["this"][i]
            print(f"stages {col}: sum of stage medians{what} other {a:.3f} ms, this {b:.3f} ms, "
                  f"this - other {b - a:.3f} ms ({b / a:.4f})", flush=True)
    return out


def start_build(tree, name):
    out = os.path.join(tree, "raytracevs_tpu_torch", "_build", f"ab_{name}")
    return subprocess.Popen([sys.executable, "-c", BUILD, out], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_build(proc):
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def ptxas(log):
    """(kernel, ptxas's lines on its registers and stack) per kernel of KERNELS."""
    rows, entry, props = [], None, ""
    with open(log) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                entry = name if KERNEL_RE.search(name) else None
            elif entry and "Function properties" in line:
                props = ""
            elif entry and ("stack frame" in line):
                props = line.split(":", 1)[-1].strip()
            elif entry and "registers" in line:
                rows.append((entry, f"{line.split(':', 1)[1].strip()}; {props}"))
                entry = None
    return rows


def load_tree(path, alias):
    """The port's package of the checkout at `path`, imported as `alias`."""
    pkg = os.path.join(path, "raytracevs_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def load_lib(MK, path):
    import ctypes

    lib = ctypes.CDLL(path)
    for name, argtypes in MK._build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def timed(build, lib, fn):
    """(fn(), ms) with package module `build` (its ops.cuda._build) handing
    out library `lib`, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    saved = build.load_library
    build.load_library = lambda: lib
    try:
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        build.load_library = saved
    return out, start.elapsed_time(end)


class Tree:
    """One checkout's package, its scenes on the card and its library."""

    def __init__(self, pkg, CS):
        self.P = pkg
        name = pkg.__name__
        self.MK = importlib.import_module(f"{name}.ops.cuda.megakernel")
        self.R = importlib.import_module(f"{name}.ops.render")
        self.TP = importlib.import_module(f"{name}.ops.twophase")
        self.D = importlib.import_module(f"{name}.scene.data")  # its own scene classes
        self.PP = importlib.import_module(f"{name}.ops.photon")
        self.PK = importlib.import_module(f"{name}.ops.cuda.photon_kernels")
        self.K = importlib.import_module(f"{name}.ops.cuda.denoise_kernels")
        self.PD = importlib.import_module(f"{name}.post.denoise")
        self.meshes = CS.TS.mesh_service(importlib.import_module(f"{name}.io.mesh_cache"),
                                         CS.MESH_DEMO)
        self.cache = pkg.BLASCache()
        self.lib = None

    def scene(self, CS, build, meshes):
        P = self.P
        s = build(self.D, 0)
        flat = P.flatten_scene(P.sanitize_scene(s), aspect=CS.FULL_W / CS.FULL_H,
                               mesh_service=self.meshes if meshes else None,
                               blas_cache=self.cache)
        return s, P.to_device(flat, torch.device("cuda"))


def photon_case(entry, tree, sc, cfg, tables):
    """(before, fn, finish) of a photon case for one tree: fn() the timed
    call as that tree's frame makes it, before() what must run ahead of it
    untimed, finish(fn's result) the output compared across trees. A tree
    whose K5 emits in the kernel and whose K6 adds into the planes in place
    has photon_kernels.add_caustics; the parent's K5 takes emission's
    tensors and its K6 returns the caustic, which the frame folds in."""
    fused = hasattr(tree.PK, "add_caustics")
    n, spp, dev = cfg.num_photons, cfg.samples_per_pixel, sc.cam_pos.device

    def stores(out):  # the stored photons' fields (the rest is not written)
        m = out[4]
        return torch.cat([out[c][m].reshape(-1) for c in range(4)] + [m.float()])

    def nothing():
        pass

    if entry == "photon_trace":  # the launch alone
        outs = ([torch.empty((n, 3), device=dev) for _ in range(3)]
                + [torch.empty((n,), device=dev), torch.empty((n,), dtype=torch.bool, device=dev)])
        em = ()
        if fused:
            ptrs = [tables[0].data_ptr(), tables[1].data_ptr(), sc.sphere_capacity,
                    sc.plane_capacity, sc.box_capacity, sc.mat_color.shape[0],
                    sc.light_capacity, n, 0, n]
        else:
            em = tree.PP._emit_photons(sc, n) + (torch.arange(n, dtype=torch.int32, device=dev),)
            ptrs = [tables[0].data_ptr(), sc.sphere_capacity, sc.plane_capacity,
                    sc.box_capacity, sc.mat_color.shape[0], sc.light_capacity, n,
                    *(x.data_ptr() for x in em)]
        ptrs += [x.data_ptr() for x in outs]

        def launch():  # em and outs, behind the pointers, live as long as it
            stream = torch.cuda.current_stream().cuda_stream
            return tree.lib.rtvs_photon_trace(*ptrs, stream), em, outs

        return nothing, launch, lambda _: stores(outs)
    if entry == "photon_pass_trace":  # emission and K5 as the frame runs them
        if fused:
            return nothing, lambda: tree.PP.trace_photon_slice(sc, n, 0, n, tables), stores
        return nothing, lambda: tree.PP.trace_photon_slice(sc, n, 0, n), stores
    # K6: with the fold-in as the frame runs it (photon_pass_gather), or
    # alone, the parent's fold-in after the timed call (photon_k6)
    acc = tree.MK.render_accum(sc, cfg, tables=tables)
    pmap = tree.PP.emit_and_trace(sc, n)
    if fused:
        work = acc.clone()
        return (lambda: work.copy_(acc), lambda: tree.PK.add_caustics(pmap, work, spp),
                lambda _: torch.cat([work[0:3], work[6:9]]) + 0.0)
    if entry == "photon_pass_gather":
        def fold():
            delta = tree.PK.gather(pmap, acc, spp)
            return acc[0:3] + delta, acc[6:9] + delta

        return nothing, fold, lambda planes: torch.cat(planes) + 0.0
    return (nothing, lambda: tree.PK.gather(pmap, acc, spp),
            lambda delta: torch.cat([acc[0:3] + delta, acc[6:9] + delta]) + 0.0)


def k3_pass_case(tree, k3, p):
    """(before, fn, finish) of a-trous pass p (the module docstring) for one
    tree, on k3 = (img6, view_z, normal, guide) of the 1080p G-buffer."""
    img, view_z, normal, guide = k3
    stride, clamp = 1 << p, p == 0
    reach = stride + int(clamp)
    h = view_z.shape[0]
    rows = row0 = h // 4

    def nothing():
        pass

    if hasattr(tree.K, "atrous_pass_slab"):
        slabs = [img[:, i * rows:(i + 1) * rows].contiguous() for i in range(4)]
        r = tree.PD.ATROUS_REACH
        aux = torch.cat([view_z[None], normal, guide])[:, row0 - r:row0 + rows + r].contiguous()
        args = (slabs[1], slabs[0][:, rows - reach:], slabs[2][:, :reach], aux[0], aux[1:4],
                aux[4:6], row0, h, stride, clamp)
        return nothing, lambda: tree.K.atrous_pass_slab(*args), lambda out: out
    ext = [t[..., row0 - reach:row0 + rows + reach, :].contiguous() for t in k3]
    return (nothing, lambda: tree.K.atrous_pass(*ext, stride, clamp),
            lambda out: out[:, reach:reach + rows].contiguous())


def host_ab(trees, CS, frames):
    """The host's scene update of each tree in turns (the module
    docstring's second part), the device synchronised around each call;
    prints each time and returns them."""

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def show(label, ts):
        print(f"{label}: median {statistics.median(ts):.3f} ms ({[round(x, 3) for x in ts]})",
              flush=True)

    engines, first = {}, {tn: [] for tn in trees}
    for r in range(3):  # frame 0 in a new Engine: the SAH builds (and collapses)
        for tn in (("other", "this") if r % 2 == 0 else ("this", "other")):
            tree = trees[tn]
            eng = tree.P.Engine(CS.FULL_W, CS.FULL_H, device="cuda", mesh_service=tree.meshes)
            scene0 = CS.mesh_demo_scene(tree.D, 0)
            first[tn].append(host_ms(lambda: eng.update_scene(scene0, **CS.OVERRIDES)))
            engines[tn] = eng
    upd = {tn: [] for tn in trees}
    dev = {tn: [] for tn in trees}
    for f in range(1, 1 + frames):
        for tn in (("other", "this") if f % 2 else ("this", "other")):
            eng, tree = engines[tn], trees[tn]
            scene = CS.mesh_demo_scene(tree.D, f)
            upd[tn].append(host_ms(lambda: eng.update_scene(scene, **CS.OVERRIDES)))
            dev[tn].append(host_ms(lambda: tree.P.to_device(eng._flat, eng.device)))
    diff = [(upd["this"][i] + dev["this"][i]) - (upd["other"][i] + dev["other"][i])
            for i in range(frames)]
    # this tree's parts: to_device's uploads and gathers, the collapse of
    # the largest BLAS, the wide table's work a frame
    import types

    import raytracevs_tpu_torch.ops.bvh as B

    eng = engines["this"]
    mesh, d = eng._flat.mesh, eng.device
    big = eng._blas_cache._cache["BigSphere"][1]  # (fingerprint, object-space BLAS)
    kept = [types.SimpleNamespace(wide=w) for w in eng._blas_cache._combined[0]]
    dm = B.to_device(mesh, d, 4.0)
    topo, union = mesh.wide_topology.on(d)
    parts = {"to_device": lambda: B.to_device(mesh, d, 4.0),
             "topology upload": lambda: torch.from_numpy(np.concatenate(
                 [mesh.wide_topology.child, mesh.wide_topology.src], axis=1)).to(d),
             "fine uploads": lambda: [torch.from_numpy(np.ascontiguousarray(
                 getattr(mesh, f))).to(d) for f in B.FINE_FIELDS],
             "wide_table": lambda: B.wide_table(topo, union, dm.bbox_min, dm.bbox_max),
             "wide work a frame (combined_wide kept + wide_table)": lambda: (
                 eng._blas_cache.combined_wide(kept),
                 B.wide_table(*mesh.wide_topology.on(d), dm.bbox_min, dm.bbox_max)),
             f"collapse of the {len(big.v0)}-triangle BLAS": lambda: B.collapse(
                 big.tri_start, big.tri_count, big.miss_next)}
    for name, fn in parts.items():
        show(f"host this, {name}", [host_ms(fn) for _ in range(10)])
    host = {}
    for tn in trees:
        host[tn] = {"first_update_scene_ms": first[tn], "update_scene_ms": upd[tn],
                    "to_device_ms": dev[tn]}
        show(f"host {tn}, frame 0 update_scene (SAH builds)", first[tn])
        show(f"host {tn}, update_scene", upd[tn])
        show(f"host {tn}, to_device", dev[tn])
    q = statistics.quantiles(diff, n=4)
    print(f"host this - other, update_scene + to_device a frame: median {statistics.median(diff):.3f}"
          f" ms, quartiles {q[0]:.3f} / {q[2]:.3f} ms over {len(diff)} frames", flush=True)
    host["diff_ms"] = diff
    return host


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=40,
                    help="orbiting frames a tree (0: no host part)")
    ap.add_argument("--cases", default="", help="a regular expression of case labels to keep")
    ap.add_argument("--stages", type=int, default=0,
                    help="orbiting frames a column of phase 7's stage times (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ab: torch.cuda.is_available() is False; this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    other = os.path.abspath(args.other)

    names = ["other", "this"]
    procs = {n: start_build(other if n == "other" else HERE, n) for n in names}
    builds = {n: finish_build(p) for n, p in procs.items()}
    for name, b in builds.items():
        print(f"build {name}: {b['s']:.1f} s -> {b['path']}", flush=True)
        for entry, regs in ptxas(b["path"][:-3] + ".log"):
            print(f"ptxas {name} {entry}: {regs}", flush=True)

    import chip_smoke as CS
    import raytracevs_tpu_torch as this_pkg

    trees = {"other": Tree(load_tree(other, "rtvs_other"), CS), "this": Tree(this_pkg, CS)}
    for n, tree in trees.items():
        tree.lib = load_lib(tree.MK, builds[n]["path"])

    cases = []  # (label, entry, build, meshes, overrides)
    for label, build, meshes in (("demo scene", CS.demo_scene, False),
                                 ("mesh demo scene", CS.mesh_demo_scene, True)):
        k1 = "K1-mesh" if meshes else "K1"
        cases += [(f"{k1}, {label}, spp 2", "rtvs_render_accum", build, meshes, CS.OVERRIDES),
                  (f"{k1}, {label}, spp 1", "rtvs_render_accum", build, meshes, CS.SPP1),
                  (f"K7, {label}, spp 1", "rtvs_render_phase_a", build, meshes, CS.SPP1),
                  (f"K8, {label}, spp 1", "rtvs_render_phase_b", build, meshes, CS.SPP1)]
    cases += [("K5, demo scene, 16384 photons", "photon_trace", CS.demo_scene, False,
               CS.CAUSTICS),
              ("photon pass: emission and K5, demo scene, 16384 photons", "photon_pass_trace",
               CS.demo_scene, False, CS.CAUSTICS),
              ("photon pass: K6 and the fold-in, demo scene 1920x1080, spp 2",
               "photon_pass_gather", CS.demo_scene, False, CS.CAUSTICS),
              ("K6 alone, demo scene 1920x1080, spp 2", "photon_k6", CS.demo_scene, False,
               CS.CAUSTICS)]
    cases += [(f"{k}, demo scene G-buffer 1920x1080", entry, None, False, None)
              for k, entry in (("K3 atrous", "atrous"), ("K4 shadow_denoise", "shadow_denoise"))]
    cases += [(f"K3-pass stride {1 << p}{' with the clamp' if p == 0 else ''}, rows 270-539 of "
               "the demo scene G-buffer 1920x1080", f"k3_pass_{p}", None, False, None)
              for p in range(3)]
    cases = [c for c in cases if re.search(args.cases, c[0])]
    results, mismatched = {}, []
    denoise_entries = ("atrous", "shadow_denoise", "k3_pass_0", "k3_pass_1", "k3_pass_2")
    order = names + names[::-1]
    denoise = None  # K3's and K4's arguments, made once by this tree
    for label, entry, build, meshes, over in cases:
        prep = {}
        if entry in denoise_entries and denoise is None:
            t = trees["this"]
            k3, k4 = timed(t.MK._build, t.lib, lambda: CS.denoise_inputs(
                t.P, t.D, t.PD, t.K, torch.device("cuda")))[0][2:]
            denoise = {"atrous": k3, "shadow_denoise": k4}
        if entry.startswith("k3_pass"):
            prep = {tn: (tree, None, None, None,
                         k3_pass_case(tree, denoise["atrous"], int(entry[-1])))
                    for tn, tree in trees.items()}
        for tn, tree in ({} if entry in denoise_entries else trees).items():
            s, sc = tree.scene(CS, build, meshes)
            cfg = tree.P.make_config(s, CS.FULL_W, CS.FULL_H, **over)
            tables = tree.MK.pack_tables(sc)
            extra = None
            if entry.startswith("photon"):
                extra = photon_case(entry, tree, sc, cfg, tables)
            if entry == "rtvs_render_phase_b":
                a = tree.MK.render_phase_a(sc, cfg, tables)
                o, c = tree.TP.coherence_order(a)
                # K8 takes K7's hit planes where its tree's K7 writes them
                hits = [a[tree.R.CH_HIT:]] if hasattr(tree.R, "CH_HIT") else []
                extra = (a[:tree.R.NUM_CH].clone(), o, c, hits)
            prep[tn] = (tree, sc, cfg, tables, extra)

        def call(n):
            if entry in ("atrous", "shadow_denoise"):
                tree = trees[n]
                fn = getattr(tree.K, entry)
                return timed(tree.MK._build, tree.lib, lambda: fn(*denoise[entry]))
            tree, sc, cfg, tables, extra = prep[n]
            MK = tree.MK
            if entry.startswith(("photon", "k3_pass")):
                before, fn, finish = extra
                before()
                v, t = timed(MK._build, tree.lib, fn)
                return finish(v), t
            if entry == "rtvs_render_phase_b":
                acc0, o, c, hits = extra
                out = acc0.clone()
                return timed(MK._build, tree.lib,
                             lambda: MK.render_phase_b(sc, cfg, o, c, out, *hits, tables=tables))
            if entry == "rtvs_render_phase_a":
                return timed(MK._build, tree.lib, lambda: MK.render_phase_a(sc, cfg, tables))
            return timed(MK._build, tree.lib, lambda: MK.render_accum(sc, cfg, tables=tables))

        ref, _ = call(names[0])  # warm-up
        for n in names[1:]:
            call(n)
        times = {n: [] for n in names}
        differ = set()  # planes unlike the first call's, by their bits (K7's hold ints)
        for _ in range(args.rounds):
            for n in order:
                out, t = call(n)
                k = min(out.shape[0], ref.shape[0])
                same = (out[:k].view(torch.int32) == ref[:k].view(torch.int32)).reshape(k, -1)
                differ |= {i for i in range(k) if not bool(same[i].all())}
                times[n].append(t)
                del out
        if differ:
            print(f"{label}: the libraries' planes {sorted(differ)} differ", flush=True)
            mismatched.append(label)
        med = {n: statistics.median(ts) for n, ts in times.items()}
        for n, ts in times.items():
            print(f"{label}: {n} median {med[n]:.4f} ms, range {min(ts):.4f}-{max(ts):.4f} ms "
                  f"over {len(ts)} launches", flush=True)
        print(f"{label}: this / other {med['this'] / med['other']:.4f}; planes bit-equal "
              f"{not differ}", flush=True)
        results[label] = dict(times, median=med)
        if entry.startswith(("photon", "k3_pass")):
            # the device's time alone, by chip_smoke.device_ms, in turns
            dev = {n: [] for n in names}
            for _ in range(args.rounds):
                for n in order:
                    tree, extra = prep[n][0], prep[n][4]
                    extra[0]()
                    dev[n].append(timed(tree.MK._build, tree.lib,
                                        lambda: CS.device_ms(extra[1], 20))[0][0])
            for n in names:
                print(f"{label}: {n} device median {statistics.median(dev[n]):.4f} ms, range "
                      f"{min(dev[n]):.4f}-{max(dev[n]):.4f} ms over {len(dev[n])} profiles of 20 "
                      "calls", flush=True)
            med_dev = {n: statistics.median(d) for n, d in dev.items()}
            results[label]["device_ms"] = med_dev
            print(f"{label}: device this / other {med_dev['this'] / med_dev['other']:.4f}",
                  flush=True)
        del prep, ref

    if mismatched:
        raise AssertionError(f"the libraries' planes differ in {mismatched}")
    host = host_ab(trees, CS, args.frames) if args.frames > 0 else None
    stages = stages_ab({"other": other, "this": HERE}, args.stages) if args.stages > 0 else None
    print(smi)
    print(json.dumps({"card": smi, "build_s": {n: b["s"] for n, b in builds.items()},
                      "kernels": results, "host": host, "stages": stages}))


if __name__ == "__main__":
    sys.exit(main())
