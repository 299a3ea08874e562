"""K1 and K1-mesh of this tree against another checkout's, on one CUDA card.

Builds the kernel library of this tree and of another checkout of the port
(for example the parent commit, unpacked with `git archive`), each from cold
into a directory of its own, and times each build; then builds this tree's
sources once more with a single nvcc for all files, the other way to build
them, and times that. It loads both libraries into one process and times
kernel K1 on the demo scene and K1-mesh on the mesh demo scene
(chip_smoke.py's scenes) at 1920x1080, spp 2 and spp 1, calling the two
libraries in turns (other, this, this, other) for `--rounds` rounds: each
call is one launch on tables packed beforehand, timed by CUDA events. Every
call's planes must equal the first call's bit for bit. It prints each
time, the median and range per library, ptxas's registers and stack for
K1's instantiations in each build, the card's name and power limit, and
as its last line a JSON object of the results.

    python3 scripts/torch_k1_ab.py --other DIR [--rounds 5]

It needs one CUDA device, nvcc, and the other checkout at DIR.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# Run in a checkout: build its library from cold into argv[1], with its own
# build (mode "own") or with one nvcc for every .cu file ("one_nvcc").
BUILD = r"""
import json, os, shutil, subprocess, sys, time
from raytracevs_tpu_torch.ops.cuda import _build as B
out, mode = sys.argv[1], sys.argv[2]
shutil.rmtree(out, ignore_errors=True)
B.BUILD_DIR = out
if mode == "one_nvcc":
    def build(path):
        os.makedirs(out, exist_ok=True)
        cus = [p for p in B._sources() if p.endswith(".cu")]
        subprocess.run([B.find_nvcc(), *B.NVCC_FLAGS, *B.LINK_FLAGS, "-o", path, *cus],
                       check=True, capture_output=True)
    B.build = build
t0 = time.perf_counter()
B.load_library()
print(json.dumps({"path": B.library_path(), "s": time.perf_counter() - t0}))
"""
ENTRIES = ("rtvs_render_accum", "rtvs_render_accum_mesh")


def build_lib(tree, name, mode):
    out = os.path.join(tree, "raytracevs_tpu_torch", "_build", f"ab_{name}")
    r = subprocess.run([sys.executable, "-c", BUILD, out, mode], cwd=tree, capture_output=True,
                       text=True, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def k1_ptxas(log):
    """(entry, ptxas's line on its registers) for each K1 instantiation."""
    rows, entry = [], None
    with open(log) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "render_accum_kernel" in line else None
            elif entry and "registers" in line:
                rows.append((entry, line.split(":", 1)[1].strip()))
                entry = None
    return rows


def load(path):
    from raytracevs_tpu_torch.ops.cuda import _build

    lib = ctypes.CDLL(path)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def launch_ms(MK, R, lib, sc, cfg, flags, tables):
    """(planes, ms) of one K1 launch from library `lib`, by CUDA events."""
    out = torch.empty((R.NUM_CH, cfg.height, cfg.width), dtype=torch.float32,
                      device=sc.cam_pos.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    saved = MK._build.load_library
    MK._build.load_library = lambda: lib
    try:
        torch.cuda.synchronize()
        start.record()
        MK._launch("rtvs_render_accum", sc, cfg, flags, tables, [out.data_ptr()])
        end.record()
        torch.cuda.synchronize()
    finally:
        MK._build.load_library = saved
    return out, start.elapsed_time(end)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ab: torch.cuda.is_available() is False; this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    other = os.path.abspath(args.other)

    builds = {"other": build_lib(other, "other", "own"), "this": build_lib(HERE, "this", "own"),
              "this_one_nvcc": build_lib(HERE, "this_one_nvcc", "one_nvcc")}
    for name, b in builds.items():
        print(f"build {name}: {b['s']:.1f} s -> {b['path']}", flush=True)
    for name in ("other", "this"):
        for entry, regs in k1_ptxas(builds[name]["path"][:-3] + ".log"):
            print(f"ptxas {name} {entry}: {regs}", flush=True)
    libs = {name: load(builds[name]["path"]) for name in ("other", "this")}

    import chip_smoke as CS
    import raytracevs_tpu_torch as P
    from raytracevs_tpu_torch.ops import render as R
    from raytracevs_tpu_torch.ops.cuda import megakernel as MK
    from raytracevs_tpu_torch.scene import data as D

    dev = torch.device("cuda")
    meshes = CS.mesh_service(CS.MESH_DEMO)
    aspect = CS.FULL_W / CS.FULL_H
    scenes = {"K1, demo scene": (CS.demo_scene(D, 0), None),
              "K1-mesh, mesh demo scene": (CS.mesh_demo_scene(D, 0), meshes)}
    results = {}
    for label, (scene, ms) in scenes.items():
        sc = P.to_device(P.flatten_scene(P.sanitize_scene(scene), aspect=aspect,
                                         mesh_service=ms), dev)
        tables = MK.pack_tables(sc)
        for over in (CS.OVERRIDES, CS.SPP1):
            cfg = P.make_config(scene, CS.FULL_W, CS.FULL_H, **over)
            flags = MK._check(sc, cfg, "torch_k1_ab")
            case = f"{label}, spp {cfg.samples_per_pixel}"
            ref, _ = launch_ms(MK, R, libs["other"], sc, cfg, flags, tables)  # warm-up
            launch_ms(MK, R, libs["this"], sc, cfg, flags, tables)
            times = {"other": [], "this": []}
            same = True
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    out, t = launch_ms(MK, R, libs[name], sc, cfg, flags, tables)
                    same = same and torch.equal(out, ref)
                    times[name].append(t)
                    del out
            del ref
            if not same:
                raise AssertionError(f"{case}: the two libraries' planes differ")
            med = {n: statistics.median(ts) for n, ts in times.items()}
            for n, ts in times.items():
                print(f"{case}: {n} median {med[n]:.4f} ms, range {min(ts):.4f}-{max(ts):.4f} "
                      f"ms over {len(ts)} launches: {[round(x, 4) for x in ts]}", flush=True)
            print(f"{case}: this / other {med['this'] / med['other']:.4f}; planes bit-equal",
                  flush=True)
            results[case] = dict(times, median=med)
        del sc, tables
    print(smi)
    print(json.dumps({"card": smi, "build_s": {n: b["s"] for n, b in builds.items()},
                      "k1": results}))


if __name__ == "__main__":
    sys.exit(main())
