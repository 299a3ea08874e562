"""Command-line renderer: .rtvs scene file -> PNG.

The headless equivalent of the reference's RenderWindow toolbar path
(Views/RenderWindow.xaml.cs:244 StartRenderingFromToolbar), with the flags
of raytracevs_tpu/api/cli.py. It renders on the CUDA card through the
kernels, and raises when PyTorch sees none; --cpu runs the plain PyTorch
pipeline on the CPU instead.

Usage:
    python -m raytracevs_tpu_torch.api.cli scene.rtvs -o out.png -W 1920 -H 1080
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Render a .rtvs scene to PNG (PyTorch + CUDA).")
    p.add_argument("scene", help="path to the .rtvs scene file")
    p.add_argument("-o", "--output", default="render.png", help="output PNG path")
    p.add_argument("-W", "--width", type=int, default=1920)
    p.add_argument("-H", "--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    p.add_argument("--bounces", type=int, default=None, help="override max bounces")
    p.add_argument("--frames", type=int, default=1, help="frames to render (timing)")
    p.add_argument("--orbit", type=float, default=None, metavar="DEG",
                   help="animate: rotate the camera DEG degrees per frame "
                        "around the look-at point (temporal denoiser history "
                        "carries across frames via motion-vector "
                        "reprojection, never reset — scene_content_checksum "
                        "excludes the camera exactly like "
                        "DXRPipeline.cpp:2795-2860)")
    p.add_argument("--save-frames", metavar="DIR", default=None,
                   help="write every rendered frame as DIR/frame_NNNN.png "
                        "(batch/animation output; with --frames N)")
    p.add_argument("--caustics", action="store_true",
                   help="enable photon-mapped caustics (the reference's "
                        "causticsEnabled runtime toggle)")
    p.add_argument("--photon-debug", type=int, default=None, metavar="MODE",
                   help="photon debug visualization mode 0-12 (the reference "
                        "UI's P-key cycle, RenderWindow.xaml.cs:628)")
    p.add_argument("--photon-scale", type=float, default=None,
                   help="photon debug brightness scale (reference cycles "
                        "1/4/16)")
    p.add_argument("--denoise", action="store_true", help="enable the denoiser")
    p.add_argument("--debug-view", type=int, default=None, metavar="MODE",
                   help="write a composite debug view 1-10 instead of the "
                        "final frame (Composite.hlsl DebugMode)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the plain PyTorch pipeline) instead of the card")
    p.add_argument("--cache-dir", nargs="?", const="", default=None, metavar="DIR",
                   help="cache converted FBX meshes in DIR/meshcache; without DIR, in "
                        "the directory rtvs_config.ini's jitCachePath= or "
                        "$RAYTRACEVS_TPU_CACHE names (runtime/cache.py); without the "
                        "flag, in the package's _build/meshcache")
    p.add_argument("--json", action="store_true", help="print timing stats as JSON")
    args = p.parse_args(argv)

    from ..runtime.engine import Engine

    overrides = {}
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.bounces is not None:
        overrides["max_bounces"] = args.bounces
    if args.caustics:
        overrides["enable_caustics"] = True
    if args.photon_debug is not None:
        if not 0 <= args.photon_debug <= 12:
            print("error: --photon-debug must be 0-12", file=sys.stderr)
            return 1
        overrides["photon_debug_mode"] = args.photon_debug
    if args.photon_scale is not None:
        overrides["photon_debug_scale"] = args.photon_scale
    if args.denoise:
        overrides["enable_denoiser"] = True

    cache_dir = args.cache_dir
    if cache_dir == "":
        from ..runtime.cache import resolve_cache_dir

        cache_dir = resolve_cache_dir()
    engine = Engine(args.width, args.height, device="cpu" if args.cpu else "cuda")
    try:
        engine.load_rtvs(args.scene, cache_dir, **overrides)
    except FileNotFoundError:
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    def save(img, path):
        try:
            from PIL import Image

            Image.fromarray(img).save(path)
        except ImportError:
            from ..io.png import write_png

            write_png(path, img)

    if args.save_frames:
        import os

        os.makedirs(args.save_frames, exist_ok=True)

    import numpy as np

    base_look = np.asarray(engine._scene.camera.look_at, dtype=float).copy()
    base_rel = (np.asarray(engine._scene.camera.position, dtype=float)
                - base_look)

    def orbit_camera(frame: int):
        """Rotate the frame-0 camera args.orbit*frame degrees around the
        vertical axis through its look-at point, then re-upload. Geometry
        is unchanged, so the engine's content checksum keeps the temporal
        history and the denoiser reprojects (utils/checksum.py)."""
        import math

        ang = math.radians(args.orbit * frame)
        c, s = math.cos(ang), math.sin(ang)
        scene = engine._scene
        scene.camera.position = base_look + np.array(
            [base_rel[0] * c + base_rel[2] * s, base_rel[1],
             -base_rel[0] * s + base_rel[2] * c])
        engine.update_scene(scene, **overrides)

    img = engine.render()  # the first frame includes the kernels' build
    if args.debug_view is not None:
        img = engine.render_debug_view(args.debug_view)
    compile_ms = engine.last_render_ms
    if args.save_frames:
        save(img, f"{args.save_frames}/frame_0000.png")
    times = []
    for f in range(1, max(1, args.frames)):
        if args.orbit is not None:
            orbit_camera(f)
        img = engine.render()
        times.append(engine.last_render_ms)
        if args.debug_view is not None:
            img = engine.render_debug_view(args.debug_view)
        if args.save_frames:
            save(img, f"{args.save_frames}/frame_{f:04d}.png")

    save(img, args.output)

    stats = {
        "output": args.output,
        "width": args.width,
        "height": args.height,
        "first_frame_ms": round(compile_ms, 2),
        "steady_frame_ms": round(sum(times) / len(times), 2) if times else None,
        "rays_per_frame": engine.last_rays,
        "mrays_per_s": round(engine.last_mrays_per_s, 2),
    }
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"wrote {args.output} ({args.width}x{args.height})")
        print(f"first frame {stats['first_frame_ms']} ms (incl. the build); "
              f"steady {stats['steady_frame_ms']} ms; "
              f"{stats['mrays_per_s']} Mrays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
