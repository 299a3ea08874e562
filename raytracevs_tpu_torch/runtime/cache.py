"""The configured cache directory (the shader cache path's analog).

The reference caches compiled shader bytecode (ShaderCache.h:33-47) under
a path it resolves in tiers (shader_config.ini searched up to 6 directory
levels, then the environment; DXRPipeline.cpp:191-342).
resolve_cache_dir keeps the first two tiers of
raytracevs_tpu/runtime/cache.py::resolve_cache_dir:

1. `rtvs_config.ini` with `jitCachePath=` searched up to 6 levels up from
   `start_dir` (default: the working directory),
2. the `RAYTRACEVS_TPU_CACHE` environment variable.

It serves only a caller that asks for it: the CLI's `--cache-dir` given
without a directory puts the converted-mesh cache of load_rtvs there.
The libraries the port compiles at first use, the CUDA kernels
(ops/cuda/_build.py, nvcc) and the host BVH builder (io/native.py, g++),
are always built in the package's own `_build/` (git-ignored), inside
the checkout: a kernel cannot run unbuilt, and a path outside the
checkout could serve a stale library built for another machine.

The JAX package's third tier, ~/.raytracevs_tpu/jit_cache, names XLA's
optional compilation cache and has no counterpart here, nor has
enable_compilation_cache: nvcc's and g++'s outputs are reused by their
hashed names, with no cache to turn on.
"""
from __future__ import annotations

import os
from typing import Optional


def resolve_cache_dir(start_dir: Optional[str] = None) -> Optional[str]:
    """The configured cache directory (tiers 1 and 2 of the module
    docstring), or None when neither is set."""
    d = os.path.abspath(start_dir or os.getcwd())
    for _ in range(6):
        ini = os.path.join(d, "rtvs_config.ini")
        if os.path.isfile(ini):
            try:
                with open(ini) as f:
                    for line in f:
                        line = line.strip()
                        if line.startswith("jitCachePath="):
                            val = line.split("=", 1)[1].strip()
                            if val:
                                return os.path.expanduser(val)
            except OSError:
                pass
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return os.environ.get("RAYTRACEVS_TPU_CACHE") or None
