"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch pipeline (scene sanitize and flatten, the host BVH builder and its
C++ source, the plain render, frame assembly, denoiser, composite and tone
map), taken from raytracevs_tpu_torch at the commit that added the
benchmark and trimmed to the single-device frame. It imports nothing of the
port or of the JAX package, builds its own scene tables and BVH, and runs
on whatever device its scene tensors live on. ``frame.Replay`` follows the
Engine's update_scene/render semantics on these plain stages.
"""
