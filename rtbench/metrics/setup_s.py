"""setup_s: seconds from the start of the process to the first timed frame:
imports, the kernels' build or load, the Engine, the meshes and the scene,
the first update_scene (SAH builds) and the warm-up frames."""


def read(run):
    return run.setup_s
