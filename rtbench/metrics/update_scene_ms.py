"""update_scene_ms: host ms of Engine.update_scene (sanitize, flatten, the
BLAS cache and retransform, to_device), the harness's clock around each
call, a mean over the traced frames; nothing where no traced frame calls it."""


def read(run):
    times = [f.update_s for f in run.traced_frames if f.update_s is not None]
    return sum(times) * 1e3 / len(times) if times else None
