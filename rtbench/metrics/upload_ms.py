"""upload_ms: device ms a frame of the host-to-device copies (the scene's
tables and, where update_scene uploads them, the mesh tables), the
profiler's "Memcpy HtoD" operations over the traced frames."""
from rtbench.core.trace import per_frame

UPLOAD = "Memcpy HtoD"


def read(run):
    if run.trace is None:
        return None
    sec, n = per_frame(run.trace, lambda name: UPLOAD in name)
    return sec * 1e3 if n else None
