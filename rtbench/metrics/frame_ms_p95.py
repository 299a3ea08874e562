"""frame_ms_p95: the 95th percentile of every window frame's own time, ms,
from the start of its update_scene (or of its render()) to its RGBA8 array
(statistics.quantiles, exclusive method)."""
import statistics


def read(run):
    times = [(f.end - f.start) * 1e3 for f in run.frames]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100)[94]
