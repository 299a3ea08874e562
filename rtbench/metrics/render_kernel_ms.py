"""render_kernel_ms: device ms a frame of the render kernels (K1 and
K1-mesh: the port's kernels whose name starts with render_accum), by
torch.profiler over the traced frames."""
from rtbench.core.trace import kernel_base, per_frame

PREFIX = "render_accum"


def read(run):
    if run.trace is None:
        return None
    sec, n = per_frame(run.trace, lambda name: kernel_base(name).startswith(PREFIX))
    return sec * 1e3 if n else None
