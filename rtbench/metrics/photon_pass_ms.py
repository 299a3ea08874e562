"""photon_pass_ms: device ms a frame of the photon pass, by torch.profiler
over the traced frames: from the start of the photon emission and trace
(K5, photon_trace_kernel) to the end of the next photon gather (K6,
photon_gather_kernel). The stretch holds K5, the hash build's device
operations, K6, and the device's idle time while the host issues the hash
build; its mean over the passes the traced frames hold. None where no K5
runs."""
from rtbench.core.trace import kernel_base

EMIT, GATHER = "photon_trace_kernel", "photon_gather_kernel"


def passes(trace):
    """[(start_us, end_us)] of each photon pass in the traced frames: a K5's
    start to the end of the first K6 that starts after it."""
    lo, hi = trace.start_us, trace.start_us + trace.window_us
    ops = sorted((s, e, kernel_base(name)) for name, s, e in trace.device_ops
                 if lo <= s < hi and kernel_base(name) in (EMIT, GATHER))
    out, start = [], None
    for s, e, k in ops:
        if k == EMIT:
            start = s if start is None else start
        elif start is not None:
            out.append((start, e))
            start = None
    return out


def read(run):
    if run.trace is None:
        return None
    p = passes(run.trace)
    if not p:
        return None
    return sum(e - s for s, e in p) * 1e-3 / len(p)
