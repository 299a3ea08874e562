"""device_idle_share: %, one minus the union of the device's busy intervals
over the wall time of the traced frames, by torch.profiler."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
