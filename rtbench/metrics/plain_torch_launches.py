"""plain_torch_launches: device operations a frame that PyTorch runs for
the plain-torch stages and copies (the same operations as
plain_torch_device_ms), by torch.profiler over the traced frames."""
from rtbench.core.trace import per_frame

PLAIN = ("at::", "at_cuda_detail", "cub::", "Memcpy", "Memset")


def read(run):
    if run.trace is None:
        return None
    _, n = per_frame(run.trace, lambda name: any(p in name for p in PLAIN))
    return n or None
