"""plain_torch_device_ms: device ms a frame of what PyTorch itself runs for
the port's plain-torch stages (assemble, pack_tables, the denoiser's
prepass, decode and guide, composite, tone map) and its copies (uploads,
the readback): kernels of PyTorch's own libraries and memory copies and
sets, by torch.profiler over the traced frames."""
from rtbench.core.trace import per_frame

# names of device operations that PyTorch runs, not the port's kernels
PLAIN = ("at::", "at_cuda_detail", "cub::", "Memcpy", "Memset")


def is_plain(name: str) -> bool:
    return any(p in name for p in PLAIN)


def read(run):
    if run.trace is None:
        return None
    sec, n = per_frame(run.trace, is_plain)
    return sec * 1e3 if n else None
