"""denoise_roofline: the denoiser kernels' share of their bound, %: the sum
over K2, K3 and K4's launches of the least time their bytes take at the
card's published memory rate, over the same launches' device time by
torch.profiler. The kernels are bound by bytes: each input plane read once,
each output plane written once, float32 (int32 ids), at the frame's size.
"""
from rtbench.core.trace import kernel_base

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at its 700 W limit
# planes a launch moves, by kernel: K2 reads the 16-plane history, the 8
# current planes (diffuse and specular with hit distance), motion (2), view
# z, roughness and specular motion (2), and writes a 16-plane history; K3
# reads the 6 colour planes, view z, the normal (3) and the guide (2) and
# writes 6; K4 reads the shadow pair, the object id, view z and the normal
# and writes 2
PLANES = {"reproject_kernel": 16 + 8 + 2 + 1 + 1 + 2 + 16,
          "atrous_kernel": 6 + 1 + 3 + 2 + 6,
          "shadow_kernel": 2 + 1 + 1 + 3 + 2}


def kernel_bytes(kernel: str, width: int, height: int) -> int:
    return PLANES[kernel] * 4 * width * height


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    lo, hi = t.start_us, t.start_us + t.window_us
    bound_s = device_s = 0.0
    for name, s, e in t.device_ops:
        k = kernel_base(name)
        if k in PLANES:
            bound_s += kernel_bytes(k, run.width, run.height) / HBM_BYTES_PER_S
            device_s += (min(e, hi) - max(s, lo)) * 1e-6
    return 100.0 * bound_s / device_s if device_s > 0 else None
