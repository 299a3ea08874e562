"""Compare a rendered frame against a reference image.

`REF_SCREENSHOT` is the reference engine's own 1920x1080 DXR render of the
canonical sample_scene.rtvs (mirror sphere, red glass sphere, wine glass,
blue glass box on the checker floor); `compare_to_reference(render)` reads
it with the port's PNG reader, and `ref=` takes any other image, such as a
golden frame. A copy of raytracevs_tpu/utils/refcompare.py, which the tests
hold equal.

Geometry: the camera's vertical FOV is fixed (RayGen.hlsl:119-120:
ndc.y * tanHalfFov) and the horizontal FOV scales with W/H. The port
renders the reference's 1920x1080 directly, and then `warp_to_reference`
is the identity with every column covered. A render of another aspect at
the same camera (more rows than the reference, say) spans the same
vertical world extent and a narrower horizontal one: the warp resamples it
onto the reference pixel grid (bilinear) and reports the edge columns it
does not cover, which the comparison leaves out.
"""
from __future__ import annotations

import numpy as np

from .ssim import ssim

REF_SCREENSHOT = "/root/reference/ScreenShot.png"


def warp_to_reference(img: np.ndarray, ref_h: int = 1080, ref_w: int = 1920):
    """Bilinear-resample a [H,W,C] render onto the reference camera grid.

    Returns (warped [ref_h, ref_w, C] float32, valid-column slice): the
    vertical span matches exactly (fixed vertical FOV); horizontal NDC
    scales by aspect_ref/aspect_src, so edge columns the source frustum
    does not cover are reported via the slice.
    """
    src_h, src_w = img.shape[:2]
    img = np.asarray(img, np.float32)

    # ref pixel centers in NDC
    ry = (np.arange(ref_h) + 0.5) / ref_h * 2.0 - 1.0
    rx = (np.arange(ref_w) + 0.5) / ref_w * 2.0 - 1.0
    # same vertical NDC; horizontal NDC rescaled into the source frustum
    aspect_ratio = (ref_w / ref_h) / (src_w / src_h)  # e.g. 1088/1080
    sx_ndc = rx * aspect_ratio
    fy = (ry + 1.0) / 2.0 * src_h - 0.5
    fx = (sx_ndc + 1.0) / 2.0 * src_w - 0.5

    # half-ULP slack: at matched aspect fx[0] lands on exactly 0.0 modulo
    # float rounding; without the epsilon an identity warp drops a column
    valid = (fx >= -1e-3) & (fx <= src_w - 1.0 + 1e-3)
    first, last = int(np.argmax(valid)), int(len(valid) - np.argmax(valid[::-1]))
    col_slice = slice(first, last)

    fx = np.clip(fx, 0.0, src_w - 1.0)
    fy = np.clip(fy, 0.0, src_h - 1.0)
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    y1 = np.minimum(y0 + 1, src_h - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy, col_slice


def compare_to_reference(render: np.ndarray, ref: np.ndarray | None = None,
                         grid: int = 4) -> dict:
    """SSIM of a render (any [H,W,3/4] at the same camera) vs the DXR
    screenshot: global over the covered region, plus a grid x grid map of
    regional SSIMs for the discrepancy analysis. All values on RGB8."""
    if ref is None:
        from ..io.png import read_png

        ref = read_png(REF_SCREENSHOT)
    ref = np.asarray(ref)[..., :3].astype(np.float32)
    warped, cols = warp_to_reference(np.asarray(render)[..., :3],
                                     ref_h=ref.shape[0], ref_w=ref.shape[1])
    ref_c = ref[:, cols]
    wrp_c = warped[:, cols]
    out = {"ssim": round(ssim(wrp_c, ref_c), 4)}
    h, w = ref_c.shape[:2]
    cells = {}
    for i in range(grid):
        for j in range(grid):
            rs = slice(i * h // grid, (i + 1) * h // grid)
            cs = slice(j * w // grid, (j + 1) * w // grid)
            cells[f"r{i}c{j}"] = round(ssim(wrp_c[rs, cs], ref_c[rs, cs]), 4)
    out["regions"] = cells
    out["mean_abs_err"] = round(float(np.abs(wrp_c - ref_c).mean()), 2)
    return out
