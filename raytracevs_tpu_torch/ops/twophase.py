"""The two-phase renderer: phase A (kernel K7), the coherence sort, phase B
(kernel K8).

Restates raytracevs_tpu/ops/pallas/megakernel.py::render_accum_pallas_twophase
(and its ``_coherence_key``), the renderer the JAX package runs for
``backend="pallas2"`` or ``RTVS_TWOPHASE=1``. spp 1 only. Phase A runs one
DFS iteration per pixel: the primary ray with its full shading and depth-0
records, and the continuation it spawned. The continuations are sorted by
direction octant, then by the Morton code of their origin, so that rays
that will walk the same BVH nodes sit side by side. Phase B resumes each
sorted continuation in its own thread: it re-derives the pixel's
iteration-0 state without lighting from the closest hit phase A traced
(phase A's hit planes) and runs the DFS from iteration 1, then
adds the subtree's colour and rays into the pixel's planes and takes the
maximum of its bounce count.

Per-pixel state is lane-local, so the sort changes no pixel's ray tree:
ray counts and every record plane equal K1's bit for bit, and the colour
differs from K1's only by the order of its sum (phase A's term plus phase
B's sum, against K1's running sum).

The JAX package restores pixel order with a second sort, because a TPU
kernel cannot scatter; K8 writes to its own pixel (pixel ids are unique,
so no atomics), and there is no second sort. The sort itself is one
``torch.sort``, outside the kernels, as the JAX package's is ``lax.sort``.
"""
from __future__ import annotations

import torch

from . import render as R

KEY_INVALID = 0x7FFFFFFF  # the key of a pixel without a continuation: the sort's tail
MAX_APERTURE = 1e-3


def coherence_key(valid, o, d):
    """int32 sort key of each continuation (megakernel.py::_coherence_key,
    its default "oct_pos" order): the direction octant in bits 21-23 above
    a 21-bit Morton code of the origin, quantised to 7 bits an axis over
    the bounding box of the valid origins. valid [N] bool, o and d [3,N]
    (one row an axis); pixels without a continuation get KEY_INVALID."""
    i32 = torch.int32
    octant = ((d[0] < 0).to(i32) | ((d[1] < 0).to(i32) << 1) | ((d[2] < 0).to(i32) << 2))
    morton = torch.zeros_like(octant)
    for a in range(3):
        lo = torch.amin(torch.where(valid, o[a], 3.0e38))
        hi = torch.amax(torch.where(valid, o[a], -3.0e38))
        extent = torch.clamp(hi - lo, min=1e-4)
        # a division by the 0-d tensor, so it rounds alike on every device
        q = torch.clamp((o[a] - lo) / extent * 127.0, 0.0, 127.0).to(i32)
        for b in range(7):
            morton = morton | (((q >> b) & 1) << (3 * b + a))
    return torch.where(valid, (octant << 21) | morton, KEY_INVALID)


def coherence_order(planes):
    """The pixels of phase A's planes [NUM_CH_A, H, W] sorted by
    coherence_key, those with a continuation first. Returns (order [H*W]
    int32 pixel ids, count [1] int32 of pixels with a continuation), both
    on the planes' device (no host sync)."""
    n = planes.shape[1] * planes.shape[2]
    valid = planes[R.CH_SPAWN_VALID].reshape(n) > 0.5
    o = planes[R.CH_SPAWN_O:R.CH_SPAWN_O + 3].reshape(3, n)
    d = planes[R.CH_SPAWN_D:R.CH_SPAWN_D + 3].reshape(3, n)
    key = coherence_key(valid, o, d)
    _, order = torch.sort(key, stable=True)
    count = valid.sum(dtype=torch.int32).reshape(1)
    return order.to(torch.int32), count


def check_two_phase(cfg, aperture_size) -> None:
    """Raise ValueError unless the two-phase renderer can render this
    configuration: spp 1 (phase A runs one iteration of one sample) and a
    pinhole camera, aperture_size <= 1e-3 (phase B re-derives the primary
    ray without the thin-lens jitter). `aperture_size` is the host's
    number (the numpy FlatScene's), so the check needs no device read."""
    if cfg.samples_per_pixel != 1:
        raise ValueError("the two-phase renderer needs samples_per_pixel == 1, got "
                         f"{cfg.samples_per_pixel}")
    if aperture_size is None or not float(aperture_size) <= MAX_APERTURE:
        raise ValueError(f"the two-phase renderer needs aperture_size <= {MAX_APERTURE} (phase B "
                         f"re-derives primary rays without depth of field), got {aperture_size}")


def render_accum_two_phase(scene, cfg, aperture_size, tables=None, limit=None, row_start=0,
                           num_rows=None) -> torch.Tensor:
    """The [NUM_CH, H, W] accumulator planes of the frame through the two
    phases: K7, the coherence sort, K8 on CUDA tensors (one packing of the
    scene tables for both: `tables`, pack_tables(scene), when the caller
    packed them already); their plain versions on CPU tensors. Given
    `num_rows`, the [NUM_CH, num_rows, W] planes of the row slab from
    `row_start` alone, its continuations sorted on their own.
    `aperture_size`: the host FlatScene's, for check_two_phase. On the
    card a slab whose K7 planes pass `limit` floats (the kernels' 32-bit
    plane index by default) runs the three steps per row band
    (megakernel.row_bands); a pixel's result does not depend on the sort
    order, so the frame is the same."""
    from .cuda import megakernel as MK

    check_two_phase(cfg, aperture_size)
    row_start, rows = R.row_slab(cfg, row_start, num_rows)

    def band_planes(band):
        planes = MK.render_phase_a(scene, cfg, tables, band=band)
        order, count = coherence_order(planes)
        return MK.render_phase_b(scene, cfg, order, count, planes[:R.NUM_CH], planes[R.CH_HIT:],
                                 tables, band=band)

    if scene.cam_pos.device.type != "cuda":
        return band_planes((row_start, rows))
    tables = MK.pack_tables(scene) if tables is None else tables
    bands = MK.row_bands(cfg.width, rows, R.NUM_CH_A, MK.PLANE_LIMIT if limit is None else limit)
    if len(bands) == 1:
        return band_planes((row_start, rows))
    out = torch.empty((R.NUM_CH, rows, cfg.width), dtype=torch.float32,
                      device=scene.cam_pos.device)
    for row0, n in bands:
        out[:, row0:row0 + n].copy_(band_planes((row_start + row0, n)))
    return out
