"""Photon-mapped caustics: emit, trace, sorted spatial hash, gather.

Restates raytracevs_tpu/ops/photon.py (the reference's PhotonEmit.hlsl,
PhotonTrace.hlsl, BuildPhotonHash.hlsl, DXRPipeline.cpp:3511-3676).
Photons are a flat batch: emission and the 4-bounce trace are vectorized,
keyed on each photon's global index. Storage sorts the photons by their
spatial-hash cell and addresses each cell's contiguous range by
searchsorted. Photons see the analytic primitives only (the reference's
photon pipeline has no triangle hit group). The gather runs at the
primary hits of diffuse surfaces, with corner-cell culling, a 64-photon
scan per cell, a 32-photon early-out and a Gaussian kernel
(Common.hlsli:887-967).

`_emit_photons` followed by `_trace_photons`, and `add_caustics`, are
the plain versions of kernels K5 and K6 (csrc/photon.cu, wrapped by
ops/cuda/photon_kernels.py), which follow them operation for operation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..runtime.profiler import annotate
from . import intersect, render, sampling, vec

F32 = torch.float32
I32 = torch.int32
_M32 = 0xFFFFFFFF
_TWO_PI = 6.28318530718
PHOTON_RADIUS = 0.5  # DXRPipeline.h:484
CAUSTIC_INTENSITY = 3.0  # DXRPipeline.h:485
# gather neighbourhood: the 27 cells around the receiver's cell in z, y, x
# order, corners (cellDistSq > 2) culled -> 19 cells (Common.hlsli:902-917)
CELL_OFFSETS = tuple((x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)
                     if x * x + y * y + z * z <= 2)
_GATHER_COMPACT_EVERY = 8  # plain gather: drop finished lanes every this many steps


class PhotonMap(NamedTuple):
    """Sorted photon storage and the spatial hash's ranges."""

    position: torch.Tensor  # [P,3]
    direction: torch.Tensor  # [P,3] incoming direction
    color: torch.Tensor  # [P,3]
    power: torch.Tensor  # [P]
    valid: torch.Tensor  # [P] bool
    cell_start: torch.Tensor  # [PHOTON_HASH_TABLE_SIZE] int32, first sorted index of a cell
    cell_count: torch.Tensor  # [PHOTON_HASH_TABLE_SIZE] int32
    count: torch.Tensor  # 0-d int32, stored photons
    radius: torch.Tensor  # 0-d float32, gather radius
    intensity: torch.Tensor  # 0-d float32, caustic intensity


def _random_float(seed):
    """RandomFloat (Common.hlsli:833-837): (new u32 state, float in [0,1))."""
    return sampling.random_float(seed)


def hash_cell(cell_x, cell_y, cell_z):
    """HashPhotonCell (Common.hlsli:877-883) of integer cells -> int32 slot."""
    h = (((cell_x.to(torch.int64) & _M32) * 73856093)
         ^ ((cell_y.to(torch.int64) & _M32) * 19349663)
         ^ ((cell_z.to(torch.int64) & _M32) * 83492791)) & _M32
    return (h % C.PHOTON_HASH_TABLE_SIZE).to(I32)


def photon_budget(scene_data) -> int:
    """Photon count with the reference's TDR caps (DXRPipeline.cpp:3596-3633)."""
    from ..scene.data import LightType

    lights = scene_data.lights
    non_ambient = sum(1 for l in lights if l.type != LightType.AMBIENT)
    point = sum(1 for l in lights if l.type == LightType.POINT)
    objects = len(scene_data.objects)
    has_specular = any(
        getattr(o, "material", None) is not None
        and (o.material.transmission > 0.01 or o.material.metallic > 0.5)
        for o in scene_data.objects
    )
    if not has_specular or non_ambient == 0:
        return 0
    total = 32768 * non_ambient
    total = min(total, C.MAX_PHOTONS)
    if point > 0:
        total = min(total, 8192 * max(1, non_ambient))
    safe_cap = 131072
    if point > 0 and objects > 1:
        safe_cap = min(safe_cap, 65536)
    return min(total, safe_cap)


def emit_and_trace(scene, total_photons: int, tables=None) -> PhotonMap:
    """Emit photons from the lights, trace them up to MAX_PHOTON_BOUNCES
    (kernel K5 on a CUDA scene, on `tables`, the frame's pack_tables, when
    given; its plain version on a CPU one) and build the hash. scene: a
    FlatScene of tensors (its meshes are not traced). Spans
    (runtime/profiler.py::annotate): rtvs.render.caustics.emit_trace and
    .hash, the frame's photon pass."""
    with annotate("rtvs.render.caustics.emit_trace"):
        stores = trace_photon_slice(scene, total_photons, 0, total_photons, tables)
    with annotate("rtvs.render.caustics.hash"):
        return build_photon_hash(*stores)


def trace_photon_slice(scene, total_photons: int, offset: int, count: int, tables=None):
    """Emit and trace photons [offset, offset+count) of a total_photons
    batch (kernel K5, or its plain version on a CPU scene): every photon's
    emission and Russian-roulette chain is keyed on its global index
    (PhotonEmit.hlsl:44-48), so a slice equals the same rows of the whole
    batch. Returns (store_pos [count,3], store_dir, store_color,
    store_power [count], store_mask [count] bool)."""
    from .cuda import photon_kernels

    return photon_kernels.emit_and_trace(scene, total_photons, offset, count, tables)


def sharded_photon_map(scenes, total_photons: int, tables=None):
    """The photon map of a row-sharded frame (JAX parallel/tiles.py::
    _sharded_photon_map): slab i's scene (scenes[i], on its device) emits
    and traces photons [i*per, (i+1)*per) of the batch, per =
    total_photons / len(scenes), on its tables (tables[i], or None); the
    stores are concatenated in index order onto every distinct device, and
    each builds the hash. Every photon is keyed on its global index, so
    each map equals the single-device one. Returns a map per slab (slabs
    on one device share it), or None when caustics are off or the count
    does not divide evenly (the caller then builds the map itself)."""
    n = len(scenes)
    if total_photons <= 0 or total_photons % n:
        return None
    per = total_photons // n
    stores = [trace_photon_slice(sc, total_photons, i * per, per,
                                 None if tables is None else tables[i])
              for i, sc in enumerate(scenes)]
    maps = {}
    for sc in scenes:
        dev = sc.cam_pos.device
        if dev not in maps:
            maps[dev] = build_photon_hash(*(torch.cat([s[k].to(dev) for s in stores])
                                            for k in range(len(stores[0]))))
    return [maps[sc.cam_pos.device] for sc in scenes]


def _emit_photons(scene, total_photons: int, offset: int = 0, count: int = None):
    """Photon emission (PhotonEmit.hlsl:44-117): light selection and the
    first rays. Returns (origin, direction, color [P,3], power, alive [P]).

    Photons split evenly over the non-ambient lights in light order; the
    seeds and the light ordinal are functions of the global index, and the
    split always uses total_photons. Part of the plain version of K5, which
    emits in its kernel: ``_emit_photons.launches`` counts the calls, so a
    caller can tell that a path on the card ran none."""
    _emit_photons.launches += 1
    n = count if count is not None else total_photons
    dev = scene.lt_type.device
    l_cap = scene.lt_type.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev) + offset
    seed = sampling.wang_hash((idx * 1973 + 9277) & _M32)

    slots = torch.arange(l_cap, device=dev)
    lv = (slots < scene.num_lights) & scene.lt_valid
    na = lv & (scene.lt_type != C.LIGHT_TYPE_AMBIENT)  # [L]
    non_ambient = na.to(I32).sum()
    photons_per_light = torch.clamp(total_photons // torch.clamp(non_ambient, min=1), min=1)
    ordinal = torch.minimum(idx // photons_per_light, torch.clamp(non_ambient - 1, min=0))

    # the ordinal-th non-ambient light's parameters
    lt_type = torch.zeros((n,), dtype=scene.lt_type.dtype, device=dev)
    lt_pos = torch.zeros((n, 3), dtype=F32, device=dev)
    lt_color = torch.ones((n, 3), dtype=F32, device=dev)
    lt_intensity = torch.ones((n,), dtype=F32, device=dev)
    running = torch.zeros((), dtype=torch.int64, device=dev)
    for li in range(l_cap):
        sel = na[li] & (ordinal == running)
        lt_type = torch.where(sel, scene.lt_type[li], lt_type)
        lt_pos = vec.where3(sel, scene.lt_position[li][None, :], lt_pos)
        lt_color = vec.where3(sel, scene.lt_color[li][None, :3], lt_color)
        lt_intensity = torch.where(sel, scene.lt_intensity[li], lt_intensity)
        running = running + na[li].to(torch.int64)

    color = lt_color * lt_intensity[:, None]
    power = lt_intensity / photons_per_light.to(F32)

    # point: from the position over the sphere, power *= 4 pi (PhotonEmit.hlsl:90-98)
    seed, z0 = _random_float(seed)
    seed, p0 = _random_float(seed)
    z = z0 * 2.0 - 1.0
    phi = p0 * _TWO_PI
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    sphere_dir = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    is_point = lt_type == C.LIGHT_TYPE_POINT
    is_dir = lt_type == C.LIGHT_TYPE_DIRECTIONAL
    power = torch.where(is_point, power * (4.0 * 3.14159265), power)

    # directional: a virtual emitter plane 20 units wide, 50 back
    # (PhotonEmit.hlsl:99-117), from the same two randoms
    ldir = vec.normalize(-lt_pos)
    up = torch.where((torch.abs(ldir[:, 1]) < 0.999)[:, None],
                     vec.const3(0.0, 1.0, 0.0, like=ldir), vec.const3(1.0, 0.0, 0.0, like=ldir))
    right = vec.normalize(vec.cross(up, ldir))
    real_up = vec.cross(ldir, right)
    off_x = (z0 * 2.0 - 1.0) * 20.0
    off_y = (p0 * 2.0 - 1.0) * 20.0
    plane_origin = right * off_x[:, None] + real_up * off_y[:, None] - ldir * 50.0

    origin = vec.where3(is_point, lt_pos, plane_origin)
    direction = vec.where3(is_point, sphere_dir, ldir)
    return origin, direction, color, power, is_point | is_dir


class _PhotonState(NamedTuple):
    """Per-photon state of the bounce loop."""

    origin: torch.Tensor
    direction: torch.Tensor
    color: torch.Tensor
    power: torch.Tensor
    alive: torch.Tensor
    is_caustic: torch.Tensor
    store_pos: torch.Tensor
    store_dir: torch.Tensor
    store_color: torch.Tensor
    store_power: torch.Tensor
    store_mask: torch.Tensor


def _initial_state(origin, direction, color, power, alive) -> _PhotonState:
    zero3 = torch.zeros_like(origin)
    return _PhotonState(origin, direction, color, power, alive,
                        torch.zeros_like(alive), zero3, zero3, zero3,
                        torch.zeros_like(power), torch.zeros_like(alive))


def _bounce(pscene, s: _PhotonState, idx, depth: int) -> _PhotonState:
    """One bounce of every photon (PhotonTrace.hlsl:97-223)."""
    n = s.origin.shape[0]
    dev = s.origin.device
    direction = s.direction
    hit = intersect.trace_closest(pscene, s.origin, direction,
                                  torch.full((n,), C.RAY_TMIN, dtype=F32, device=dev),
                                  torch.full((n,), C.RAY_TMAX, dtype=F32, device=dev))
    live_hit = s.alive & hit.hit
    pos, n_faced, front = intersect.surface_normal(pscene, hit, s.origin, direction)
    # the outward geometric normal; boxes report the face normal, and every
    # use below is sign-invariant
    normal = vec.where3(front, n_faced, -n_faced)

    slot = hit.mat_slot
    mat_rgb = pscene.mat_color[slot][:, :3]
    metallic = pscene.mat_metallic[slot]
    transmission = pscene.mat_transmission[slot]
    roughness = pscene.mat_roughness[slot]
    ior = pscene.mat_ior[slot]

    # Russian roulette seeded per (photon, depth): the reference hashes the
    # hit position's bits as an entropy source; the photon index is
    # statistically the same and invariant to ulp-level hit differences
    rr_seed = sampling.wang_hash(((idx.to(torch.int64) * 9781) & _M32)
                                 ^ ((depth * 0x9E3779B9) & _M32))
    rr_seed, rr = _random_float(rr_seed)
    survival = torch.clamp(torch.amax(mat_rgb, dim=-1), 0.1, 0.95)
    survive = rr <= survival
    power = torch.where(live_hit, s.power / survival, s.power)
    color = vec.where3(live_hit, s.color * mat_rgb, s.color)
    alive = s.alive & hit.hit & survive

    is_glass = transmission > 0.5
    is_metal = ~is_glass & (metallic > 0.5)
    is_diffuse = ~is_glass & ~is_metal

    # diffuse: store if caustic, terminate (PhotonTrace.hlsl:117-128)
    store_now = alive & is_diffuse & s.is_caustic & ~s.store_mask
    store_mask = s.store_mask | store_now
    store_pos = vec.where3(store_now, pos, s.store_pos)
    store_dir = vec.where3(store_now, direction, s.store_dir)
    store_color = vec.where3(store_now, color, s.store_color)
    store_power = torch.where(store_now, power, s.store_power)
    alive = alive & ~is_diffuse

    # glass: probabilistic Fresnel reflect/refract (PhotonTrace.hlsl:129-190)
    view = -direction
    front2 = vec.dot(view, normal) > 0.0
    outward = vec.where3(front2, normal, -normal)
    cos_theta = torch.abs(vec.dot(view, outward))
    f0 = torch.square((1.0 - ior) / (1.0 + ior))
    om = 1.0 - cos_theta
    om2 = om * om
    fresnel = f0 + (1.0 - f0) * (om2 * om2 * om)
    rr_seed, choice = _random_float(rr_seed)
    refracting = choice > fresnel
    eta = torch.where(front2, 1.0 / ior, ior)
    cosi = -vec.dot(direction, outward)
    sin2t = eta * eta * (1.0 - cosi * cosi)
    tir = sin2t > 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
    refr = eta[:, None] * direction + (eta * cosi - cost)[:, None] * outward
    refl = direction - (2.0 * vec.dot(direction, outward))[:, None] * outward
    thru = refracting & ~tir
    glass_dir = vec.where3(thru, vec.normalize(refr), refl)
    glass_origin = vec.where3(thru, pos - outward * 0.01, pos + outward * 0.01)

    # metal: roughness-lerped reflection (PhotonTrace.hlsl:191-223)
    refl_m = direction - (2.0 * vec.dot(direction, normal))[:, None] * normal
    rr_seed, hz = _random_float(rr_seed)
    rr_seed, hphi = _random_float(rr_seed)
    hz2 = hz * 2.0 - 1.0
    hr = torch.sqrt(torch.clamp(1.0 - hz2 * hz2, min=0.0))
    ang = hphi * _TWO_PI
    hemi = torch.stack([hr * torch.cos(ang), hr * torch.sin(ang), hz2], dim=-1)
    hemi = vec.where3(vec.dot(hemi, normal) > 0.0, hemi, -hemi)
    rough2 = (roughness * roughness)[:, None]
    metal_dir = refl_m + (hemi - refl_m) * rough2
    metal_dir = vec.where3(roughness > 0.01, vec.normalize(metal_dir), refl_m)

    is_caustic = s.is_caustic | (alive & (is_glass | is_metal))
    origin = vec.where3(is_glass, glass_origin, pos + normal * 0.01)
    direction = vec.where3(is_glass, glass_dir, metal_dir)
    return _PhotonState(origin, direction, color, power, alive, is_caustic, store_pos,
                        store_dir, store_color, store_power, store_mask)


def _trace_photons(scene, origin, direction, color, power, alive, idx):
    """The photon bounce loop (PhotonTrace.hlsl:97-223), plain version of
    K5: raytracevs_tpu/ops/photon.py::_trace_photons_jnp op for op. `idx`
    [P] is each photon's global batch index (the Russian-roulette key).
    Meshes are ignored. Returns (store_pos, store_dir, store_color [P,3],
    store_power [P], store_mask [P] bool)."""
    pscene = scene._replace(mesh=None)
    s = _initial_state(origin, direction, color, power, alive)
    for depth in range(C.MAX_PHOTON_BOUNCES):
        s = _bounce(pscene, s, idx, depth)
    return s.store_pos, s.store_dir, s.store_color, s.store_power, s.store_mask


def build_photon_hash(store_pos, store_dir, store_color, store_power, store_mask) -> PhotonMap:
    """Sort-based spatial hash (BuildPhotonHash.hlsl:59-105): photons sorted
    by cell slot (stable, so within a cell they keep their index order,
    which decides what the gather's caps keep; unstored photons last), each
    slot's range found by searchsorted. cellSize = 2 * photonRadius
    (DXRPipeline.cpp:3392-3435). `.launches` counts its calls."""
    build_photon_hash.launches += 1
    dev = store_pos.device
    cell_size = max(PHOTON_RADIUS * 2.0, 1e-4)
    cell = torch.floor(vec.div_const(store_pos, cell_size)).to(I32)
    h = hash_cell(cell[:, 0], cell[:, 1], cell[:, 2])
    h = torch.where(store_mask, h, C.PHOTON_HASH_TABLE_SIZE)
    order = torch.argsort(h, stable=True)
    h_sorted = h[order].contiguous()
    cells = torch.arange(C.PHOTON_HASH_TABLE_SIZE, dtype=I32, device=dev)
    cell_start = torch.searchsorted(h_sorted, cells).to(I32)
    cell_end = torch.searchsorted(h_sorted, cells + 1).to(I32)
    return PhotonMap(
        position=store_pos[order], direction=store_dir[order], color=store_color[order],
        power=store_power[order], valid=store_mask[order], cell_start=cell_start,
        cell_count=cell_end - cell_start, count=store_mask.to(I32).sum().to(I32),
        radius=torch.tensor(PHOTON_RADIUS, dtype=F32, device=dev),
        intensity=torch.tensor(CAUSTIC_INTENSITY, dtype=F32, device=dev))


def _gather_step(pmap, s: dict, radius_sq) -> dict:
    """One step of the gather's walk for every lane in `s`: the current
    photon of the current cell is tested, then the walk moves to the next
    photon, or to the next cell after the cell's last one (or its 64th), or
    ends after the 32nd accepted photon."""
    n_cells = len(CELL_OFFSETS)
    cell_i, off = s["cell"], s["off"]
    in_range = cell_i < n_cells
    ci = torch.clamp(cell_i, 0, n_cells - 1).to(torch.int64)[:, None]
    cnt = torch.clamp(torch.gather(s["counts"], 1, ci)[:, 0], max=C.MAX_PHOTONS_PER_CELL)
    st = torch.gather(s["starts"], 1, ci)[:, 0]
    have = in_range & (off < cnt)
    pi = torch.clamp(st + off, 0, pmap.position.shape[0] - 1).to(torch.int64)
    pval = pmap.valid[pi] & (pi < pmap.count)
    diff = s["pos"] - pmap.position[pi]
    dist_sq = vec.dot(diff, diff)
    dot_n = vec.dot(-pmap.direction[pi], s["nrm"])
    accept = have & pval & (dist_sq < radius_sq) & (dot_n > 0.0)
    w = torch.exp(-dist_sq / (2.0 * radius_sq * 0.5)) * dot_n
    caustic = s["caustic"] + torch.where(
        accept[:, None], pmap.color[pi] * (pmap.power[pi] * w)[:, None], 0.0)
    weight = s["weight"] + torch.where(accept, w, 0.0)
    gathered = s["gathered"] + accept.to(I32)
    next_off = off + 1
    move_cell = in_range & (next_off >= cnt)
    cell_i = torch.where(gathered >= C.MAX_GATHER_PHOTONS_THRESHOLD, n_cells,
                         cell_i + move_cell.to(I32))
    return dict(s, cell=cell_i, off=torch.where(move_cell, 0, next_off), gathered=gathered,
                caustic=caustic, weight=weight)


def gather(pmap: PhotonMap, position, normal):
    """GatherPhotons (Common.hlsli:887-967): the 19-cell walk with the
    Gaussian kernel, raytracevs_tpu/ops/photon.py::gather lane by lane
    (the same step bound, cell order, caps and early-out; a photon whose
    cell shares a hash slot with a neighbour's is counted once per slot
    visit, as there). position/normal [N,3]; returns the caustic [N,3]."""
    return _gather_weighted(pmap, position, normal)[0]


def _gather_weighted(pmap: PhotonMap, position, normal):
    """gather's (caustic [N,3], summed kernel weight [N]); the caustic is
    zero where the weight is not positive. Finished lanes leave the
    working set every few steps."""
    n = position.shape[0]
    dev = position.device
    n_cells = len(CELL_OFFSETS)
    radius_sq = pmap.radius * pmap.radius
    cell_size = torch.clamp(pmap.radius * 2.0, min=1e-4)
    base = torch.floor(position / cell_size).to(I32)
    starts, counts = [], []
    for x, y, z in CELL_OFFSETS:
        ch = hash_cell(base[:, 0] + x, base[:, 1] + y, base[:, 2] + z).to(torch.int64)
        starts.append(pmap.cell_start[ch])
        counts.append(pmap.cell_count[ch])
    zi = torch.zeros((n,), dtype=I32, device=dev)
    cur = dict(cell=zi, off=zi, gathered=zi, caustic=torch.zeros((n, 3), dtype=F32, device=dev),
               weight=torch.zeros((n,), dtype=F32, device=dev), pos=position, nrm=normal,
               starts=torch.stack(starts, dim=1), counts=torch.stack(counts, dim=1))
    caustic, weight = cur["caustic"], cur["weight"]
    idx = torch.arange(n, device=dev)
    max_steps = n_cells * C.MAX_PHOTONS_PER_CELL + n_cells
    steps = 0
    while idx.numel() > 0 and steps < max_steps:
        for _ in range(min(_GATHER_COMPACT_EVERY, max_steps - steps)):
            cur = _gather_step(pmap, cur, radius_sq)
            steps += 1
        live = cur["cell"] < n_cells
        if steps < max_steps and bool(live.all()):
            continue
        caustic = caustic.index_copy(0, idx, cur["caustic"])
        weight = weight.index_copy(0, idx, cur["weight"])
        idx = idx[live]
        cur = {k: v[live] for k, v in cur.items()}
    area = 3.14159265 * radius_sq
    caustic = torch.where((weight > 0.0)[:, None], caustic / area, 0.0)
    return caustic * pmap.intensity, weight


def add_caustics(pmap: PhotonMap, acc, spp: int, replace: bool = False, scale: float = 1.0):
    """Plain version of K6: adds the caustic, times spp, into the colour
    and diffuse planes of the accumulator acc [NUM_CH,H,W] (contiguous) in
    place at its lit pixels; returns acc. A pixel is gathered where it is
    eligible, a primary hit on a diffuse surface (metallic < 0.5,
    transmission <= 0.01; RayGen.hlsl:505-533), at its first-hit record,
    and lit where the gather finds weight; no other pixel or plane is
    written. raytracevs_tpu/ops/render.py::caustics_delta's delta added to
    the colour, as the JAX frame adds it (which adds +0.0 elsewhere).

    With replace (a nonzero photon debug mode), every eligible pixel, lit
    or not, takes the JAX package's replacement fold-in
    (raytracevs_tpu/ops/render_cf.py::_apply_caustics_cf): with d the
    caustic times spp times scale, colour = colour - primary + d, primary
    = diffuse = d, specular 0, and the SIGMA record visibility 1, penumbra
    0, distance NRD_FP16_MAX."""
    _, h, w = acc.shape
    eligible = ((acc[render.CH_PRIM_HIT] > 0.5) & (acc[render.CH_METALLIC] < 0.5)
                & (acc[render.CH_TRANSMISSION] <= 0.01)).reshape(-1)
    flat = acc.view(acc.shape[0], h * w)
    pos = flat[render.CH_POS:render.CH_POS + 3].T
    nrm = flat[render.CH_NORMAL:render.CH_NORMAL + 3].T
    lanes = torch.nonzero(eligible).squeeze(1)
    caustic, weight = _gather_weighted(pmap, pos[lanes], nrm[lanes])
    if replace:
        d = ((caustic * float(spp)) * float(scale)).T
        cc, cp = render.CH_COLOR, render.CH_PRIMARY
        flat[cc:cc + 3, lanes] = flat[cc:cc + 3, lanes] - flat[cp:cp + 3, lanes] + d
        for ch in (render.CH_PRIMARY, render.CH_DIFFUSE):
            flat[ch:ch + 3, lanes] = d
        flat[render.CH_SPECULAR:render.CH_SPECULAR + 3, lanes] = 0.0
        for ch, v in ((render.CH_SHADOW_VIS, 1.0), (render.CH_SHADOW_PEN, 0.0),
                      (render.CH_SHADOW_DIST, C.NRD_FP16_MAX)):
            flat[ch, lanes] = v
        return acc
    lit = weight > 0.0
    lanes, delta = lanes[lit], (caustic[lit] * float(spp)).T
    for ch in (render.CH_COLOR, render.CH_DIFFUSE):
        flat[ch:ch + 3, lanes] = flat[ch:ch + 3, lanes] + delta
    return acc


_emit_photons.launches = 0
build_photon_hash.launches = 0
