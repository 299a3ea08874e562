"""The seam between the two packages: JAX FlatScene leaves -> port FlatScene.

The tests read a raytracevs_tpu FlatScene's leaves (and a PhotonMap's) with
``np.asarray`` and hand them here, so both renderers see the very same
scene tables and photons (the "weights carried across" of this port).
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.bvh import FINE_FIELDS, MeshArrays
from .ops.photon import PhotonMap
from .scene.flatten import FlatScene


def flat_from_numpy(leaves: dict) -> FlatScene:
    """Build the port's FlatScene from a dict of numpy leaves keyed by the
    JAX FlatScene field names. The "mesh" leaf is None or a dict of the JAX
    MeshArrays leaves: the fine-tree ones are taken, the fat-leaf `mk_*`
    ones (a TPU layout) are ignored."""
    missing = [f for f in FlatScene._fields if f not in leaves]
    extra = [k for k in leaves if k not in FlatScene._fields]
    if missing or extra:
        raise ValueError(f"FlatScene leaves: missing {missing}, unexpected {extra}")
    mesh = leaves["mesh"]
    if mesh is not None:
        if not isinstance(mesh, dict) or any(f not in mesh for f in FINE_FIELDS):
            raise ValueError(f"mesh leaf: expected a dict with the keys {FINE_FIELDS}")
        mesh = MeshArrays(**{f: np.asarray(mesh[f]) for f in FINE_FIELDS})
    return FlatScene(**{f: np.asarray(leaves[f]) for f in FlatScene._fields[:-1]}, mesh=mesh)


def photon_map_from_numpy(pmap) -> PhotonMap:
    """The port's PhotonMap (CPU tensors) from a raytracevs_tpu PhotonMap
    (or any object with its fields), each leaf read with ``np.asarray``, so
    both gathers can read one map."""
    def conv(name, dtype):
        return torch.from_numpy(np.array(np.asarray(getattr(pmap, name)), dtype))

    return PhotonMap(
        position=conv("position", np.float32), direction=conv("direction", np.float32),
        color=conv("color", np.float32), power=conv("power", np.float32),
        valid=conv("valid", np.bool_), cell_start=conv("cell_start", np.int32),
        cell_count=conv("cell_count", np.int32), count=conv("count", np.int32),
        radius=conv("radius", np.float32), intensity=conv("intensity", np.float32))
