"""The seam between the two packages: JAX FlatScene leaves -> port FlatScene.

The tests read a raytracevs_tpu FlatScene's leaves with ``np.asarray`` and
hand them here, so both renderers see the very same scene tables (the
"weights carried across" of this port). Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np

from .ops.bvh import FINE_FIELDS, MeshArrays
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
