"""The seam between the two packages: JAX FlatScene leaves -> port FlatScene.

The tests read a raytracevs_tpu FlatScene's leaves with ``np.asarray`` and
hand them here, so both renderers see the very same scene tables (the
"weights carried across" of this port). Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np

from .scene.flatten import FlatScene


def flat_from_numpy(leaves: dict) -> FlatScene:
    """Build the port's FlatScene from a dict of numpy leaves keyed by the
    JAX FlatScene field names. A mesh leaf (anything but None under
    "mesh") raises: triangle meshes are not part of this port yet."""
    if leaves.get("mesh") is not None:
        raise NotImplementedError("mesh: not ported yet")
    missing = [f for f in FlatScene._fields if f not in leaves]
    extra = [k for k in leaves if k not in FlatScene._fields and k != "mesh"]
    if missing or extra:
        raise ValueError(f"FlatScene leaves: missing {missing}, unexpected {extra}")
    return FlatScene(**{f: np.asarray(leaves[f]) for f in FlatScene._fields})
