"""The scene checksum that keys temporal-history resets.

Numpy restatement of raytracevs_tpu/utils/checksum.py::scene_content_checksum;
the tests hold both to the same values. The reference FNV-1a-hashes the
scene geometry each frame and resets the denoiser history when it changes
(DXRPipeline.cpp:2795-2880).
"""
from __future__ import annotations

import numpy as np

from ..scene.data import BoxData, MeshObjectData, PlaneData, SphereData


def scene_content_checksum(scene) -> int:
    """FNV-1a over object geometry — the reference's exact history-reset key.

    Mirrors DXRPipeline.cpp:2795-2860 field-for-field: sphere center+radius,
    plane position, box center, and mesh-instance transform position. The
    camera, lights, materials and render settings are deliberately NOT
    hashed — camera motion must carry denoiser history across frames via
    motion-vector reprojection, not reset it.
    """
    checksum = 0x811C9DC5
    prime = 0x01000193
    mask = (1 << 64) - 1

    def mix(c, values):
        for w in np.asarray(values, np.float32).ravel().view(np.uint32):
            c = ((c ^ int(w)) * prime) & mask
        return c

    for obj in scene.objects:
        if isinstance(obj, SphereData):
            checksum = mix(checksum, obj.position[:3])
            checksum = mix(checksum, [obj.radius])
        elif isinstance(obj, PlaneData):
            checksum = mix(checksum, obj.position[:3])
        elif isinstance(obj, BoxData):
            checksum = mix(checksum, obj.center[:3])
    for obj in scene.objects:
        if isinstance(obj, MeshObjectData):
            checksum = mix(checksum, obj.transform.position[:3])
    return checksum
