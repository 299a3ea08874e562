"""Transform: position / rotation (quaternion) / scale.

Numerically compatible with the reference editor's transform math
(src/RayTraceVS.WPF/Models/Transform.cs:10-137), which follows the
System.Numerics conventions: euler angles are degrees in
(pitch=X, yaw=Y, roll=Z) order combined as CreateFromYawPitchRoll, and
matrices use the row-vector convention. Box OBB axes are extracted from the
*columns* of the System.Numerics rotation matrix (BoxNode.cs Evaluate),
which this module reproduces exactly so .rtvs scenes render identically.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def quat_from_yaw_pitch_roll(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """System.Numerics Quaternion.CreateFromYawPitchRoll (radians) -> [x,y,z,w]."""
    sr, cr = math.sin(roll * 0.5), math.cos(roll * 0.5)
    sp, cp = math.sin(pitch * 0.5), math.cos(pitch * 0.5)
    sy, cy = math.sin(yaw * 0.5), math.cos(yaw * 0.5)
    return np.array(
        [
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * cp * cr + sy * sp * sr,
        ],
        dtype=np.float64,
    )


def euler_deg_to_quat(euler_xyz_deg) -> np.ndarray:
    """Euler degrees (pitch=X, yaw=Y, roll=Z) -> quaternion [x,y,z,w].

    Matches Transform.EulerToQuaternion (Transform.cs:50-59).
    """
    e = np.asarray(euler_xyz_deg, dtype=np.float64)
    d2r = math.pi / 180.0
    return quat_from_yaw_pitch_roll(e[1] * d2r, e[0] * d2r, e[2] * d2r)


def quat_rotation_matrix(q) -> np.ndarray:
    """Standard column-vector rotation matrix R with v_world = R @ v_local."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    n = x * x + y * y + z * z + w * w
    if n < 1e-12:
        return np.eye(3)
    s = 1.0 / math.sqrt(n)
    x, y, z, w = x * s, y * s, z * s, w * s
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotate_vector(v, q) -> np.ndarray:
    """Rotate v by quaternion q (System.Numerics Vector3.Transform(v, q))."""
    return quat_rotation_matrix(q) @ np.asarray(v, dtype=np.float64)


def obb_axes_from_quat(q):
    """OBB local axes as computed by the reference's BoxNode.

    BoxNode.cs Evaluate builds Matrix4x4.CreateFromQuaternion (row-vector
    convention, i.e. the transpose of :func:`quat_rotation_matrix`) and takes
    its *columns* (M11,M21,M31 / M12,M22,M32 / M13,M23,M33). Those columns
    equal the *rows* of the column-vector matrix, which is what we return.
    """
    r = quat_rotation_matrix(q)
    return r[0].copy(), r[1].copy(), r[2].copy()


@dataclass
class Transform:
    """UE5-style transform (Transform.cs:10-45)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    @property
    def euler_angles(self) -> np.ndarray:
        q = self.rotation
        x, y, z, w = q
        if x * x + y * y + z * z + w * w < 1e-10:
            return np.zeros(3)
        yaw = math.atan2(2.0 * (y * w + x * z), 1.0 - 2.0 * (x * x + y * y))
        sinp = 2.0 * (x * w - y * z)
        pitch = math.copysign(math.pi / 2, sinp) if abs(sinp) >= 1.0 else math.asin(sinp)
        roll = math.atan2(2.0 * (x * y + z * w), 1.0 - 2.0 * (x * x + z * z))
        r2d = 180.0 / math.pi
        return np.array([pitch * r2d, yaw * r2d, roll * r2d])

    @euler_angles.setter
    def euler_angles(self, value) -> None:
        self.rotation = euler_deg_to_quat(value)

    def matrix(self) -> np.ndarray:
        """4x4 row-vector-convention matrix: scale -> rotate -> translate.

        Matches Transform.GetMatrix (Transform.cs:102-110): with row vectors,
        M = S * R * T and points transform as p' = p @ M.
        """
        s = np.diag(np.concatenate([self.scale, [1.0]]))
        r4 = np.eye(4)
        # System.Numerics rotation matrix is the transpose of our column-vector R.
        r4[:3, :3] = quat_rotation_matrix(self.rotation).T
        t = np.eye(4)
        t[3, :3] = self.position
        return s @ r4 @ t

    def combine(self, parent: "Transform") -> "Transform":
        """this.Combine(parent): child-then-parent composition (Transform.cs:130-135)."""
        m = self.matrix() @ parent.matrix()
        return Transform.from_matrix(m)

    @staticmethod
    def from_matrix(m: np.ndarray) -> "Transform":
        """Decompose a row-vector-convention TRS matrix (no shear assumed)."""
        position = m[3, :3].copy()
        basis = m[:3, :3]
        scale = np.linalg.norm(basis, axis=1)
        # Guard degenerate scales.
        safe = np.where(scale < 1e-12, 1.0, scale)
        r_rowvec = basis / safe[:, None]
        if np.linalg.det(r_rowvec) < 0:
            scale = scale.copy()
            scale[0] = -scale[0]
            r_rowvec = r_rowvec.copy()
            r_rowvec[0] = -r_rowvec[0]
        r = r_rowvec.T  # column-vector convention
        # Rotation matrix -> quaternion (Shepperd's method).
        tr = np.trace(r)
        if tr > 0:
            s = math.sqrt(tr + 1.0) * 2
            w = 0.25 * s
            x = (r[2, 1] - r[1, 2]) / s
            y = (r[0, 2] - r[2, 0]) / s
            z = (r[1, 0] - r[0, 1]) / s
        elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
            s = math.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            w = (r[2, 1] - r[1, 2]) / s
            x = 0.25 * s
            y = (r[0, 1] + r[1, 0]) / s
            z = (r[0, 2] + r[2, 0]) / s
        elif r[1, 1] > r[2, 2]:
            s = math.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            w = (r[0, 2] - r[2, 0]) / s
            x = (r[0, 1] + r[1, 0]) / s
            y = 0.25 * s
            z = (r[1, 2] + r[2, 1]) / s
        else:
            s = math.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            w = (r[1, 0] - r[0, 1]) / s
            x = (r[0, 2] + r[2, 0]) / s
            y = (r[1, 2] + r[2, 1]) / s
            z = 0.25 * s
        return Transform(position=position, rotation=np.array([x, y, z, w]), scale=scale)

    def copy(self) -> "Transform":
        return Transform(
            position=np.array(self.position, dtype=np.float64),
            rotation=np.array(self.rotation, dtype=np.float64),
            scale=np.array(self.scale, dtype=np.float64),
        )
