"""Rotation conversions for robot proprio/action translation: a copy of
intact_tpu/utils/geometry.py (transforms3d-style helpers built on
scipy.spatial.transform). Conventions:

  * Euler angles default to "sxyz" — static (extrinsic) X-Y-Z, i.e.
    R = Rz(ak) @ Ry(aj) @ Rx(ai). This matches transforms3d's default and is
    what Bridge/Simpler adapters assume.
  * Quaternions are [w, x, y, z] (transforms3d ordering), NOT scipy's xyzw.

These run on simulator/adapter hosts (numpy, float64), never on the card.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

_EPS = np.finfo(np.float64).eps * 4.0


def _seq_from_axes(axes: str) -> tuple[str, bool]:
    """Map a transforms3d axes string to a scipy seq + intrinsic flag."""
    if len(axes) != 4 or axes[0] not in "sr":
        raise ValueError(f"Unsupported axes spec: {axes!r}")
    intrinsic = axes[0] == "r"
    seq = axes[1:]
    if intrinsic:
        return seq.upper(), True
    return seq, False


def euler2mat(ai: float, aj: float, ak: float, axes: str = "sxyz") -> np.ndarray:
    seq, _ = _seq_from_axes(axes)
    return Rotation.from_euler(seq, [ai, aj, ak]).as_matrix()


def mat2euler(mat: np.ndarray, axes: str = "sxyz") -> tuple[float, float, float]:
    seq, _ = _seq_from_axes(axes)
    mat = np.asarray(mat, dtype=np.float64)
    if mat.shape[0] >= 4:  # accept affine
        mat = mat[:3, :3]
    ai, aj, ak = Rotation.from_matrix(mat[:3, :3]).as_euler(seq)
    return float(ai), float(aj), float(ak)


def euler2quat(ai: float, aj: float, ak: float, axes: str = "sxyz") -> np.ndarray:
    seq, _ = _seq_from_axes(axes)
    x, y, z, w = Rotation.from_euler(seq, [ai, aj, ak]).as_quat()
    q = np.array([w, x, y, z])
    # transforms3d returns quaternions with non-negative w
    return q if w >= 0 else -q


def quat2mat(q: np.ndarray) -> np.ndarray:
    """[w,x,y,z] quaternion -> 3x3 rotation matrix (identity if near-zero)."""
    q = np.asarray(q, dtype=np.float64)
    n = np.dot(q, q)
    if n < _EPS:
        return np.eye(3)
    w, x, y, z = q
    return Rotation.from_quat([x, y, z, w]).as_matrix()


def quat2euler(quaternion: np.ndarray, axes: str = "sxyz") -> tuple[float, float, float]:
    return mat2euler(quat2mat(quaternion), axes=axes)


def euler2axangle(
    ai: float, aj: float, ak: float, axes: str = "sxyz"
) -> tuple[np.ndarray, float]:
    """Euler angles -> (unit axis, angle). Identity maps to ([1,0,0], 0)."""
    seq, _ = _seq_from_axes(axes)
    rotvec = Rotation.from_euler(seq, [ai, aj, ak]).as_rotvec()
    angle = float(np.linalg.norm(rotvec))
    if angle < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    return rotvec / angle, angle


def quat2axangle(quat: np.ndarray) -> tuple[np.ndarray, float]:
    """[w,x,y,z] quaternion -> (unit axis, angle in [0, 2*pi]).

    transforms3d convention (theta = 2*acos(w), axis = v/||v|| UNFLIPPED):
    for w < 0 this yields angle > pi with the raw vector axis — the SAME
    3-vector the transforms3d/robosuite reference produces. scipy's
    as_rotvec would canonicalize to angle <= pi with a flipped axis, which
    is the same rotation but a DIFFERENT axis-angle vector, putting proprio
    out of distribution vs statistics computed with the reference
    convention (LiberoAdapter feeds this into normalized proprio)."""
    q = np.asarray(quat, dtype=np.float64)
    n = np.linalg.norm(q)
    if n < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    w, x, y, z = q / n
    s = np.sqrt(max(1.0 - w * w, 0.0))  # |sin(theta/2)|
    if s < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    angle = 2.0 * float(np.arccos(np.clip(w, -1.0, 1.0)))  # [0, 2*pi]
    return np.array([x, y, z]) / s, angle


def quat2axisangle(quat: np.ndarray) -> np.ndarray:
    """[w,x,y,z] quaternion -> axis*angle 3-vector (LIBERO convention)."""
    axis, angle = quat2axangle(quat)
    return axis * angle


def axangle2euler(axis: np.ndarray, angle: float, axes: str = "sxyz") -> tuple[float, float, float]:
    seq, _ = _seq_from_axes(axes)
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < _EPS or abs(angle) < _EPS:
        return 0.0, 0.0, 0.0
    ai, aj, ak = Rotation.from_rotvec(axis / n * angle).as_euler(seq)
    return float(ai), float(aj), float(ak)


def isrotation(mat: np.ndarray, atol: float = 1e-6) -> bool:
    mat = np.asarray(mat, dtype=np.float64)
    if mat.shape != (3, 3):
        return False
    return bool(
        np.allclose(mat @ mat.T, np.eye(3), atol=atol)
        and np.isclose(np.linalg.det(mat), 1.0, atol=atol)
    )
