"""Batched 3D rotation conversions (euler / rotation-matrix / expmap / quat).

The port's copy of the JAX package's `mocap/rotations.py`, numpy only
(the JAX package dispatches jax arrays to jax.numpy; every caller here
is host-side numpy). Every conversion is a single vectorized op over
arbitrary leading batch dimensions, with the same operations in the
same order as the JAX package's numpy path, so the results are the same
bits.

Conventions (identical to scipy.spatial.transform.Rotation, which the
reference uses): uppercase order strings ("ZXY") are INTRINSIC rotations
applied in sequence, i.e. R = R_axis0(a0) @ R_axis1(a1) @ R_axis2(a2).
Euler angles are in degrees at the API boundary (BVH convention).
"""
from __future__ import annotations

import numpy as np

_AXIS = {"X": 0, "Y": 1, "Z": 2}
_CYCLIC = {"XYZ", "YZX", "ZXY"}


def _axis_matrix(angle_rad, axis: int):
    """Rotation matrices about a fixed axis; angle_rad has any batch shape."""
    c = np.cos(angle_rad)
    s = np.sin(angle_rad)
    one = np.ones_like(c)
    zero = np.zeros_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def euler_to_matrix(euler_deg, order: str = "ZXY"):
    """(..., 3) intrinsic euler angles in degrees -> (..., 3, 3) matrices."""
    e = np.deg2rad(np.asarray(euler_deg))
    axes = [_AXIS[c] for c in order.upper()]
    m = _axis_matrix(e[..., 0], axes[0])
    m = np.matmul(m, _axis_matrix(e[..., 1], axes[1]))
    m = np.matmul(m, _axis_matrix(e[..., 2], axes[2]))
    return m


def matrix_to_euler(mat, order: str = "ZXY"):
    """(..., 3, 3) matrices -> (..., 3) intrinsic euler angles in degrees.

    Analytic Tait-Bryan extraction, valid for the six orders with three
    distinct axes. At gimbal lock (|sin(beta)|=1) the third angle is
    conventionally folded into the first, matching scipy.
    """
    order = order.upper()
    i, j, k = (_AXIS[c] for c in order)
    eps = 1.0 if order in _CYCLIC else -1.0
    m = np.asarray(mat)

    sb = np.clip(eps * m[..., i, k], -1.0, 1.0)
    beta = np.arcsin(sb)
    alpha = np.arctan2(-eps * m[..., j, k], m[..., k, k])
    gamma = np.arctan2(-eps * m[..., i, j], m[..., i, i])

    # gimbal lock: beta = +-pi/2 -> alpha,gamma degenerate; set gamma=0
    # and recover alpha from the remaining entries.
    locked = np.abs(sb) > 1.0 - 1e-7
    alpha_lock = np.arctan2(np.sign(sb) * m[..., j, i], m[..., j, j])
    alpha = np.where(locked, alpha_lock, alpha)
    gamma = np.where(locked, np.zeros_like(gamma), gamma)

    return np.rad2deg(np.stack([alpha, beta, gamma], axis=-1))


def rotvec_to_matrix(rotvec):
    """(..., 3) exponential-map rotation vectors (radians) -> (..., 3, 3)."""
    v = np.asarray(rotvec)
    theta2 = np.sum(v * v, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    theta = np.sqrt(theta2)
    # Taylor-safe coefficients: sin(t)/t and (1-cos(t))/t^2
    small = theta2 < 1e-12
    safe_t = np.where(small, 1.0, theta)
    safe_t2 = np.where(small, 1.0, theta2)
    a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / safe_t)
    b = np.where(small, 0.5 - theta2 / 24.0, (1.0 - np.cos(theta)) / safe_t2)

    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([
        np.stack([zero, -z, y], axis=-1),
        np.stack([z, zero, -x], axis=-1),
        np.stack([-y, x, zero], axis=-1),
    ], axis=-2)
    eye = np.broadcast_to(np.eye(3, dtype=K.dtype), K.shape)
    return eye + a * K + b * np.matmul(K, K)


def matrix_to_quat(mat):
    """(..., 3, 3) -> (..., 4) quaternions (x, y, z, w), scipy layout.

    Branch-free Shepperd method: compute all four candidate
    constructions, pick the numerically largest pivot per element.
    """
    m = np.asarray(mat)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qs = np.stack([
        1.0 + m00 - m11 - m22,  # x pivot
        1.0 - m00 + m11 - m22,  # y pivot
        1.0 - m00 - m11 + m22,  # z pivot
        1.0 + tr,               # w pivot
    ], axis=-1)
    pivot = np.argmax(qs, axis=-1)
    s = np.sqrt(np.maximum(np.take_along_axis(qs, pivot[..., None],
                                              axis=-1)[..., 0], 1e-12)) * 2.0

    a01 = m[..., 0, 1] + m[..., 1, 0]
    a02 = m[..., 0, 2] + m[..., 2, 0]
    a12 = m[..., 1, 2] + m[..., 2, 1]
    s21 = m[..., 2, 1] - m[..., 1, 2]
    s02 = m[..., 0, 2] - m[..., 2, 0]
    s10 = m[..., 1, 0] - m[..., 0, 1]

    cand = np.stack([
        np.stack([qs[..., 0], a01, a02, s21], axis=-1),        # pivot x
        np.stack([a01, qs[..., 1], a12, s02], axis=-1),        # pivot y
        np.stack([a02, a12, qs[..., 2], s10], axis=-1),        # pivot z
        np.stack([s21, s02, s10, qs[..., 3]], axis=-1),        # pivot w
    ], axis=-2)  # (..., 4 pivots, 4 components)
    sel = np.broadcast_to(pivot[..., None, None],
                          pivot.shape + (1, 4))
    q = np.take_along_axis(cand, sel, axis=-2)[..., 0, :] / s[..., None]
    # canonical sign: w >= 0
    return q * np.where(q[..., 3:4] < 0, -1.0, 1.0)


def matrix_to_rotvec(mat):
    """(..., 3, 3) -> (..., 3) exponential map (radians), via quaternions."""
    q = matrix_to_quat(mat)
    xyz = q[..., :3]
    w = q[..., 3]
    norm = np.sqrt(np.sum(xyz * xyz, axis=-1))
    angle = 2.0 * np.arctan2(norm, w)
    small = norm < 1e-12
    scale = np.where(small, 2.0, angle / np.where(small, 1.0, norm))
    return xyz * scale[..., None]


def euler_to_rotvec(euler_deg, order: str = "ZXY"):
    return matrix_to_rotvec(euler_to_matrix(euler_deg, order))


def rotvec_to_euler(rotvec, order: str = "ZXY"):
    return matrix_to_euler(rotvec_to_matrix(rotvec), order)


def unroll_rotvec(rotvec: np.ndarray) -> np.ndarray:
    """Remove 2*pi discontinuities along the time axis of (T, 3) rotvecs.

    Host-side (numpy) equivalent of the reference's fix_rotvec
    (ref: scripts/pymo/preprocessing.py:59-84): whenever the alternative
    representation (axis flipped, angle -> 2*pi - angle) is closer to the
    previous frame than the direct one, flip an interval.
    """
    rots = np.asarray(rotvec, dtype=np.float64)
    new_rots = rots.copy()
    angs = np.linalg.norm(rots, axis=1)
    alt_angs = 2 * np.pi - angs
    d_direct = np.diff(angs, axis=0)
    d_alt = alt_angs[1:] - angs[:-1]
    swaps = np.where(np.abs(d_alt) < np.abs(d_direct))[0]
    if swaps.shape[0] % 2 == 1:
        swaps = swaps[:-1]
    intervals = 1 + swaps.reshape((-1, 2))
    for lo, hi in intervals:
        denom = np.where(angs[lo:hi] == 0, 1.0, angs[lo:hi])[:, None]
        axis = -rots[lo:hi] / denom
        new_rots[lo:hi] = axis * alt_angs[lo:hi, None]
    return new_rots
