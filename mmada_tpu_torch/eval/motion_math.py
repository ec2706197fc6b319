"""Motion math: quaternion ops + HumanML3D joint recovery, numpy.

Equivalents of the reference's motion geometry used in t2m eval and
visualization: `qinv`/`qmul`/`qrot` (utils/quaternion.py:16-73),
`recover_root_rot_pos`/`recover_from_ric` (utils/motion_process.py:4-60).
These run host-side on small arrays (eval/visualization), so plain numpy
keeps them dependency-free and trivially checkable.

HumanML3D feature layout per frame (dim 263 = 4 + (J−1)·3 + (J−1)·6 +
J·3 + 4 with J=22): [root rot-vel, root lin-vel x/z, root height,
local joint positions (ric), rotations (cont6d), velocities, foot contacts].
"""

from __future__ import annotations

import numpy as np


def qinv(q: np.ndarray) -> np.ndarray:
    assert q.shape[-1] == 4
    out = q.copy()
    out[..., 1:] = -out[..., 1:]
    return out


def qmul(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    assert q.shape[-1] == 4 and r.shape[-1] == 4
    w1, x1, y1, z1 = np.moveaxis(q, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(r, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v by quaternions q (w,x,y,z convention)."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quaternion_to_cont6d(q: np.ndarray) -> np.ndarray:
    """First two rotation-matrix columns (utils/quaternion.py cont6d)."""
    w, x, y, z = np.moveaxis(q, -1, 0)
    col1 = np.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)],
        axis=-1,
    )
    col2 = np.stack(
        [2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)],
        axis=-1,
    )
    return np.concatenate([col1, col2], axis=-1)


def recover_root_rot_pos(data: np.ndarray):
    """Integrate root Y-rotation velocity and planar velocity into absolute
    root pose (utils/motion_process.py:4-23)."""
    rot_vel = data[..., 0]
    r_rot_ang = np.zeros_like(rot_vel)
    r_rot_ang[..., 1:] = rot_vel[..., :-1]
    r_rot_ang = np.cumsum(r_rot_ang, axis=-1)

    r_rot_quat = np.zeros(data.shape[:-1] + (4,), data.dtype)
    r_rot_quat[..., 0] = np.cos(r_rot_ang)
    r_rot_quat[..., 2] = np.sin(r_rot_ang)

    r_pos = np.zeros(data.shape[:-1] + (3,), data.dtype)
    r_pos[..., 1:, 0] = data[..., :-1, 1]
    r_pos[..., 1:, 2] = data[..., :-1, 2]
    r_pos = qrot(qinv(r_rot_quat), r_pos)
    r_pos = np.cumsum(r_pos, axis=-2)
    r_pos[..., 1] = data[..., 3]
    return r_rot_quat, r_pos


def recover_from_ric(data: np.ndarray, joints_num: int) -> np.ndarray:
    """Rotation-invariant-coordinate features → global joint positions
    `(..., T, J, 3)` (utils/motion_process.py:43-60)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4 : (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))

    rot = np.broadcast_to(
        qinv(r_rot_quat)[..., None, :], positions.shape[:-1] + (4,)
    )
    positions = qrot(rot, positions)

    positions = positions.copy()
    positions[..., 0] += r_pos[..., 0:1]
    positions[..., 2] += r_pos[..., 2:3]
    return np.concatenate([r_pos[..., None, :], positions], axis=-2)


def feature_dim(joints_num: int) -> int:
    """HumanML3D per-frame feature width (263 at J=22)."""
    return 4 + (joints_num - 1) * 3 + (joints_num - 1) * 6 + joints_num * 3 + 4
