"""Frozen copy of ``dbot_ros_tpu_torch/utils/se3.py`` (commit 8da1569), with its
imports pointed at the other frozen copies beside it. The benchmark's
reference computes with it; it imports nothing of the port, so later
changes to the port cannot move the yardstick.

The original docstring follows.

Batched SE(3) / SO(3) algebra on torch tensors.

Port of ``dbot_ros_tpu/utils/se3.py``; same conventions:

* Quaternions are ``(w, x, y, z)``, unit-norm, ``float32``.
* Rotation vectors (axis-angle / so(3) exp-map coordinates) are ``(3,)``.
* A pose is ``(7,) = [tx, ty, tz, qw, qx, qy, qz]`` acting as
  ``x_world = R(q) @ x_obj + t``.
* A pose-velocity state is ``(13,) = pose(7) ++ v_lin(3) ++ v_ang(3)``.

Every function maps over arbitrary leading batch axes.
"""

from __future__ import annotations

import math

import torch

# Small angle threshold below which Taylor expansions are used.
_EPS = 1e-8


def _sign_fix(q):
    """Multiply by -1 where the scalar part is negative (canonical w >= 0)."""
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Quaternion algebra
# ---------------------------------------------------------------------------

def quat_identity(batch_shape=(), dtype=torch.float32, device=None):
    """Identity quaternion broadcast to ``batch_shape + (4,)``."""
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_multiply(q1, q2):
    """Hamilton product; composition of rotations: R(q1 ⊗ q2) = R(q1) R(q2)."""
    w1, x1, y1, z1 = torch.movedim(q1, -1, 0)
    w2, x2, y2, z2 = torch.movedim(q2, -1, 0)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    # no constant built per call: on a CUDA device that would be a copy
    # from the host, which drains the queue
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors ``v[..., 3]`` by quaternions ``q[..., 4]``."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q):
    """Unit quaternion → rotation matrix ``[..., 3, 3]``."""
    w, x, y, z = torch.movedim(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix ``[..., 3, 3]`` → unit quaternion (Shepperd, w ≥ 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01],
                     -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    diag = torch.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
         1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(diag, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return _sign_fix(quat_normalize(q))


# ---------------------------------------------------------------------------
# so(3) exp / log maps
# ---------------------------------------------------------------------------

def so3_exp_quat(w):
    """Rotation vector ``w[..., 3]`` → quaternion, small-angle safe."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta_sq, _EPS * _EPS))
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def so3_log(q):
    """Quaternion → rotation vector (inverse of :func:`so3_exp_quat`)."""
    q = _sign_fix(q)  # shortest arc
    qw = torch.clamp(q[..., :1], -1.0, 1.0)
    qv = q[..., 1:]
    sin_half = torch.linalg.norm(qv, dim=-1, keepdim=True)
    half = torch.atan2(sin_half, qw)
    small = sin_half < _EPS
    scale = torch.where(small, 2.0,
                        2.0 * half / torch.clamp_min(sin_half, _EPS))
    return scale * qv


def quat_boxplus(q, w):
    """Perturb rotation on the left by tangent vector ``w``: exp(w) ⊗ q."""
    return quat_multiply(so3_exp_quat(w), q)


def quat_boxminus(q1, q2):
    """Left tangent difference: log(q1 ⊗ q2⁻¹) so that q2 ⊞ (q1 ⊟ q2) = q1."""
    return so3_log(quat_multiply(q1, quat_conjugate(q2)))


# ---------------------------------------------------------------------------
# Poses  (7,) = [t(3), q(4)]
# ---------------------------------------------------------------------------

def pose_identity(batch_shape=(), dtype=torch.float32, device=None):
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    return torch.cat([t, quat_identity(batch_shape, dtype, device)], dim=-1)


def make_pose(t, q):
    return torch.cat([t, q], dim=-1)


def pose_trans(p):
    return p[..., :3]


def pose_quat(p):
    return p[..., 3:7]


def pose_apply(p, v):
    """Apply pose to points ``v[..., 3]``: R v + t."""
    return quat_rotate(pose_quat(p), v) + pose_trans(p)


def pose_compose(p1, p2):
    """(p1 ∘ p2)(x) = p1(p2(x))."""
    t = quat_rotate(pose_quat(p1), pose_trans(p2)) + pose_trans(p1)
    q = quat_multiply(pose_quat(p1), pose_quat(p2))
    return make_pose(t, q)


def pose_inverse(p):
    qi = quat_conjugate(pose_quat(p))
    return make_pose(-quat_rotate(qi, pose_trans(p)), qi)


def pose_to_matrix(p):
    """Pose → homogeneous transform ``[..., 4, 4]``."""
    R = quat_to_matrix(pose_quat(p))
    t = pose_trans(p)[..., :, None]
    top = torch.cat([R, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(m):
    return make_pose(m[..., :3, 3], matrix_to_quat(m[..., :3, :3]))


def pose_boxplus(p, xi):
    """Perturb pose by tangent ``xi[..., 6] = [dt(3), dw(3)]``: translation
    additively in the world frame, rotation on the left."""
    t = pose_trans(p) + xi[..., :3]
    q = quat_boxplus(pose_quat(p), xi[..., 3:6])
    return make_pose(t, q)


def pose_boxminus(p1, p2):
    """Tangent difference s.t. ``p2 ⊞ (p1 ⊟ p2) = p1`` under pose_boxplus."""
    dt = pose_trans(p1) - pose_trans(p2)
    dw = quat_boxminus(pose_quat(p1), pose_quat(p2))
    return torch.cat([dt, dw], dim=-1)


# ---------------------------------------------------------------------------
# Pose-velocity states  (13,) = [pose(7), v_lin(3), v_ang(3)]
# ---------------------------------------------------------------------------

STATE_DIM = 13
TANGENT_DIM = 12


def state_identity(batch_shape=(), dtype=torch.float32, device=None):
    v = torch.zeros(tuple(batch_shape) + (6,), dtype=dtype, device=device)
    return torch.cat([pose_identity(batch_shape, dtype, device), v], dim=-1)


def state_pose(s):
    return s[..., :7]


def state_velocity(s):
    """Returns ``[..., 6]`` = [v_lin, v_ang]."""
    return s[..., 7:13]


def make_state(pose, velocity):
    return torch.cat([pose, velocity], dim=-1)


def state_boxplus(s, xi):
    """Perturb a 13-dim state by a 12-dim tangent [dpose(6), dvel(6)]."""
    p = pose_boxplus(state_pose(s), xi[..., :6])
    v = state_velocity(s) + xi[..., 6:12]
    return make_state(p, v)


def state_boxminus(s1, s2):
    dp = pose_boxminus(state_pose(s1), state_pose(s2))
    dv = state_velocity(s1) - state_velocity(s2)
    return torch.cat([dp, dv], dim=-1)


def states_mean(states, weights=None):
    """Weighted mean of states ``[N, ..., 13]`` over the leading axis.

    Position/velocity: arithmetic mean. Orientation: chordal mean, the
    principal eigenvector of the weighted quaternion outer-product sum,
    found by 12 steps of power iteration from the dominant diagonal
    column, then sign-fixed to w >= 0 (Markley; robust to the q/-q
    ambiguity).
    """
    if weights is None:
        n = states.shape[0]
        weights = torch.full((n,), 1.0 / n, dtype=states.dtype,
                             device=states.device)
    wshape = (states.shape[0],) + (1,) * (states.ndim - 1)
    w = weights.reshape(wshape)
    lin = torch.sum(w * states, dim=0)
    q = state_pose(states)[..., 3:7]
    A = torch.sum(w[..., None] * q[..., :, None] * q[..., None, :], dim=0)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    col = torch.argmax(diag, dim=-1)
    idx = col[..., None, None].expand(col.shape + (4, 1))
    init = torch.gather(A, -1, idx)[..., 0]
    qm = init / torch.linalg.norm(init, dim=-1, keepdim=True)
    for _ in range(12):
        qm = torch.einsum("...ij,...j->...i", A, qm)
        qm = qm / torch.clamp_min(torch.linalg.norm(qm, dim=-1, keepdim=True),
                                  1e-20)
    qm = _sign_fix(qm)
    return torch.cat([lin[..., :3], qm, lin[..., 7:13]], dim=-1)


# ---------------------------------------------------------------------------
# Symmetry-aware rotation error (evaluation metric)
# ---------------------------------------------------------------------------

def box_symmetry_quats(include_identity: bool = True, device=None):
    """Proper rotational symmetry group of a generic cuboid:
    {identity, pi about x, pi about y, pi about z}."""
    quats = ([torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)]
             if include_identity else [])
    for ax in range(3):
        v = torch.zeros((3,), device=device)
        v[ax] = math.pi
        quats.append(so3_exp_quat(v))
    return torch.stack(quats)


def rotation_error_symmetric(q_est, q_gt, sym_quats):
    """``min_s ||log(q_est ⊗ (q_gt ⊗ s)⁻¹)||`` over ``sym_quats`` (S, 4)."""
    sym_quats = torch.as_tensor(sym_quats, dtype=torch.float32,
                                device=q_gt.device)
    cand = quat_multiply(q_gt[..., None, :],
                         sym_quats[(None,) * (q_gt.ndim - 1)])
    err = torch.linalg.norm(quat_boxminus(q_est[..., None, :], cand), dim=-1)
    return torch.min(err, dim=-1).values
