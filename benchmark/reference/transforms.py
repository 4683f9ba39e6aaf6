"""Batched 3D transform library (quaternions, rotations, poses) in PyTorch.

The port's counterpart of ``furniture_tpu.transforms``: the same formulas in
the same order of operations, broadcast over arbitrary leading batch axes.

Conventions
-----------
* Quaternions are stored **wxyz** (MuJoCo / pyquaternion order).
* ``quat_rotate(q, v)`` is the active rotation ``R(q) v``.
* The ``up/forward/right`` direction extractors replicate the exact row
  formulas of the reference environment so alignment predicates agree.
* Angles in ``rotate_vector`` / ``euler_to_quat`` are **degrees**.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device and dtype."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# basic vector helpers
# ---------------------------------------------------------------------------

def unit(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize ``v`` along ``dim`` with the smoothed norm
    ``sqrt(Σv² + ε²)`` (differentiable at v = 0)."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + _EPS * _EPS)
    return v / n


def l2_dist(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.linalg.norm(a - b, dim=dim)


def cos_siml(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    num = torch.sum(a * b, dim=dim)
    den = torch.linalg.norm(a, dim=dim) * torch.linalg.norm(b, dim=dim)
    return num / torch.clamp(den, min=_EPS)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion core (wxyz)
# ---------------------------------------------------------------------------

def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 ∘ q2`` in wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        torch.broadcast_tensors(
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ),
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse for unit quaternions (conjugate)."""
    return quat_conj(q) / torch.clamp(
        torch.sum(q * q, dim=-1, keepdim=True), min=_EPS
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Active rotation of vector ``v`` by unit quaternion ``q`` (wxyz):
    ``R v = v + 2 w (u × v) + 2 u × (u × v)``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_axis_angle(axis: torch.Tensor, angle_rad: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from (unnormalized) axis and angle in radians."""
    axis = unit(axis)
    half = angle_rad[..., None] * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """3x3 active rotation matrix from wxyz quaternion."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion from a 3x3 rotation matrix (branch-free Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    c0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        dim=-1,
    )
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 0.5
    c1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        dim=-1,
    )
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 0.5
    c2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        dim=-1,
    )
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 0.5
    c3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        dim=-1,
    )

    cases = torch.stack([c0, c1, c2, c3], dim=-2)  # [..., 4 cases, 4]
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    best = torch.argmax(scores, dim=-1)            # first maximum, as jnp
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cases, -2, idx)[..., 0, :]
    return quat_normalize(q)


def euler_to_quat(rot_deg: torch.Tensor, base_quat: torch.Tensor | None = None) -> torch.Tensor:
    """``rot_deg`` = (rx, ry, rz) in degrees; result is
    ``base ∘ (qz ∘ qy ∘ qx)`` — the offset applied in the body frame."""
    half = torch.deg2rad(rot_deg) * 0.5
    cx, cy, cz = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sx, sy, sz = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    q = torch.stack(
        [
            cz * cy * cx + sz * sy * sx,
            cz * cy * sx - sz * sy * cx,
            cz * sy * cx + sz * cy * sx,
            sz * cy * cx - cz * sy * sx,
        ],
        dim=-1,
    )
    if base_quat is not None:
        q = quat_mul(base_quat, q)
    return q


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation (shortest arc), wxyz."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    d = torch.clamp(d, -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    t = _as(t, q0)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    s = torch.clamp(sin_theta, min=_EPS)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / s)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / s)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# reference-exact direction extractors
# ---------------------------------------------------------------------------

def forward_vector_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )


def up_vector_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )


def right_vector_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )


def lookat_to_quat(forward: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Rotation with rows (right, true_up, forward) as a wxyz quaternion."""
    v = unit(forward)
    v2 = unit(cross(unit(up), v))
    v3 = cross(v, v2)
    m = torch.stack([v2, v3, v], dim=-2)
    return mat_to_quat(m)


def rotate_vector(v: torch.Tensor, axis: torch.Tensor, angle_deg) -> torch.Tensor:
    """Rodrigues rotation by degrees without the (1-cos) k(k·v) term —
    exact only for v ⟂ axis, like the reference."""
    k = unit(axis)
    a = torch.deg2rad(_as(angle_deg, v))[..., None]
    return torch.cos(a) * v + torch.sin(a) * cross(k, v)


def rotate_vector_cos_siml(
    v: torch.Tensor, axis: torch.Tensor, cos: torch.Tensor, direction: float
) -> torch.Tensor:
    k = unit(axis)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))[..., None]
    return cos[..., None] * v + direction * sin * cross(k, v)


# ---------------------------------------------------------------------------
# pose ops
# ---------------------------------------------------------------------------

def angle_between2D(cur: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    a_cur = torch.atan2(cur[..., 1], cur[..., 0])
    a_tgt = torch.atan2(tgt[..., 1], tgt[..., 0])
    return a_tgt - a_cur


def angle_between(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    c = cos_siml(v1, v2)
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


def rotate_vector2D(vec: torch.Tensor, angle_rad: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    return torch.stack(
        [c * vec[..., 0] - s * vec[..., 1], s * vec[..., 0] + c * vec[..., 1]],
        dim=-1,
    )


def rel_pose(pose1: torch.Tensor, pose2: torch.Tensor) -> torch.Tensor:
    """Pose of ``pose2`` in ``pose1``'s frame, as (pos3, quat4-wxyz)."""
    inv1 = quat_inv(pose1[..., 3:7])
    rp = quat_rotate(inv1, pose2[..., :3] - pose1[..., :3])
    rq = quat_mul(inv1, pose2[..., 3:7])
    return torch.cat([rp, rq], dim=-1)


def transform_to_target_quat(
    qpos_base: torch.Tensor, qpos: torch.Tensor, target_quat: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rigid co-rotation of ``qpos`` when ``qpos_base`` is rotated (in place)
    to ``target_quat``."""
    rel_rot = quat_mul(target_quat, quat_inv(qpos_base[..., 3:7]))
    new_pos = quat_rotate(rel_rot, qpos[..., :3] - qpos_base[..., :3]) + qpos_base[..., :3]
    new_quat = quat_mul(rel_rot, qpos[..., 3:7])
    return new_pos, new_quat


def pose_mul(pos1, quat1, pos2, quat2):
    """Compose poses: world_T_a ∘ a_T_b → (pos, quat) of b in world."""
    return pos1 + quat_rotate(quat1, pos2), quat_mul(quat1, quat2)


def pose_inv(pos, quat):
    iq = quat_inv(quat)
    return -quat_rotate(iq, pos), iq


def convert_quat(q: torch.Tensor, to: str = "xyzw") -> torch.Tensor:
    if to == "xyzw":
        return q[..., [1, 2, 3, 0]]
    if to == "wxyz":
        return q[..., [3, 0, 1, 2]]
    raise ValueError(f"bad order {to}")
