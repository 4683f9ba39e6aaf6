"""Batched damped-least-squares inverse kinematics.

The port's counterpart of ``furniture_tpu.controllers.ik``: IK is plain
PyTorch on the same FK that the dynamics use, for a whole batch at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import transforms as T
from ..robots import kinematics as K


def _pose_error(cur_pos, cur_quat, target_pos, target_quat):
    """6-vector twist moving (cur) toward (target); leading dims batch."""
    e_pos = target_pos - cur_pos
    # orientation error from the relative quaternion (axis * angle)
    dq = T.quat_mul(target_quat, T.quat_inv(cur_quat))
    dq = torch.where(dq[..., 0:1] < 0, -dq, dq)
    angle = 2.0 * torch.arccos(torch.clamp(dq[..., 0], -1.0, 1.0))
    axis = dq[..., 1:] / torch.clamp(
        torch.linalg.norm(dq[..., 1:], dim=-1, keepdim=True), min=1e-9
    )
    return torch.cat([e_pos, axis * angle[..., None]], dim=-1)


def dls_ik(
    robot,
    arm: str,
    qpos,
    target_pos,
    target_quat,
    iters: int = 20,
    damping: float = 1e-3,
    step_scale: float = 1.0,
):
    """Damped-least-squares IK for ``arm``'s hand body, batched.

    ``qpos`` [B,NJ], ``target_pos`` [B,3], ``target_quat`` [B,4]. Returns
    the full joint vectors with the arm's actuated joints moved to reach the
    target; other joints are untouched. The 6×6 system ``J Jᵀ + λI`` is
    symmetric positive definite: a Cholesky solve (``cholesky_ex``: no error
    check, so no host synchronisation; a NaN pose gives a NaN command, which
    the env's instability guard contains)."""
    t = K.robot_tables(robot, qpos.device)
    arm_j = torch.as_tensor(np.asarray(robot.arm_joints[arm], np.int64), device=qpos.device)
    body = robot.eef_body[arm]
    lo, hi = t["lo"][arm_j], t["hi"][arm_j]
    eye6 = damping * torch.eye(6, dtype=qpos.dtype, device=qpos.device)
    q = qpos
    for _ in range(iters):
        fk_out = K.fk(robot, q)
        cur_pos, cur_quat = K.eef_pose(robot, fk_out, arm)
        err = _pose_error(cur_pos, cur_quat, target_pos, target_quat)   # [B,6]
        J = K.point_jacobian(robot, fk_out, body, cur_pos)              # [B,6,NJ]
        Ja = J[:, :, arm_j]                                             # [B,6,na]
        JJt = Ja @ Ja.transpose(1, 2) + eye6
        sol = torch.cholesky_solve(err[..., None], torch.linalg.cholesky_ex(JJt).L)
        dq = (Ja.transpose(1, 2) @ sol)[..., 0]
        qa = torch.minimum(torch.maximum(q[:, arm_j] + step_scale * dq, lo), hi)
        q = q.clone()
        q[:, arm_j] = qa
    return q


def ik_velocities(qpos, q_cmd, arm_joints, gain: float = 5.0):
    """Joint-space P-controller to velocity commands, clipped to ±1."""
    delta = qpos[:, arm_joints] - q_cmd[:, arm_joints]
    return torch.clamp(-gain * delta, -1.0, 1.0)
