"""Torque-space controllers: operational-space (position/orientation),
joint impedance, joint velocity.

The port's counterpart of ``furniture_tpu.controllers.osc``, batched over a
leading env dimension B: lambda matrices through an SVD-regularized
``(J M^-1 J^T)^-1``, an impedance wrench mapped to ``tau = J^T F`` with a
nullspace posture torque, critically damped joint impedance, and the
velocity servo ``tau = kv (qd_des - qd)``, on the port's own FK and mass
matrix. Plain PyTorch (``torch.linalg.svd`` and ``inv``): the JAX package
computes these outside any Pallas kernel too.

Gains come from the converted controller config, read in place from the JAX
package's assets (``furniture_tpu/assets/controller_config.json``).
"""

from __future__ import annotations

import json
from functools import lru_cache

import numpy as np
import torch

from .. import transforms as T
from ..models import ASSET_DIR
from ..robots import kinematics as K


@lru_cache(maxsize=1)
def load_controller_config() -> dict:
    """The controller gains; callers treat the returned dict as read-only."""
    with open(ASSET_DIR / "controller_config.json") as f:
        return json.load(f)


def orientation_error(desired_mat, current_mat):
    """Rotational error between rotation matrices [...,3,3]:
    ``e = 1/2 sum_i r_i x d_i`` over the columns."""
    rc = current_mat.transpose(-1, -2)   # columns of current as rows
    rd = desired_mat.transpose(-1, -2)
    return 0.5 * (
        T.cross(rc[..., 0, :], rd[..., 0, :])
        + T.cross(rc[..., 1, :], rd[..., 1, :])
        + T.cross(rc[..., 2, :], rd[..., 2, :])
    )


def _svd_clamped_inv(A, threshold: float = 0.00025):
    """Pseudo-inverse of [...,n,n] zeroing singular values below
    ``threshold`` (singularity handling of the lambda matrices)."""
    u, s, vt = torch.linalg.svd(A)
    s_inv = torch.where(s < threshold, torch.zeros_like(s), 1.0 / torch.clamp(s, min=1e-12))
    return vt.transpose(-1, -2) @ (s_inv[..., :, None] * u.transpose(-1, -2))


def osc_torques(
    robot,
    arm: str,
    fk_out,
    M,
    qpos,
    qvel,
    goal_pos,
    goal_mat,
    kp_pos,
    kp_ori,
    damping,
    initial_joint=None,
    position_only: bool = False,
):
    """Operational-space control torques [B,na] for ``arm``.

    * impedance wrench ``F = kp e - kv v`` with critical damping
      ``kv = 2 sqrt(kp) damping``;
    * decoupling by lambda matrices with SVD-clamped inversion;
    * ``tau = J^T [lam_x F; lam_r T]`` plus a nullspace posture torque toward
      ``initial_joint`` (joint_kp = 10).

    ``M`` [B,NJ,NJ], ``qpos``/``qvel`` [B,NJ], ``goal_pos`` [B,3],
    ``goal_mat`` [B,3,3]."""
    dev = qpos.device
    arm_j = torch.as_tensor(np.asarray(robot.arm_joints[arm], np.int64), device=dev)
    body = robot.eef_body[arm]
    eef_pos, eef_quat = K.eef_pose(robot, fk_out, arm)
    cur_mat = T.quat_to_mat(eef_quat)
    J = K.point_jacobian(robot, fk_out, body, eef_pos)[:, :, arm_j]    # [B,6,na]
    Jx, Jr = J[:, :3], J[:, 3:]
    qv = qvel[:, arm_j]
    vel = (J @ qv[..., None])[..., 0]                                  # [B,6]

    kv_pos = 2.0 * float(np.sqrt(kp_pos)) * damping
    kv_ori = 2.0 * float(np.sqrt(kp_ori)) * damping
    F = kp_pos * (goal_pos - eef_pos) - kv_pos * vel[:, :3]
    if position_only:
        Tq = -kv_ori * vel[:, 3:]
    else:
        Tq = kp_ori * orientation_error(goal_mat, cur_mat) - kv_ori * vel[:, 3:]

    Ma = M[:, arm_j][:, :, arm_j]       # arm block of the joint-space inertia
    M_inv = torch.linalg.inv(Ma)
    lam_x = _svd_clamped_inv(Jx @ M_inv @ Jx.transpose(1, 2))
    lam_r = _svd_clamped_inv(Jr @ M_inv @ Jr.transpose(1, 2))
    wrench = torch.cat([(lam_x @ F[..., None])[..., 0], (lam_r @ Tq[..., None])[..., 0]], -1)
    torques = (J.transpose(1, 2) @ wrench[..., None])[..., 0]          # [B,na]

    if initial_joint is not None:
        joint_kp = 10.0
        joint_kv = 2.0 * float(np.sqrt(joint_kp))
        q0 = torch.as_tensor(np.asarray(initial_joint, np.float32), device=dev)
        pose_tau = (Ma @ (joint_kp * (q0 - qpos[:, arm_j]) - joint_kv * qv)[..., None])[..., 0]
        lam = _svd_clamped_inv(J @ M_inv @ J.transpose(1, 2))
        Jbar = M_inv @ J.transpose(1, 2) @ lam
        null = torch.eye(len(arm_j), dtype=qpos.dtype, device=dev) - Jbar @ J
        torques = torques + (null.transpose(1, 2) @ pose_tau[..., None])[..., 0]
    return torques


def joint_impedance_torques(M_arm, qpos_arm, qvel_arm, goal_qpos, kp, damping):
    """Critically damped joint-space impedance with mass-matrix decoupling:
    ``tau = M (kp e - kv qd)``, ``kv = 2 sqrt(kp) damping``; [B,na]."""
    kv = 2.0 * torch.sqrt(kp) * damping
    acc = kp * (goal_qpos - qpos_arm) - kv * qvel_arm
    return (M_arm @ acc[..., None])[..., 0]


def joint_velocity_torques(qvel_arm, goal_qvel, kv):
    """``tau = kv (qd_des - qd)``."""
    return kv * (goal_qvel - qvel_arm)
