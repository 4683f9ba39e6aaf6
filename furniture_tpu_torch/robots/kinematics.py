"""Batched articulated-chain kinematics and joint-space dynamics.

The port's counterpart of ``furniture_tpu.robots.kinematics``. Every
function takes a ``CompiledRobot`` (static numpy) plus ``qpos``/``qvel`` of
shape [B,NJ] and works on the whole batch: where the JAX package scans over
the bodies of one env and is vmapped by its caller, here a Python loop runs
over the ≤ 37 bodies on ``[B, ...]`` tensors.

The robot is gravity/bias-compensated every control step, so the
integrator needs no gravity or Coriolis term: M q̈ = τ_actuator − D q̇,
integrated semi-implicitly with actuator gains folded into an implicit
damping matrix.

Device copies of the robot's static arrays are cached per (robot, device)
in :func:`robot_tables`, so no function builds a tensor from numpy on the
step path.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import transforms as T
from .chain import HINGE, MOTOR, POSITION, VELOCITY, CompiledRobot

_TABLES: dict = {}


def robot_tables(robot: CompiledRobot, device) -> dict:
    """Device tensors of the robot's static arrays (cached)."""
    dev = torch.device(device)
    key = (id(robot), str(dev))
    hit = _TABLES.get(key)
    if hit is not None and hit["_robot"] is robot:
        return hit
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    hinge = (robot.jnt_type == HINGE).astype(np.float32)
    t = {
        "_robot": robot,
        "body_pos": f32(robot.body_pos),
        "body_quat": f32(robot.body_quat),
        "body_com": f32(robot.body_com),
        "body_mass": f32(robot.body_mass),
        "body_inertia": f32(robot.body_inertia),
        "jnt_axis": f32(robot.jnt_axis),
        "jnt_pos": f32(robot.jnt_pos),
        "jnt_body": i64(robot.jnt_body),
        "hinge": f32(hinge),
        "ancestor": f32(robot.ancestor),
        "armature": f32(robot.jnt_armature),
        "frictionloss": f32(robot.jnt_frictionloss),
        "maxvel": f32(robot.jnt_maxvel),
        "lo": f32(robot.jnt_range[:, 0]),
        "hi": f32(robot.jnt_range[:, 1]),
        "geom_body": i64(robot.geom_body),
        "geom_pos": f32(robot.geom_pos),
        "geom_quat": f32(robot.geom_quat),
        "act_joint": i64(robot.act_joint),
        "act_gain": f32(robot.act_gain),
        "act_clo": f32(robot.act_ctrlrange[:, 0]),
        "act_chi": f32(robot.act_ctrlrange[:, 1]),
        "act_flo": f32(robot.act_forcerange[:, 0]),
        "act_fhi": f32(robot.act_forcerange[:, 1]),
        # [NA,NJ] one-hot actuator -> joint, split by kind
        "a2j": f32(np.eye(robot.nj)[robot.act_joint]),
        "is_vel": f32(robot.act_kind == VELOCITY),
        "is_pos": f32(robot.act_kind == POSITION),
        "is_motor": f32(robot.act_kind == MOTOR),
        "eye": torch.eye(robot.nj, dtype=torch.float32, device=dev),
        "grip_site": {a: f32(robot.grip_site[a][1]) for a in robot.arms},
        "griptip_site": {a: f32(robot.griptip_site[a][1]) for a in robot.arms},
        "damping": {},
    }
    _TABLES[key] = t
    return t


def fk(robot: CompiledRobot, qpos: torch.Tensor) -> dict:
    """Forward kinematics for a batch ``qpos`` [B,NJ].

    Returns body world poses and joint world axes/anchors:
    body_pos [B,NB,3], body_quat [B,NB,4], axis_w [B,NJ,3], anchor_w [B,NJ,3].
    """
    t = robot_tables(robot, qpos.device)
    B = qpos.shape[0]
    pos_all, quat_all = [], []
    for b in range(robot.nb):
        par = int(robot.parent[b])
        lpos, lquat = t["body_pos"][b], t["body_quat"][b]
        if par < 0:
            pre_pos = lpos.expand(B, 3)
            pre_quat = lquat.expand(B, 4)
        else:
            pre_pos = pos_all[par] + T.quat_rotate(quat_all[par], lpos)
            pre_quat = T.quat_mul(quat_all[par], lquat)
        j = int(robot.body_joint[b])
        if j < 0:
            w_pos, w_quat = pre_pos, pre_quat
        elif int(robot.jnt_type[j]) == HINGE:
            # hinge: rotate about anchor jp along ax (MuJoCo semantics)
            ax, jp = t["jnt_axis"][j], t["jnt_pos"][j]
            q_rot = T.quat_from_axis_angle(ax.expand(B, 3), qpos[:, j])
            w_quat = T.quat_mul(pre_quat, q_rot)
            w_pos = pre_pos + T.quat_rotate(pre_quat, jp) - T.quat_rotate(w_quat, jp)
        else:
            ax = t["jnt_axis"][j]
            w_quat = pre_quat
            w_pos = pre_pos + T.quat_rotate(pre_quat, ax) * qpos[:, j : j + 1]
        pos_all.append(w_pos)
        quat_all.append(w_quat)
    body_pos = torch.stack(pos_all, 1)
    body_quat = torch.stack(quat_all, 1)
    jb = t["jnt_body"]
    # a hinge maps its own axis to itself, so the post-joint quat serves
    axis_w = T.quat_rotate(body_quat[:, jb], t["jnt_axis"])
    anchor_w = body_pos[:, jb] + T.quat_rotate(body_quat[:, jb], t["jnt_pos"])
    return {
        "body_pos": body_pos,
        "body_quat": body_quat,
        "axis_w": axis_w,
        "anchor_w": anchor_w,
    }


def point_jacobian(robot: CompiledRobot, fk_out, body_idx: int, point_w):
    """[B,6,NJ] spatial Jacobian of world ``point_w`` [B,3] rigidly attached
    to body ``body_idx`` (static int). Rows 0-2 linear, 3-5 angular."""
    t = robot_tables(robot, point_w.device)
    anc = t["ancestor"][body_idx]                                # [NJ]
    axis = fk_out["axis_w"]                                      # [B,NJ,3]
    anchor = fk_out["anchor_w"]
    hinge = t["hinge"][:, None]
    arm = point_w[:, None, :] - anchor
    jv = hinge * T.cross(axis, arm) + (1.0 - hinge) * axis
    jw = hinge * axis
    jv = jv * anc[:, None]
    jw = jw * anc[:, None]
    return torch.cat([jv.transpose(1, 2), jw.transpose(1, 2)], dim=1)


def body_jacobians(robot: CompiledRobot, fk_out):
    """Linear (at body COM) and angular Jacobians for every body:
    (Jv [B,NB,3,NJ], Jw [B,NB,3,NJ], com_w [B,NB,3])."""
    dev = fk_out["body_pos"].device
    t = robot_tables(robot, dev)
    anc = t["ancestor"]                                          # [NB,NJ]
    axis = fk_out["axis_w"]
    anchor = fk_out["anchor_w"]
    hinge = t["hinge"][:, None]
    com_w = fk_out["body_pos"] + T.quat_rotate(fk_out["body_quat"], t["body_com"])
    arm = com_w[:, :, None, :] - anchor[:, None, :, :]           # [B,NB,NJ,3]
    ax = axis[:, None].expand_as(arm)
    jv = hinge * T.cross(ax, arm) + (1.0 - hinge) * ax
    jw = hinge * ax
    jv = jv * anc[..., None]
    jw = jw * anc[..., None]
    return jv.transpose(2, 3), jw.transpose(2, 3), com_w


def mass_matrix(robot: CompiledRobot, fk_out):
    """Joint-space inertia ``M = Σ_b m_b Jv_bᵀJv_b + Jw_bᵀ I_b Jw_b`` plus
    armature on the diagonal; [B,NJ,NJ]."""
    t = robot_tables(robot, fk_out["body_pos"].device)
    jv, jw, _ = body_jacobians(robot, fk_out)                    # [B,NB,3,NJ]
    R = T.quat_to_mat(fk_out["body_quat"])
    I_w = R @ t["body_inertia"] @ R.transpose(-1, -2)
    M = torch.einsum("n,bnik,bnij->bkj", t["body_mass"], jv, jv) + torch.einsum(
        "bnik,bnil,bnlj->bkj", jw, I_w, jw
    )
    return M + torch.diag(t["armature"])


def gravity_bias(robot: CompiledRobot, fk_out, g: float = -9.81):
    """Joint-space gravity torque ``−Σ_b m_b Jv_bᵀ g``; [B,NJ]."""
    t = robot_tables(robot, fk_out["body_pos"].device)
    jv, _, _ = body_jacobians(robot, fk_out)
    return -g * torch.einsum("n,bnk->bk", t["body_mass"], jv[:, :, 2, :])


def actuator_torques(robot: CompiledRobot, qpos, qvel, ctrl):
    """Explicit actuator torque and implicit gains per joint for a batch:
    (tau [B,NJ], d_implicit [NJ], k_implicit [NJ]). Velocity servos give
    ``kv·ctrl`` (their ``−kv·q̇`` goes implicit), position servos
    ``kp·(ctrl − q)``, motors ``gear·ctrl`` clipped to the force range."""
    t = robot_tables(robot, qpos.device)
    c = torch.minimum(torch.maximum(ctrl, t["act_clo"]), t["act_chi"])
    gain = t["act_gain"]
    f_pos = gain * (c - qpos[:, t["act_joint"]])
    f_lin = gain * c
    f_motor = torch.minimum(torch.maximum(f_lin, t["act_flo"]), t["act_fhi"])
    f = t["is_vel"] * f_lin + t["is_pos"] * f_pos + t["is_motor"] * f_motor
    tau = f @ t["a2j"]
    d_imp = (t["is_vel"] * gain) @ t["a2j"]
    k_imp = (t["is_pos"] * gain) @ t["a2j"]
    return tau, d_imp, k_imp


def static_damping(robot: CompiledRobot, dt) -> np.ndarray:
    """Total implicit per-joint damping D = joint damping + actuator kv +
    dt·actuator kp (static)."""
    D = np.asarray(robot.jnt_damping, np.float64).copy()
    for i in range(robot.na):
        j = int(robot.act_joint[i])
        kind = int(robot.act_kind[i])
        gain = float(robot.act_gain[i])
        if kind == VELOCITY:
            D[j] += gain
        elif kind == POSITION:
            D[j] += dt * gain
    return D.astype(np.float32)


def joint_dyn_matrices(robot: CompiledRobot, qpos, dt):
    """The semi-implicit update matrices of one control step, [B,NJ,NJ]
    each: with A = M(q) + dt·diag(D) frozen over the control step, the
    substep update is ``q̇' = G1 q̇ + G2 (τ + p_contact/dt)`` with
    G1 = A⁻¹M and G2 = dt·A⁻¹ (A is symmetric positive definite: a
    Cholesky solve). This is the plain version, which the iLQR planner
    differentiates through: the arm env's step computes the same matrices
    on the card in one launch of the joint-dynamics kernel
    (``physics/arm_dynamics.py``). On the card this version synchronises
    the host in the batched ``cholesky_solve`` (``cholesky_ex`` does not)."""
    t = robot_tables(robot, qpos.device)
    M = mass_matrix(robot, fk(robot, qpos))
    D = t["damping"].get(dt)
    if D is None:
        D = torch.as_tensor(static_damping(robot, dt), device=qpos.device)
        t["damping"][dt] = D
    A = M + dt * torch.diag(D)
    L = torch.linalg.cholesky_ex(A).L
    Ainv = torch.cholesky_solve(t["eye"].expand_as(A), L)
    return Ainv @ M, dt * Ainv


def integrate_precomputed(robot: CompiledRobot, G1, G2, qpos, qvel, tau, p_c, dt):
    """One semi-implicit joint step with precomputed G1/G2. ``p_c`` [B,NJ]
    is a joint-space contact impulse (zeros when uncoupled)."""
    t = robot_tables(robot, qpos.device)
    rhs = tau - t["frictionloss"] * torch.tanh(qvel / 0.01) + p_c / dt
    new_qvel = (G1 @ qvel[..., None])[..., 0] + (G2 @ rhs[..., None])[..., 0]
    new_qvel = torch.minimum(torch.maximum(new_qvel, -t["maxvel"]), t["maxvel"])
    new_qpos = qpos + dt * new_qvel
    clamped = torch.minimum(torch.maximum(new_qpos, t["lo"]), t["hi"])
    hit = clamped != new_qpos
    new_qvel = torch.where(hit, torch.zeros_like(new_qvel), new_qvel)
    return clamped, new_qvel


def integrate(robot: CompiledRobot, M, qpos, qvel, tau, d_implicit, k_implicit, dt):
    """One semi-implicit joint integration step with the mass matrix given:
    solves ``(M + dt·D) q̇' = M q̇ + dt·(τ − frictionloss·tanh(q̇/ε))``, then
    clamps joint limits (zeroing the velocity of clamped joints)."""
    t = robot_tables(robot, qpos.device)
    D = torch.as_tensor(np.asarray(robot.jnt_damping, np.float32), device=qpos.device)
    D = D + d_implicit + dt * k_implicit
    rhs = (M @ qvel[..., None])[..., 0] + dt * (
        tau - t["frictionloss"] * torch.tanh(qvel / 0.01)
    )
    A = M + dt * torch.diag_embed(D.expand(qpos.shape))
    L = torch.linalg.cholesky_ex(A).L
    new_qvel = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    new_qvel = torch.minimum(torch.maximum(new_qvel, -t["maxvel"]), t["maxvel"])
    new_qpos = qpos + dt * new_qvel
    clamped = torch.minimum(torch.maximum(new_qpos, t["lo"]), t["hi"])
    hit = clamped != new_qpos
    return clamped, torch.where(hit, torch.zeros_like(new_qvel), new_qvel)


def body_angvel(robot: CompiledRobot, fk_out, qvel, body_idx: int):
    """World angular velocity of one body, [B,3]: hinge joints among its
    ancestors contribute ``q̇_j·axis_j``."""
    t = robot_tables(robot, qvel.device)
    w = t["ancestor"][body_idx] * t["hinge"] * qvel
    return torch.sum(w[..., None] * fk_out["axis_w"], dim=1)


def contact_impulses_to_joints(robot: CompiledRobot, fk_out, points, anc_mask, imp):
    """Joint-space reaction impulse of robot-lane contact impulses, Jᵀ(−λ):
    ``points`` [B,L,3] world contact points on robot geoms, ``anc_mask``
    [L,NJ] static ancestry of each lane's robot body, ``imp`` [B,L,3] the
    impulse the solver applied to the part at each lane. Returns [B,NJ]."""
    t = robot_tables(robot, points.device)
    axis = fk_out["axis_w"]                                      # [B,NJ,3]
    anchor = fk_out["anchor_w"]
    hinge = t["hinge"][None, None, :, None]
    dvec = points[:, :, None, :] - anchor[:, None, :, :]         # [B,L,NJ,3]
    ax = axis[:, None].expand_as(dvec)
    phi = hinge * T.cross(ax, dvec) + (1.0 - hinge) * ax
    phi = phi * anc_mask[None, :, :, None]
    return -torch.einsum("blji,bli->bj", phi, imp)


def geom_world(robot: CompiledRobot, fk_out):
    """World pose of every robot collision geom ([B,NG,3], [B,NG,4])."""
    t = robot_tables(robot, fk_out["body_pos"].device)
    gb = t["geom_body"]
    bp = fk_out["body_pos"][:, gb]
    bq = fk_out["body_quat"][:, gb]
    return bp + T.quat_rotate(bq, t["geom_pos"]), T.quat_mul(bq, t["geom_quat"])


def geom_velocities(robot: CompiledRobot, fk_out, qvel):
    """World linear velocity of every robot geom center and its body's
    angular velocity ([B,NG,3] each): the prescribed contact-point
    velocities of the kinematically treated gripper geoms."""
    t = robot_tables(robot, qvel.device)
    jv, jw, com_w = body_jacobians(robot, fk_out)                # [B,NB,3,NJ]
    v_com = (jv @ qvel[:, None, :, None])[..., 0]                # [B,NB,3]
    w_b = (jw @ qvel[:, None, :, None])[..., 0]
    gb = t["geom_body"]
    gpos_w, _ = geom_world(robot, fk_out)
    r = gpos_w - com_w[:, gb]
    v_geom = v_com[:, gb] + T.cross(w_b[:, gb], r)
    return v_geom, w_b[:, gb]


def site_world(robot: CompiledRobot, fk_out, arm: str):
    """World position/quat of the arm's grip site ([B,3], [B,4])."""
    b = robot.grip_site[arm][0]
    bq = fk_out["body_quat"][:, b]
    loc = robot_tables(robot, bq.device)["grip_site"][arm]
    return fk_out["body_pos"][:, b] + T.quat_rotate(bq, loc), bq


def tip_world(robot: CompiledRobot, fk_out, arm: str):
    """World position of the arm's griptip site, [B,3]."""
    b = robot.griptip_site[arm][0]
    bq = fk_out["body_quat"][:, b]
    loc = robot_tables(robot, bq.device)["griptip_site"][arm]
    return fk_out["body_pos"][:, b] + T.quat_rotate(bq, loc)


def eef_pose(robot: CompiledRobot, fk_out, arm: str):
    """World pose of the hand body ([B,3], [B,4])."""
    b = robot.eef_body[arm]
    return fk_out["body_pos"][:, b], fk_out["body_quat"][:, b]
