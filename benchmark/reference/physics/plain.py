"""The reference's physics: the plain PyTorch versions of the port's two
physics kernels, with nothing of the kernels themselves.

:class:`FreePhysics` is the free-part substep loop (``engine.substeps``) and
:class:`ArmPhysics` the coupled arm and part substeps, both frozen from the
port's kernel wrappers (their ``plain_substeps`` and ``plain_control_step``)
and run on whatever device their tensors lie on. ``state_dtype`` makes the
control: the state rounded through a lower precision after every substep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..robots import kinematics as K
from .collide import robot_contacts, robot_torch_tables
from .engine import _rounded, make_substep, substeps as plain_substeps
from .state import PartState


class FreePhysics:
    """``substeps(parts, group, gscale, n)`` of the free parts."""

    def __init__(self, tables, cfg_sim, device, state_dtype=None):
        self.cfg = cfg_sim
        self._plain = make_substep(
            tables, dataclasses.replace(cfg_sim, use_pallas="off"), torch.device(device),
            state_dtype=state_dtype,
        )

    def substeps(self, parts: PartState, group, gscale, n: int) -> PartState:
        return plain_substeps(self._plain, parts, group, gscale, n)


def make_batched_substeps(tables, cfg_sim, device, state_dtype=None) -> FreePhysics:
    return FreePhysics(tables, cfg_sim, device, state_dtype)


class ArmPhysics:
    """``control_step(parts, group, gscale, qpos, qvel, ctrl, tau_extra, G1,
    G2, n)`` of arm and parts; ``free`` settles the parts at reset. The
    robot lane tables are those of the port's ``ArmMegaPhysics`` (lanes in
    ``collide.robot_contacts`` order), without its kernel tables."""

    def __init__(self, tables, robot, cfg_sim, device, state_dtype=None):
        self.free = free = FreePhysics(tables, cfg_sim, device, state_dtype)
        self.cfg = cfg_sim
        self.state_dtype = state_dtype
        self.robot = robot
        self._plain = free._plain
        P = len(tables["part_mass"])
        self.P = P
        gp = np.asarray(tables["geom_part"])
        self.n_arms = len(robot.arms)
        rpairs = np.asarray(tables["_robot_pairs"]).reshape(-1, 2)
        if not len(rpairs):
            raise ValueError("the arm physics needs robot contact pairs")
        lane_rg1 = np.asarray(tables["_rl_rgeom"])
        lane_pg1 = np.asarray(tables["_rl_pgeom"])
        L = len(lane_rg1)
        self.Kr = 2 * L
        K_base = 8 * len(gp) + 17 * len(np.asarray(tables["_pairs"]).reshape(-1, 2))
        self.K = K_base + self.Kr

        # hand geoms in hand order (rpairs is robot-geom-major)
        hand_list = list(dict.fromkeys(rpairs[:, 0].tolist()))
        slot_of = {g: i for i, g in enumerate(hand_list)}
        slot1 = np.array([slot_of[g] for g in lane_rg1])
        lane_slot = np.concatenate([slot1, slot1])
        lane_rg = np.concatenate([lane_rg1, lane_rg1])
        lane_part_r = gp[np.concatenate([lane_pg1, lane_pg1])]
        finger_of_geom = {}
        for a, arm in enumerate(robot.arms):
            for s, fg in enumerate((robot.finger_geoms_l[arm], robot.finger_geoms_r[arm])):
                for g in np.asarray(fg).tolist():
                    finger_of_geom[g] = a * 2 + s
        lane_finger = np.array([finger_of_geom.get(int(g), -1) for g in lane_rg], np.int32)
        NT = 2 * self.n_arms * P
        rg_anc = robot.ancestor[robot.geom_body[np.asarray(hand_list)]].astype(np.float32)

        dev = torch.device(device)
        self._rt = robot_torch_tables(tables, dev)
        self._anc_lane = torch.as_tensor(rg_anc[lane_slot], device=dev)      # [Kr,NJ]
        arm_of_lane = np.where(lane_finger >= 0, lane_finger // 2, -1)
        self._sqz = torch.as_tensor(
            np.stack([arm_of_lane == a for a in range(self.n_arms)]), device=dev
        )                                                                    # [n_arms,Kr]
        tm = np.zeros((NT, self.Kr), np.float32)
        on = np.flatnonzero(lane_finger >= 0)
        tm[lane_finger[on] * P + lane_part_r[on], on] = 1.0
        self._touchmap = torch.as_tensor(tm, device=dev)                     # [NT,Kr]
        self._grip = [
            (
                torch.as_tensor(np.asarray(robot.gripper_actuators[arm], np.int64), device=dev),
                torch.as_tensor(
                    np.asarray(robot.act_joint[robot.gripper_actuators[arm]], np.int64), device=dev
                ),
                torch.as_tensor(
                    np.asarray(robot.act_close_sign[robot.gripper_actuators[arm]], np.float32),
                    device=dev,
                ),
            )
            for arm in robot.arms
        ]

    def control_step(self, parts: PartState, group, gscale, qpos, qvel, ctrl,
                     tau_extra, G1, G2, n: int):
        """``n`` coupled substeps: ``(parts', qpos', qvel', touch [B,
        2*n_arms, P] bool)``."""
        r, cfg = self.robot, self.cfg
        dt, slop = cfg.timestep, cfg.contact_slop
        tt = self._plain.tables
        B = qpos.shape[0]
        lam = torch.zeros((B, self.K, 3), dtype=torch.float32, device=qpos.device)
        mask = torch.zeros((B, self.Kr), dtype=torch.bool, device=qpos.device)
        for _ in range(n):
            fk_out = K.fk(r, qpos)
            rg_pos, rg_quat = K.geom_world(r, fk_out)
            rg_vel, rg_ang = K.geom_velocities(r, fk_out, qvel)
            extra = robot_contacts(
                tt, self._rt, parts.pos, parts.quat, rg_pos, rg_quat, rg_vel, rg_ang, slop
            )
            mask = extra.mask
            # contact-aware gripper servo: once finger penetration exceeds
            # `gripper_squeeze` the closing direction is blocked (target
            # clamped to the current position); opening stays free
            ctrl_eff = ctrl.clone()
            press = torch.zeros_like(extra.depth)
            pinched = torch.zeros(group.shape, dtype=torch.bool, device=qpos.device)
            for a, (rows, gj, cs) in enumerate(self._grip):
                lanes = self._sqz[a]
                pen = torch.amax(
                    torch.where(mask & lanes, extra.depth, torch.full_like(extra.depth, -1e9)), -1
                )
                deep = pen > cfg.gripper_squeeze
                # the press engages at half the clamp threshold, and only
                # while the servo commands closing
                closing = torch.any(cs * (ctrl[:, rows] - qpos[:, gj]) > 0, -1)
                deep_floor = closing & (pen > 0.5 * cfg.gripper_squeeze)
                held = torch.where(
                    cs > 0,
                    torch.minimum(ctrl[:, rows], qpos[:, gj]),
                    torch.maximum(ctrl[:, rows], qpos[:, gj]),
                )
                ctrl_eff[:, rows] = torch.where(deep[:, None], held, ctrl[:, rows])
                press = press + (mask & lanes & deep_floor[:, None]).to(torch.float32)
                if cfg.held_vel_clamp > 0:
                    t = (mask.to(torch.float32) @ self._touchmap.T) > 0
                    t = t.reshape(B, 2 * self.n_arms, self.P)
                    pinched = pinched | (t[:, 2 * a] & t[:, 2 * a + 1] & deep_floor[:, None])
            tau, _, _ = K.actuator_torques(r, qpos, qvel, ctrl_eff)
            tau = tau + tau_extra
            # finger-servo press: an inward prescribed surface velocity on
            # the engaged finger lanes
            if cfg.grip_press_vel > 0:
                extra = extra._replace(
                    vel_b=extra.vel_b + cfg.grip_press_vel * press[..., None] * extra.normal
                )
            parts, lam, imp = self._plain(parts, group, gscale, lam, extra_contacts=extra)
            if cfg.robot_coupling:
                p_c = K.contact_impulses_to_joints(r, fk_out, extra.point, self._anc_lane, imp)
                pc_cap = cfg.robot_coupling_clamp * dt
                p_c = torch.clamp(p_c, -pc_cap, pc_cap)
            else:
                p_c = torch.zeros_like(qvel)
            if cfg.held_vel_clamp > 0:
                pin_g = torch.any(
                    (group[:, :, None] == group[:, None, :]) & pinched[:, None, :], -1
                )

                def cap_vec(v, cap):
                    nv = torch.linalg.norm(v, dim=-1, keepdim=True)
                    scale = torch.clamp(cap / torch.clamp(nv, min=1e-9), max=1.0)
                    return torch.where(pin_g[..., None], v * scale, v)

                parts = parts._replace(
                    lin_vel=cap_vec(parts.lin_vel, cfg.held_vel_clamp),
                    ang_vel=cap_vec(parts.ang_vel, cfg.held_angvel_clamp),
                )
            qpos, qvel = K.integrate_precomputed(r, G1, G2, qpos, qvel, tau, p_c, dt)
            if self.state_dtype is not None:
                qpos, qvel = _rounded(qpos, self.state_dtype), _rounded(qvel, self.state_dtype)
        touch = (mask.to(torch.float32) @ self._touchmap.T) > 0
        return parts, qpos, qvel, touch.reshape(B, 2 * self.n_arms, self.P)
