"""Whole-control-step arm physics: the hand-written CUDA kernel, its wrapper
and its plain PyTorch version.

The port's counterpart of ``furniture_tpu.physics.arm_megakernel``. One
launch of ``csrc/arm_megakernel.cu`` runs ``n`` coupled substeps of arm and
parts for every env of a batch, one thread block per env (see the note at
the top of the ``.cu`` file): forward kinematics, the robot contact lanes
beside the part lanes of the free-part kernel, the gripper squeeze servo and
press, actuator forces, the all-lane contact solve, the contact reaction on
the joints, the joint update and the part integration.

:class:`ArmMegaPhysics` extends the free-part tables of a
:class:`MegaPhysics` (kept as ``free``: the free-part kernel's wrapper for
the same model, which the env's reset settles parts with) by the robot
lanes and the robot's constant tables, and wraps the launch:

* ``control_step(parts, group, gscale, qpos, qvel, ctrl, tau_extra, G1, G2,
  n)`` launches the kernel for CUDA tensors and runs the plain version for
  CPU tensors. There is no other route: another device, or a kernel that
  fails to build or launch, raises.
* ``plain_control_step`` is the **plain PyTorch version**, kept in this
  module beside the wrapper: the batched form of the JAX package's eager
  path (``ArmEnv._sim_substeps``) on the port's ``robots.kinematics``,
  ``collide.robot_contacts`` and ``engine`` substep. It is what CPU tensors
  run and what the kernel is held against; nothing on the card's main path
  calls it.
* ``launches`` counts kernel launches, and nothing else;
  ``scratch_launches`` counts those of them that took the global-scratch
  route (``lane_buffer``: the lane working set over ``smem_limit``).

Where the JAX package's eager path and its Pallas kernel differ, both
versions here follow the eager path: the optional held-velocity clamp acts
after the substep has integrated positions, and the robot surface velocity
is the geom's velocity plus ω × r (the kernel sums the joints at the geom
center, the plain version goes through the body Jacobians at the COM: equal
up to rounding).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from ..robots import kinematics as K
from ..robots.chain import HINGE
from .collide import robot_contacts, robot_torch_tables
from .megakernel import (
    APPLY_ENTRY,
    APPLY_PART,
    CROSS,
    INTEGRATE,
    INV3,
    MAT3,
    KIND_ROBOT1,
    KIND_ROBOT2,
    LANE_CONST_COLS,
    MAX_SMEM,
    PREP_LANE,
    QMAT,
    QMUL,
    QROT,
    SAT,
    SLOT_TABLES,
    UPDATE_LANE,
    MegaPhysics,
    check_inputs,
    lane_lists,
    slot_tables,
)
from .state import PartState

SOURCE = Path(__file__).resolve().parent / "csrc" / "arm_megakernel.cu"
THREADS = 512
SEGMENT = 32   # csrc/arm_megakernel.cu SEGW: a whole warp shares a part

# order of the pointer, int and float arrays handed to arm_control_step
# (the PtrIndex, IntIndex and FloatIndex enums of the .cu file)
PTR_NAMES = (
    "pos", "quat", "lin_vel", "ang_vel", "group", "gscale", "qpos", "qvel", "ctrl",
    "tau_extra", "G1", "G2",
    "pos_out", "quat_out", "lin_out", "ang_out", "qpos_out", "qvel_out", "touch_out",
    "part_const", *SLOT_TABLES,
    "body_f", "body_i", "jnt_f", "jnt_i", "rg_f", "rg_i", "rg_anc", "act_f", "act_i",
    "grip_i", "grip_f", "rg_off", "rg_ent_slot",
    "scratch", "clocks",
)
INT_NAMES = (
    "B", "P", "KS", "LPT", "NBS", "Kf", "Ke", "n", "iters", "NB", "NJ", "NA", "NRG",
    "NARM", "NGRIP", "couple", "threads", "smem",
)
FLOAT_NAMES = (
    "dt", "dtg", "slop", "relax", "maxv", "squeeze", "half_squeeze", "press_vel",
    "pc_cap", "held_vel", "held_angvel",
)
ROBOT_TABLES = PTR_NAMES[PTR_NAMES.index("body_f") : PTR_NAMES.index("scratch")]

_libs = {}


def library(defines=()) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; with
    ``_cuda.PHASE_CLOCKS`` the phase-clock build of the same source."""
    if defines not in _libs:
        lib = _cuda.load(SOURCE, defines)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.arm_control_step.argtypes = [vp, vp, vp, vp]
        lib.arm_control_step.restype = i
        lib.arm_error_string.argtypes = [i]
        lib.arm_error_string.restype = ctypes.c_char_p
        for fn in ("arm_lane_floats", "arm_lane_const_cols",
                   "arm_segment_width", "arm_sum_columns",
                   "arm_num_ptrs", "arm_num_ints", "arm_num_floats", "arm_num_phases"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.arm_fixed_words.argtypes = [i] * 11
        lib.arm_fixed_words.restype = i
        lib.arm_resident_blocks.argtypes = [i] * 3
        lib.arm_resident_blocks.restype = i
        lib.arm_barrier_probe.argtypes = [i, i, i, i, vp]
        lib.arm_barrier_probe.restype = i
        counts = (lib.arm_num_ptrs(), lib.arm_num_ints(), lib.arm_num_floats())
        if counts != (len(PTR_NAMES), len(INT_NAMES), len(FLOAT_NAMES)):
            raise RuntimeError(f"arm_megakernel.cu argument layout changed: {counts}")
        if (lib.arm_lane_const_cols(), lib.arm_segment_width()) != (LANE_CONST_COLS, SEGMENT):
            raise RuntimeError("arm_megakernel.cu slot layout changed")
        _libs[defines] = lib
    return _libs[defines]


def _rot(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


class ArmMegaPhysics:
    """Constant tables, wrapper and plain version of the arm kernel for one
    (robot, furniture) pair. ``tables`` are the physics tables with the
    robot contact tables (``engine.robot_contact_tables``) merged in."""

    LANE_GEOM_COLS = MegaPhysics.LANE_GEOM_COLS

    def __init__(self, tables, robot, cfg_sim, device):
        # the free-part tables (and attach_betas, which sees the robot pairs)
        self.free = free = MegaPhysics(tables, cfg_sim, device)
        self.cfg = cfg_sim
        self.device = free.device
        self.launches = 0
        self.scratch_launches = 0
        self.robot = robot
        self.smem_limit = MAX_SMEM
        self.P, self.Kf, self.Kp, self.Ke = free.P, free.Kf, free.Kp, free.Ke
        self._plain = free._plain
        P = self.P
        gp = np.asarray(tables["geom_part"])
        sizes = np.asarray(tables["_box_sizes"], np.float32)
        gpos = np.asarray(tables["geom_pos"], np.float32)
        gquat = np.asarray(tables["geom_quat"], np.float32)
        fric = np.asarray(tables["geom_friction"], np.float32)
        self.NJ, self.NA, self.NB = robot.nj, robot.na, robot.nb
        self.n_arms = len(robot.arms)

        # ---- robot lanes: side 1 (part samples in robot boxes) then side 2
        # (robot samples in part boxes), collide.robot_contacts order ----
        rpairs = np.asarray(tables["_robot_pairs"]).reshape(-1, 2)
        if not len(rpairs):
            raise ValueError("the arm kernel needs robot contact pairs")
        lane_rg1 = np.asarray(tables["_rl_rgeom"])
        lane_pg1 = np.asarray(tables["_rl_pgeom"])
        rl_sign = np.asarray(tables["_rl_sign"], np.float32)
        rl_pair = np.asarray(tables["_rl_pair"])
        L = len(lane_rg1)
        r_sizes = np.asarray(tables["robot_np"]["_box_sizes"], np.float32)
        r_fric = np.asarray(tables["robot_np"]["geom_friction"], np.float32)
        self.L = L
        self.Kr = 2 * L
        self.Kb = free.K                       # floor + pair + SAT lanes
        self.K = self.Kb + self.Kr

        # unique hand geoms, in hand order (rpairs is robot-geom-major)
        self.hand_list = list(dict.fromkeys(rpairs[:, 0].tolist()))
        self.NRG = len(self.hand_list)
        slot_of = {g: i for i, g in enumerate(self.hand_list)}
        slot1 = np.array([slot_of[g] for g in lane_rg1])
        self.lane_slot = np.concatenate([slot1, slot1])

        # side 1: part-geom sample points in the part frame; robot box size
        self.r1_corner = np.stack(
            [gpos[g] + _rot(gquat[g]) @ (rl_sign[i] * sizes[g]) for i, g in enumerate(lane_pg1)]
        ).astype(np.float32)
        self.r1_rsize = r_sizes[lane_rg1]
        # side 2: robot-geom sample points in the robot-geom frame; part box
        self.r2_off = r_sizes[lane_rg1] * rl_sign
        self.r2_dst_pos = gpos[lane_pg1]
        self.r2_dst_quat = gquat[lane_pg1]
        self.r2_dst_size = sizes[lane_pg1]

        lane_rg = np.concatenate([lane_rg1, lane_rg1])
        lane_part_r = gp[np.concatenate([lane_pg1, lane_pg1])]
        rfr = np.maximum(fric[lane_pg1], r_fric[lane_rg1])
        r_beta = np.asarray(tables["_robot_beta"], np.float32)[rl_pair]
        self.lane_fric = np.concatenate([free.lane_fric, rfr, rfr]).astype(np.float32)
        self.lane_beta = np.concatenate([free.lane_beta, r_beta, r_beta]).astype(np.float32)
        self.part_a = np.concatenate([free.part_a, lane_part_r]).astype(int)
        self.part_b = np.concatenate([free.part_b, np.full(self.Kr, -1)]).astype(int)

        # finger code per robot lane: arm * 2 + side (0: left finger, 1:
        # right), -1 for the other hand geoms
        finger_of_geom = {}
        for a, arm in enumerate(robot.arms):
            for s, fg in enumerate((robot.finger_geoms_l[arm], robot.finger_geoms_r[arm])):
                for g in np.asarray(fg).tolist():
                    finger_of_geom[g] = a * 2 + s
        self.lane_finger = np.array([finger_of_geom.get(int(g), -1) for g in lane_rg], np.int32)
        self.NT = 2 * self.n_arms * P

        lc = np.zeros((self.K, self.LANE_GEOM_COLS), np.float32)
        lc[: self.Kb] = free.lane_const
        lc[self.Kb : self.Kb + L, 0:3] = self.r1_corner
        lc[self.Kb : self.Kb + L, 3:6] = self.r1_rsize
        lc[self.Kb + L :, 0:3] = self.r2_off
        lc[self.Kb + L :, 3:6] = self.r2_dst_pos
        lc[self.Kb + L :, 6:10] = self.r2_dst_quat
        lc[self.Kb + L :, 10:13] = self.r2_dst_size
        lc[:, 20] = self.lane_fric
        lc[:, 21] = self.lane_beta
        self.lane_const = lc
        self.part_const = free.part_const
        self.part_ent, self.part_off, self.part_nfloor = lane_lists(
            self.part_a, self.part_b, self.Kf, P
        )

        # ---- the robot's constant tables ----
        f32, i32 = np.float32, np.int32
        bj = np.asarray(robot.body_joint)
        j_safe = np.maximum(bj, 0)
        axis32 = np.asarray(robot.jnt_axis, f32)
        # the plain version normalises the f32 axis (transforms.unit)
        axis32 = axis32 / np.maximum(np.linalg.norm(axis32, axis=-1, keepdims=True), 1e-12)
        self.body_f = np.concatenate(
            [
                np.asarray(robot.body_pos, f32), np.asarray(robot.body_quat, f32),
                axis32[j_safe] if robot.nj else np.zeros((robot.nb, 3), f32),
                np.asarray(robot.jnt_pos, f32)[j_safe] if robot.nj else np.zeros((robot.nb, 3), f32),
            ],
            axis=1,
        ).astype(f32)
        self.body_i = np.stack(
            [np.asarray(robot.parent), bj, np.where(bj >= 0, np.asarray(robot.jnt_type)[j_safe], -1)],
            axis=1,
        ).astype(i32)
        self.jnt_f = np.concatenate(
            [
                np.asarray(robot.jnt_axis, f32), np.asarray(robot.jnt_pos, f32),
                np.asarray(robot.jnt_frictionloss, f32)[:, None],
                np.minimum(np.asarray(robot.jnt_maxvel), 1e9).astype(f32)[:, None],
                np.maximum(np.asarray(robot.jnt_range[:, 0]), -1e9).astype(f32)[:, None],
                np.minimum(np.asarray(robot.jnt_range[:, 1]), 1e9).astype(f32)[:, None],
            ],
            axis=1,
        ).astype(f32)
        self.jnt_i = np.stack([robot.jnt_body, robot.jnt_type], axis=1).astype(i32)
        hl = np.asarray(self.hand_list)
        self.rg_f = np.concatenate(
            [np.asarray(robot.geom_pos, f32)[hl], np.asarray(robot.geom_quat, f32)[hl]], axis=1
        ).astype(f32)
        self.rg_i = np.stack(
            [robot.geom_body[hl], [finger_of_geom.get(int(g), -2) // 2 for g in hl]], axis=1
        ).astype(i32)
        self.rg_anc = robot.ancestor[robot.geom_body[hl]].astype(f32)      # [NRG,NJ]
        self.act_f = np.concatenate(
            [np.asarray(robot.act_gain, f32)[:, None], np.asarray(robot.act_ctrlrange, f32),
             np.asarray(robot.act_forcerange, f32)],
            axis=1,
        ).astype(f32)
        self.act_i = np.stack([robot.act_joint, robot.act_kind], axis=1).astype(i32)
        grip = [
            (a, int(r), int(robot.act_joint[r]), float(robot.act_close_sign[r]))
            for a, arm in enumerate(robot.arms)
            for r in robot.gripper_actuators[arm]
        ]
        self.grip_i = np.array([g[:3] for g in grip], i32).reshape(-1, 3)
        self.grip_f = np.array([g[3] for g in grip], f32)
        order = np.argsort(self.lane_slot, kind="stable")
        self.rg_ent = (self.Kb + order).astype(i32)
        self.rg_off = np.concatenate(
            [[0], np.cumsum(np.bincount(self.lane_slot, minlength=self.NRG))]
        ).astype(i32)
        # the same tables in slot order, for the kernel: a robot lane's slot
        # carries its hand-geom slot and its finger code
        self.lane_kind = np.concatenate(
            [free.lane_kind, np.full(L, KIND_ROBOT1), np.full(L, KIND_ROBOT2)]
        )
        self.slots = slot_tables(
            self.part_a, self.part_b, self.lane_kind, lc,
            np.concatenate([np.zeros(free.Kf + free.Kp, int), np.arange(free.Ke), self.lane_slot]),
            np.concatenate([np.zeros(self.Kb, int), self.lane_finger]),
            free.Kf, free.Ke, P, THREADS, SEGMENT,
        )
        self.rg_ent_slot = self.slots["slot_of_lane"][self.rg_ent].astype(i32)
        self._dev = {
            name: torch.as_tensor(getattr(self, name), device=self.device)
            for name in ("part_const",) + ROBOT_TABLES
        }
        self._dev.update(
            (name, torch.as_tensor(self.slots[name], device=self.device).contiguous())
            for name in SLOT_TABLES
        )

        # ---- the plain version's tables ----
        dev = self.device
        self._rt = robot_torch_tables(tables, dev)
        self._anc_lane = torch.as_tensor(self.rg_anc[self.lane_slot], device=dev)  # [Kr,NJ]
        arm_of_lane = np.where(self.lane_finger >= 0, self.lane_finger // 2, -1)
        self._sqz = torch.as_tensor(
            np.stack([arm_of_lane == a for a in range(self.n_arms)]), device=dev
        )                                                                  # [n_arms,Kr]
        tm = np.zeros((self.NT, self.Kr), np.float32)
        on = np.flatnonzero(self.lane_finger >= 0)
        tm[self.lane_finger[on] * P + lane_part_r[on], on] = 1.0
        self._touchmap = torch.as_tensor(tm, device=dev)                   # [NT,Kr]
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

    # -- the two versions ----------------------------------------------------

    def plain_control_step(self, parts: PartState, group, gscale, qpos, qvel, ctrl,
                           tau_extra, G1, G2, n: int):
        """The plain PyTorch version: ``n`` coupled substeps on any device."""
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
        touch = (mask.to(torch.float32) @ self._touchmap.T) > 0
        return parts, qpos, qvel, touch.reshape(B, 2 * self.n_arms, self.P)

    def control_step(self, parts: PartState, group, gscale, qpos, qvel, ctrl, tau_extra,
                     G1, G2, n: int):
        """Run ``n`` coupled substeps for a batch: kernel for CUDA tensors,
        plain version for CPU tensors. Inputs ``parts.pos [B,P,3]``…,
        ``group/gscale [B,P]``, ``qpos/qvel [B,NJ]``, ``ctrl [B,NA]``,
        ``tau_extra [B,NJ]``, ``G1/G2 [B,NJ,NJ]``. Returns
        ``(parts', qpos', qvel', touch [B, 2*n_arms, P] bool)``."""
        kind = parts.pos.device.type
        args = (parts, group, gscale, qpos, qvel, ctrl, tau_extra, G1, G2, n)
        if kind == "cuda":
            return self.kernel_control_step(*args)
        if kind == "cpu":
            return self.plain_control_step(*args)
        raise RuntimeError(f"no arm physics for device {parts.pos.device}")

    def lane_buffer(self):
        """(floats per lane, dynamic shared bytes a block, working set in
        shared memory?)."""
        lib = library()
        nf, ncol = lib.arm_lane_floats(), lib.arm_sum_columns()
        fixed = 4 * lib.arm_fixed_words(
            self.P, self.NB, self.NJ, self.NA, self.NRG, self.n_arms, self.Kf, self.Ke,
            self.slots["KS"], int(self.slots["b_off"][-1]), THREADS,
        )
        lane_bytes = 4 * self._scratch_floats(nf, ncol)
        in_smem = fixed + lane_bytes <= self.smem_limit
        return nf, fixed + (lane_bytes if in_smem else 0), in_smem

    # -- what the latency floor is worked out from ------------------------------

    def resident_blocks(self) -> int:
        """Blocks of the kernel an SM holds for this model and robot."""
        _, smem, in_smem = self.lane_buffer()
        n = library().arm_resident_blocks(int(not in_smem), THREADS, smem)
        if n <= 0:
            raise RuntimeError("the occupancy query of arm_megakernel.cu failed")
        return n

    def barrier_probe(self, blocks: int, n: int) -> None:
        """Launch ``blocks`` blocks of the kernel's size and shared memory
        that pass ``n`` bare block barriers: timed, a launch over ``n`` is a
        barrier's round trip at that occupancy. Not counted in ``launches``."""
        smem = self.lane_buffer()[1]
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = library().arm_barrier_probe(int(blocks), THREADS, smem, int(n),
                                              ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError("barrier probe failed: " + library().arm_error_string(err).decode())

    def _scratch_floats(self, nf: int, ncol: int) -> int:
        """Floats of an env's b-side buffer and lane working set."""
        return ncol * int(self.slots["b_off"][-1]) + nf * self.slots["KS"]

    def kernel_control_step(self, parts: PartState, group, gscale, qpos, qvel, ctrl,
                            tau_extra, G1, G2, n: int):
        """One launch of the CUDA kernel; raises on anything it cannot take."""
        out = self._launch((), parts, group, gscale, qpos, qvel, ctrl, tau_extra, G1, G2, n)
        self.launches += 1
        self.scratch_launches += int(not out[5])
        return out[:4]

    def phase_clocks(self, parts: PartState, group, gscale, qpos, qvel, ctrl, tau_extra,
                     G1, G2, n: int):
        """Clock cycles per phase of the substep loop, ``[B, phases]`` int64,
        the last column the block barriers the loop passed: one launch of
        the phase-clock build of the kernel (the same source with
        ``-DFT_PHASE_CLOCKS``). A measuring aid: its results are not used
        and it is not counted in ``launches``."""
        return self._launch(_cuda.PHASE_CLOCKS, parts, group, gscale, qpos, qvel, ctrl,
                            tau_extra, G1, G2, n)[4]

    def _launch(self, defines, parts: PartState, group, gscale, qpos, qvel, ctrl,
                tau_extra, G1, G2, n: int):
        """Check the inputs, then launch the build of the kernel with
        ``defines``: ``(parts, qpos, qvel, touch, phase clocks or None,
        working set in shared memory?)``."""
        B, P = parts.pos.shape[:2]
        NJ, NA = self.NJ, self.NA
        dev = parts.pos.device
        f32 = torch.float32
        inputs = {
            "pos": (parts.pos, (B, P, 3), f32),
            "quat": (parts.quat, (B, P, 4), f32),
            "lin_vel": (parts.lin_vel, (B, P, 3), f32),
            "ang_vel": (parts.ang_vel, (B, P, 3), f32),
            "group": (group, (B, P), torch.int32),
            "gscale": (gscale, (B, P), f32),
            "qpos": (qpos, (B, NJ), f32),
            "qvel": (qvel, (B, NJ), f32),
            "ctrl": (ctrl, (B, NA), f32),
            "tau_extra": (tau_extra, (B, NJ), f32),
            "G1": (G1, (B, NJ, NJ), f32),
            "G2": (G2, (B, NJ, NJ), f32),
        }
        if P != self.P:
            raise ValueError(f"model has {self.P} parts, state has {P}")
        check_inputs(inputs, dev)
        if dev != self.device:
            raise ValueError(f"tables live on {self.device}, state on {dev}")
        lib = library(defines)
        clocks = None
        if defines == _cuda.PHASE_CLOCKS:
            clocks = torch.zeros((B, lib.arm_num_phases()), dtype=torch.int64, device=dev)
        nf, smem, in_smem = self.lane_buffer()
        out = PartState(
            pos=torch.empty_like(parts.pos),
            quat=torch.empty_like(parts.quat),
            lin_vel=torch.empty_like(parts.lin_vel),
            ang_vel=torch.empty_like(parts.ang_vel),
        )
        qpos_out, qvel_out = torch.empty_like(qpos), torch.empty_like(qvel)
        touch = torch.empty((B, self.NT), dtype=torch.uint8, device=dev)
        scratch = None if in_smem else torch.empty(
            (B, self._scratch_floats(nf, lib.arm_sum_columns())), dtype=f32, device=dev
        )
        tensors = {name: t for name, (t, _, _) in inputs.items()}
        tensors.update(
            pos_out=out.pos, quat_out=out.quat, lin_out=out.lin_vel, ang_out=out.ang_vel,
            qpos_out=qpos_out, qvel_out=qvel_out, touch_out=touch, scratch=scratch,
            clocks=clocks, **self._dev,
        )
        cfg = self.cfg
        ints = dict(
            B=B, P=P, KS=self.slots["KS"], LPT=self.slots["lpt"],
            NBS=int(self.slots["b_off"][-1]), Kf=self.Kf, Ke=self.Ke, n=int(n),
            iters=int(cfg.solver_iters), NB=self.NB, NJ=NJ, NA=NA, NRG=self.NRG,
            NARM=self.n_arms, NGRIP=len(self.grip_f), couple=int(bool(cfg.robot_coupling)),
            threads=THREADS, smem=smem,
        )
        floats = dict(
            dt=cfg.timestep, dtg=cfg.timestep * cfg.gravity, slop=cfg.contact_slop,
            relax=cfg.relaxation, maxv=cfg.max_velocity, squeeze=cfg.gripper_squeeze,
            half_squeeze=0.5 * cfg.gripper_squeeze, press_vel=cfg.grip_press_vel,
            pc_cap=cfg.robot_coupling_clamp * cfg.timestep, held_vel=cfg.held_vel_clamp,
            held_angvel=cfg.held_angvel_clamp,
        )
        ptrs = (ctypes.c_void_p * len(PTR_NAMES))(
            *(tensors[k].data_ptr() if tensors[k] is not None else None for k in PTR_NAMES)
        )
        c_ints = (ctypes.c_int * len(INT_NAMES))(*(ints[k] for k in INT_NAMES))
        c_floats = (ctypes.c_float * len(FLOAT_NAMES))(*(floats[k] for k in FLOAT_NAMES))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.arm_control_step(
                ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(c_ints, ctypes.c_void_p),
                ctypes.cast(c_floats, ctypes.c_void_p), ctypes.c_void_p(stream),
            )
        if err != 0:
            raise RuntimeError(
                "arm megakernel launch failed: " + lib.arm_error_string(err).decode()
            )
        return (out, qpos_out, qvel_out, touch.reshape(B, 2 * self.n_arms, P) != 0, clocks,
                in_smem)

    # -- work model (for the roofline bound) -----------------------------------

    def fp32_ops_per_env(self, n: int) -> int:
        """FP32 operations of the *function* for one env in a launch of ``n``
        substeps, as the plain version does it: per solver pass one impulse
        application per (lane, side) entry of the per-part lists and one
        lambda update per lane, and the robot's phases once a substep (each
        add, multiply, min/max, compare, divide, square root, sin, cos and
        tanh counts one; index arithmetic does not). This is the yardstick
        of the roofline bound and does not follow the kernel's layout (see
        ``MegaPhysics.fp32_ops_per_env``). The count does not depend on the
        data: every lane runs every phase whatever its mask."""
        P, Kf, Kp, Ke, Kr, K = self.P, self.Kf, self.Kp, self.Ke, self.Kr, self.K
        NJ, NA, NB, NRG = self.NJ, self.NA, self.NB, self.NRG
        E = len(self.part_ent)
        Eb = E - K
        Kpe = Kp + Ke
        iters = self.cfg.solver_iters
        n_hinge = int(np.sum(np.asarray(self.robot.jnt_type) == HINGE))
        anc = int(self.rg_anc.sum())                       # (geom, joint) pairs
        box = 3 + 4 + 5 + QROT + 3 + 3 + 3 + 1 + QROT      # point_in_box
        fk = NB * (QROT + 3 + QMUL) + n_hinge * (3 + 2 + QMUL + 2 * QROT + 6) \
            + (NJ - n_hinge) * (QROT + 6)                  # A. the chain
        frames = NJ * (2 * QROT + 3) + NRG * (QROT + 3 + QMUL)          # B.
        parts = P * (QROT + 3 + QMAT + 2 * MAT3)
        aggr = P * (P * 51 + 3 + INV3 + 3)
        geom_vel = anc * (3 + CROSS + 12)                               # C.
        narrow = (                                                      # D.
            Kf * (QROT + 4)
            + Kp * (2 * QROT + QMUL + 3 + box + 2)
            + Ke * (2 * QMUL + 2 * QROT + 6 + SAT)
            + self.L * (QROT + 3 + box + 1)
            + self.L * (2 * QROT + QMUL + 6 + box + 4)
            + Kr * (3 + CROSS + 3)
        )
        prep = K * PREP_LANE
        gates = Ke * 16 + Kr * 2 + NRG * 5 + E + P * 5                  # E., F.
        warm = K * 12 + Kr * 7 + NA * 6 + NJ                            # G.
        apply = E * APPLY_ENTRY + Eb * 3 + P * APPLY_PART
        update = K * UPDATE_LANE + Kpe * 15 + Kr * 3                    # H.
        final = apply + P * INTEGRATE
        floor = Kf * (QROT + 5) + P * P
        geom_ft = Kr * (18 + 3 + CROSS + 6) + NRG * 6 * 5               # I.
        joints = anc * (3 + CROSS + 9) + NJ * (2 + 6) + NJ * (4 * NJ + 8)   # J., K.
        per_substep = (
            fk + frames + parts + aggr + geom_vel + narrow + prep + gates + warm
            + iters * (apply + update) + final + floor + geom_ft + joints
        )
        return int(n * per_substep)
