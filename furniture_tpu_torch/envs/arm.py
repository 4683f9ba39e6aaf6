"""Batched articulated-arm environments (Sawyer / Panda / Jaco / Fetch /
Baxter).

The port's counterpart of ``furniture_tpu.envs.arm``, written for a batch of
envs at once (every state field leads with the env dimension B). Semantics:

* control types
  - ``ik`` / ``ik_quaternion``: eef-delta actions → a persistent world-frame
    IK target, 20-iteration DLS IK, joint P-control velocities clipped to
    ±1 on velocity actuators, ``action_repeat`` control steps per action
    with the velocities recomputed each time;
  - ``impedance``: normalized joint-velocity targets rescaled to the
    actuator ctrlranges (velocity servos);
  - ``torque``: direct motor torques on the torque variant of the robot;
  - the five torque-space controllers (``position_orientation``,
    ``position``, ``joint_impedance``, ``joint_velocity``,
    ``joint_torque``) are not ported yet: the env raises
    ``NotImplementedError`` for them, as for the initial-state pool;
* the robot is gravity/bias-compensated every control step, so arm dynamics
  reduce to M(q)q̈ = τ_act − D q̇ (integrated implicitly);
* two-finger grasping is real contact physics: gripper geoms are kinematic
  colliders with prescribed surface velocities in the part contact solver,
  and the contact impulses load the joints (``physics/arm_megakernel.py``);
* connect requires both fingers of an arm touching a part, then runs the
  shared connect machinery on that part's group against all others, snapping
  on a single aligned connect press;
* sparse reward: touch and pick (once per part) + success × newly connected
  + ctrl penalty, minus the instability penalty;
* observations: ik → [gripper_qpos, eef_pos, eef_quat(xyzw), eef_velp,
  eef_velr] per arm; impedance/torque prepend [joint_pos, joint_vel].

Every control step is one launch of the arm kernel through
``ArmMegaPhysics.control_step`` (``action_repeat`` launches for ik); the
reset's ten settle rounds go through the free-part kernel. Where the JAX
package branches per env with ``lax.cond``, this module computes both sides
and selects on the batch; the step path has no host synchronisation.

Entry points run on CUDA by default (``device=None``); only an explicit
``device="cpu"`` runs on the CPU, where the physics is the kernels' plain
PyTorch version.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T
from ..config import EnvConfig
from ..controllers import dls_ik, ik_velocities
from ..models import CompiledModel, compile_from_config
from ..physics.arm_megakernel import ArmMegaPhysics
from ..physics.collide import floor_contacts
from ..physics.engine import physics_tables, robot_contact_tables
from ..physics.state import PartState, init_state, zero_vel
from ..robots import AGENT_SPECS, compile_robot
from ..robots import kinematics as K
from .assembly import (
    AssemblyOps,
    apply_reset_variants,
    instability_guard,
    rows,
    sample_placement,
    settle_parts,
    tree_where,
)
from .cursor import _squeeze, _unsqueeze, resolve_device

NEW_CONTROLLERS = (
    "position_orientation",
    "position",
    "joint_impedance",
    "joint_velocity",
    "joint_torque",
)

# gripper scalar → joint-control sign map (Jaco replicates the scalar over
# its 3 finger joints)
_GRIPPER_SIGNS = {
    "two_finger_gripper": [1.0, -1.0],
    "left_two_finger_gripper": [1.0, -1.0],
    "panda_gripper": [-1.0, 1.0],
    "fetch_gripper": [1.0, 1.0],
    "jaco_gripper": [1.0, 1.0, 1.0],
}

# gripper workspace box
_MIN_GRIPPER_POS = np.array([-1.5, -1.5, 0.0], np.float32)
_MAX_GRIPPER_POS = np.array([1.5, 1.5, 1.5], np.float32)


class ArmState(NamedTuple):
    """Complete state of a batch of arm envs (every field leads with B)."""

    # assembly fields (shared with AssemblyOps)
    parts: PartState
    group: torch.Tensor                 # [B,P] int32
    conn_connected: torch.Tensor        # [B,C] bool
    weld_active: torch.Tensor           # [B,W] bool
    num_connected: torch.Tensor         # [B] int32
    subtask: torch.Tensor               # [B,2] int32
    connect_step: torch.Tensor          # [B] int32
    connected_body1: torch.Tensor       # [B] int32
    connected_body1_pos: torch.Tensor   # [B,3]
    connected_body1_quat: torch.Tensor  # [B,4]
    # robot
    qpos: torch.Tensor                  # [B,NJ]
    qvel: torch.Tensor                  # [B,NJ]
    ik_target_pos: torch.Tensor         # [B,n_arms,3] persistent IK target (world)
    hand_quat_init: torch.Tensor        # [B,n_arms,4] accumulated target hand quat
    # reward bookkeeping
    touched: torch.Tensor               # [B,P] bool
    picked: torch.Tensor                # [B,P] bool
    touch_l: torch.Tensor               # [B,n_arms,P] finger touches after last substep
    touch_r: torch.Tensor               # [B,n_arms,P]
    t: torch.Tensor                     # [B] int32


class ArmEnv:
    """Batched reset/step of one (agent, furniture, control_type) combination
    on one device. ``reset_batch``/``step_batch`` are the entry points;
    ``reset``/``step`` are their B=1 views without the batch dimension."""

    def __init__(
        self,
        config: EnvConfig | None = None,
        model: CompiledModel | None = None,
        device=None,
    ):
        self.config = config or EnvConfig(agent_type="Sawyer")
        cfg = self.config
        self.device = resolve_device(device)
        if cfg.agent_type not in AGENT_SPECS:
            raise ValueError(f"unknown arm agent {cfg.agent_type!r}")
        self.control_type = cfg.control_type
        if self.control_type in NEW_CONTROLLERS:
            raise NotImplementedError(
                f"control_type {self.control_type!r}: the torque-space controllers "
                "(controllers/osc.py, ArmEnv._controller_prepare) are not ported yet"
            )
        if self.control_type not in ("ik", "ik_quaternion", "impedance", "torque"):
            raise ValueError(f"unknown control_type {self.control_type!r}")
        if cfg.load_init_states:
            raise NotImplementedError("the initial-state pool is not ported yet")
        self.robot = compile_robot(cfg.agent_type, use_torque=self.control_type == "torque")
        self.model = model or compile_from_config(cfg)
        self.tables = physics_tables(self.model)
        self.tables.update(
            robot_contact_tables(self.tables, self.robot, lane_budget=cfg.sim.arm_lane_budget)
        )
        self.ops = AssemblyOps(self.model, cfg, self.device)
        # the arm kernel's wrapper (kernel on CUDA, plain on CPU); its
        # ``free`` is the free-part kernel's wrapper for the settle rounds
        self.physics = ArmMegaPhysics(self.tables, self.robot, cfg.sim, self.device)

        m, r = self.model, self.robot
        self._P = m.n_parts
        self._C = m.n_conn
        self._W = m.n_welds
        nc = cfg.num_connects
        if nc is not None:
            self.success_num_connects = int(nc) + len(cfg.preassembled)
        else:
            self.success_num_connects = int(m.num_connects)
        self.arms = r.arms
        self.n_arms = len(r.arms)

        # action layout
        spec = AGENT_SPECS[cfg.agent_type]
        direct = self.control_type in ("impedance", "torque")
        self.gripper_action_dims = {
            arm: (
                len(_GRIPPER_SIGNS[spec["grippers"][arm][0]])
                if direct and cfg.agent_type == "Jaco"
                else 1
            )
            for arm in r.arms
        }
        if self.control_type == "ik":
            self.dof = 6 * self.n_arms + self.n_arms + 1
        elif self.control_type == "ik_quaternion":
            self.dof = 7 * self.n_arms + self.n_arms + 1
        else:
            self.dof = r.dof + sum(self.gripper_action_dims.values()) + 1

        # constants of the step, made once on the device
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self._arm_rows = {arm: i64(r.arm_actuators[arm]) for arm in r.arms}
        self._grip_rows = {arm: i64(r.gripper_actuators[arm]) for arm in r.arms}
        self._grip_signs = {
            arm: f32(_GRIPPER_SIGNS[spec["grippers"][arm][0]])[: len(r.gripper_actuators[arm])]
            for arm in r.arms
        }
        self._arm_joints = {arm: i64(r.arm_joints[arm]) for arm in r.arms}
        self._grip_joints = {arm: i64(r.gripper_joints[arm]) for arm in r.arms}
        self._ctrl_lo = f32(r.act_ctrlrange[:, 0])
        self._ctrl_hi = f32(r.act_ctrlrange[:, 1])
        self._min_gripper_pos = f32(_MIN_GRIPPER_POS)
        self._max_gripper_pos = f32(_MAX_GRIPPER_POS)
        self._init_qpos = f32(r.init_qpos)
        self._identity_quat = f32([1.0, 0.0, 0.0, 0.0])
        self._conn_part = i64(m.conn_part)
        self._tt = self.physics._plain.tables

    # -- low-level control ---------------------------------------------------

    def _format_ctrl(self, arm_ctrl: dict, gripper_scalars: dict):
        """The [B,NA] actuator control from per-arm controls (in actuator
        order) and per-arm gripper scalars [B], rescaling normalized inputs
        to the actuator ctrlranges."""
        B = next(iter(gripper_scalars.values())).shape[0]
        ctrl = torch.zeros((B, self.robot.na), dtype=torch.float32, device=self.device)
        for arm in self.arms:
            ctrl[:, self._arm_rows[arm]] = arm_ctrl[arm]
            ctrl[:, self._grip_rows[arm]] = gripper_scalars[arm][:, None] * self._grip_signs[arm]
        c = torch.clamp(ctrl, -1.0, 1.0)
        lo, hi = self._ctrl_lo, self._ctrl_hi
        return 0.5 * (hi + lo) + 0.5 * (hi - lo) * c

    def _substeps(self, states: ArmState, ctrl, tau_extra, n: int) -> ArmState:
        """One control step of ``n`` coupled substeps for the whole batch
        through the arm kernel's wrapper; the joint matrices G1, G2 are
        computed once per control step."""
        cfg = self.config.sim
        B = ctrl.shape[0]
        G1, G2 = K.joint_dyn_matrices(self.robot, states.qpos, cfg.timestep)
        if tau_extra is None:
            tau_extra = torch.zeros((B, self.robot.nj), dtype=torch.float32, device=self.device)
        gscale = torch.ones((B, self._P), dtype=torch.float32, device=self.device)
        parts = PartState(*(t.contiguous() for t in states.parts))
        parts, qp, qv, touch = self.physics.control_step(
            parts,
            states.group.contiguous(),
            gscale,
            states.qpos.contiguous(),
            states.qvel.contiguous(),
            ctrl.contiguous(),
            tau_extra.contiguous(),
            G1.contiguous(),
            G2.contiguous(),
            n,
        )
        touch = touch.reshape(B, self.n_arms, 2, self._P)
        return states._replace(
            parts=parts, qpos=qp, qvel=qv, touch_l=touch[:, :, 0], touch_r=touch[:, :, 1]
        )

    # -- control-type dispatch -------------------------------------------------

    def _ik_prepare(self, state: ArmState, action):
        """IK-target update + DLS IK solve (once per control step); returns
        ``(state', q_cmd [B,NJ], grip [B,n_arms])``."""
        cfg = self.config
        r = self.robot
        # per-arm action width: ik = [dpos3, deuler3]; ik_quaternion =
        # [dpos3, dquat4] (wxyz delta right-multiplied onto the hand quat)
        aw = 7 if self.control_type == "ik_quaternion" else 6
        new_tpos, new_hqi = [], []
        q_cmd = state.qpos
        fk_out = K.fk(r, state.qpos)
        for i, arm in enumerate(self.arms):
            a = action[:, aw * i : aw * i + aw]
            move = a[:, :3] * cfg.move_speed
            hand_pos, hand_quat = K.eef_pose(r, fk_out, arm)
            dpos = torch.minimum(
                torch.maximum(move, self._min_gripper_pos - hand_pos),
                self._max_gripper_pos - hand_pos,
            )
            if self.control_type == "ik_quaternion":
                dq_in = T.quat_normalize(a[:, 3:7])
                # keep w >= 0 (shortest arc)
                dq_in = torch.where(dq_in[:, 0:1] < 0, -dq_in, dq_in)
                hqi = T.quat_normalize(T.quat_mul(hand_quat, dq_in))
            else:
                # hand-frame euler deltas, right-multiplied onto the
                # accumulated target, with the 0.3 sensitivity low-pass
                hqi = T.quat_mul(
                    state.hand_quat_init[:, i],
                    T.euler_to_quat(0.3 * a[:, 3:6] * cfg.rotate_speed),
                )
                hqi = T.quat_normalize(hqi)
            # anti-windup: the orientation target stays within 45° of the hand
            dq = T.quat_mul(hqi, T.quat_inv(hand_quat))
            dq = torch.where(dq[:, 0:1] < 0, -dq, dq)
            ang = 2.0 * torch.arccos(torch.clamp(dq[:, 0], -1.0, 1.0))
            frac = torch.clamp((math.pi / 4) / torch.clamp(ang, min=1e-6), max=1.0)
            hqi = T.quat_slerp(hand_quat, hqi, frac)
            # the target moves by 0.3 × dpos and stays within 15 cm of the hand
            tpos = state.ik_target_pos[:, i] + 0.3 * dpos
            err = tpos - hand_pos
            err_n = torch.linalg.norm(err, dim=-1, keepdim=True)
            tpos = hand_pos + err * torch.clamp(0.15 / torch.clamp(err_n, min=1e-6), max=1.0)
            q_cmd = dls_ik(r, arm, q_cmd, tpos, hqi)
            new_tpos.append(tpos)
            new_hqi.append(hqi)
        state = state._replace(
            ik_target_pos=torch.stack(new_tpos, 1), hand_quat_init=torch.stack(new_hqi, 1)
        )
        # gripper scalars follow the per-arm blocks
        grip = action[:, aw * self.n_arms : aw * self.n_arms + self.n_arms]
        return state, q_cmd, grip

    def _ik_ctrl(self, qpos, q_cmd, grip):
        """Actuator controls for one IK action repeat: P-control joint
        velocities toward the commanded positions at the current qpos."""
        arm_ctrl = {
            arm: ik_velocities(qpos, q_cmd, self._arm_joints[arm]) for arm in self.arms
        }
        return self._format_ctrl(
            arm_ctrl, {arm: grip[:, i] for i, arm in enumerate(self.arms)}
        )

    def _direct_ctrl(self, action):
        """``impedance``/``torque`` actuator controls from a normalized
        action [B, dof-1]."""
        r = self.robot
        arm_ctrl, grip = {}, {}
        k = 0
        for arm in self.arms:
            na = len(r.arm_actuators[arm])
            arm_ctrl[arm] = action[:, k : k + na]
            k += na
        for arm in self.arms:
            grip[arm] = action[:, k]
            k += self.gripper_action_dims[arm]
        return self._format_ctrl(arm_ctrl, grip)

    def _step_physics_batch(self, states: ArmState, actions) -> ArmState:
        """Control dispatch + physics + connect machinery + post-connect
        snap-back; no reward."""
        cfg = self.config
        if self.control_type in ("ik", "ik_quaternion"):
            states, q_cmd, grip = self._ik_prepare(states, actions)
            for _ in range(cfg.action_repeat):
                ctrl = self._ik_ctrl(states.qpos, q_cmd, grip)
                states = self._substeps(states, ctrl, None, cfg.n_substeps)
        else:  # impedance, torque
            ctrl = self._direct_ctrl(actions[:, :-1])
            states = self._substeps(states, ctrl, None, cfg.n_substeps)
        return self._connect_phase(states, actions[:, -1])

    def _connect_phase(self, state: ArmState, connect) -> ArmState:
        # connect attempt: the first part touched by both fingers of any arm
        both = torch.any(state.touch_l & state.touch_r, dim=1)          # [B,P]
        any_touch = torch.any(both, -1)
        target_part = torch.argmax(both.to(torch.uint8), -1)
        conn_group = state.group[:, self._conn_part]
        g1 = rows(state.group, target_part)
        in1 = conn_group == g1[:, None]
        in2 = torch.ones_like(in1)
        # arm agents snap + weld on a single aligned connect press
        connected = self.ops.try_connect(state, in1, in2, num_connect_steps=0)
        missed = state._replace(connect_step=torch.zeros_like(state.connect_step))
        state = tree_where((connect > 0) & any_touch, connected, missed)

        # post-connect pose snap-back
        snap = state.connected_body1 >= 0
        p1 = torch.clamp(state.connected_body1, min=0)
        move = state.connected_body1_pos - rows(state.parts.pos, p1)
        moved = zero_vel(
            self.ops.move_group(state.parts, state.group, p1, move, state.connected_body1_quat)
        )
        return state._replace(
            parts=tree_where(snap, moved, state.parts),
            connected_body1=torch.where(
                snap, torch.full_like(state.connected_body1, -1), state.connected_body1
            ),
        )

    def _guard(self, state: ArmState):
        """Divergence containment: sanitize the lane and return the
        ``unstable`` flag [B] for the reward/done plumbing. Any non-finite
        float field marks the lane unstable and is replaced by its finite
        projection (NaN in qpos propagates through FK into every derived
        field)."""
        parts, unstable = instability_guard(state.parts)
        rest = state._replace(parts=parts)
        B = unstable.shape[0]
        floats = ("connected_body1_pos", "connected_body1_quat", "qpos", "qvel",
                  "ik_target_pos", "hand_quat_init")
        leaves = list(parts) + [getattr(rest, f) for f in floats]
        for x in leaves:
            unstable = unstable | ~torch.isfinite(x).reshape(B, -1).all(-1)

        def clean(x):
            u = unstable.reshape((B,) + (1,) * (x.dim() - 1))
            return torch.where(u, torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), x)

        rest = rest._replace(
            parts=PartState(*(clean(x) for x in parts)),
            **{f: clean(getattr(rest, f)) for f in floats},
        )
        qvel = torch.where(unstable[:, None], torch.zeros_like(rest.qvel), rest.qvel)
        return rest._replace(qvel=qvel), unstable

    def _finish_step(self, state: ArmState, action, prev_connected):
        """Instability guard + sparse reward + done/obs/info assembly."""
        cfg = self.config
        state, unstable = self._guard(state)

        both = torch.any(state.touch_l & state.touch_r, dim=1)          # [B,P]
        touching_floor = self._parts_on_floor(state.parts)
        newly_touched = both & ~state.touched
        touched = state.touched | both
        newly_picked = both & ~touching_floor & ~state.picked
        picked = state.picked | newly_picked
        state = state._replace(touched=touched, picked=picked, t=state.t + 1)

        newly = (state.num_connected - prev_connected).to(torch.float32)
        touch_reward = cfg.reward.touch_reward * newly_touched.sum(-1).to(torch.float32)
        pick_reward = cfg.reward.pick_reward * newly_picked.sum(-1).to(torch.float32)
        ctrl_penalty = -cfg.reward.ctrl_penalty_coef * torch.sum(action[:, :-1] ** 2, -1)
        success_reward = cfg.reward.success_reward * newly
        unstable_penalty = -cfg.reward.unstable_penalty_coef * unstable.to(torch.float32)
        reward = success_reward + touch_reward + pick_reward + ctrl_penalty + unstable_penalty

        success = state.num_connected >= self.success_num_connects
        done = success | (state.t >= cfg.max_episode_steps) | unstable
        info = {
            "success": success,
            "num_connected": state.num_connected,
            "success_reward": success_reward,
            "touch_reward": touch_reward,
            "pick_reward": pick_reward,
            "ctrl_penalty": ctrl_penalty,
            "unstable": unstable,
        }
        return state, self.observe(state), reward, done, info

    def _parts_on_floor(self, parts: PartState):
        """[B,P]: any geom corner of the part within 2 mm of z = 0."""
        fc = floor_contacts(self._tt, parts.pos, parts.quat, self.config.sim.contact_slop)
        hit = fc.mask & (fc.depth > -0.002)                              # [B,Kf]
        return torch.any(self._tt["floor_assign"][None] & hit[:, None, :], -1)

    # -- reset -------------------------------------------------------------------

    def _hand_targets(self, qpos):
        """The IK target at the hand pose of ``qpos``: ([B,n_arms,3],
        [B,n_arms,4])."""
        fk_out = K.fk(self.robot, qpos)
        poses = [K.eef_pose(self.robot, fk_out, arm) for arm in self.arms]
        return torch.stack([p for p, _ in poses], 1), torch.stack([q for _, q in poses], 1)

    def _initial_state(self, parts: PartState, qpos) -> ArmState:
        """Placement + robot init without the part-settle rounds."""
        B = parts.pos.shape[0]
        dev = self.device
        i32 = lambda v, shape: torch.full(shape, v, dtype=torch.int32, device=dev)
        false = lambda shape: torch.zeros(shape, dtype=torch.bool, device=dev)
        tpos, hqi = self._hand_targets(qpos)
        return ArmState(
            parts=parts,
            group=torch.arange(self._P, dtype=torch.int32, device=dev)[None].repeat(B, 1),
            conn_connected=false((B, self._C)),
            weld_active=false((B, self._W)),
            num_connected=i32(0, (B,)),
            subtask=self.ops.initial_subtask(B),
            connect_step=i32(0, (B,)),
            connected_body1=i32(-1, (B,)),
            connected_body1_pos=torch.zeros((B, 3), device=dev),
            connected_body1_quat=self._identity_quat[None].repeat(B, 1),
            qpos=qpos,
            qvel=torch.zeros_like(qpos),
            ik_target_pos=tpos,
            hand_quat_init=hqi,
            touched=false((B, self._P)),
            picked=false((B, self._P)),
            touch_l=false((B, self.n_arms, self._P)),
            touch_r=false((B, self.n_arms, self._P)),
            t=i32(0, (B,)),
        )

    def _reset_unsettled(self, num_envs: int, generator: torch.Generator) -> ArmState:
        """Sampled placement and robot init pose (with ``agent_xyz_rand``
        joint noise), before the settle rounds. Draws the placement first,
        then the joint noise, from ``generator``."""
        pos, quat = sample_placement(self.model, self.config, num_envs, generator, self.device)
        u = torch.rand((num_envs, self.robot.nj), generator=generator, device=self.device)
        qpos = self._init_qpos + self.config.agent_xyz_rand * (2.0 * u - 1.0)
        return self._initial_state(init_state(pos, quat), qpos)

    def _free_physics(self, parts: PartState, group, gscale, n: int) -> PartState:
        parts = PartState(*(t.contiguous() for t in parts))
        return self.physics.free.substeps(parts, group.contiguous(), gscale.contiguous(), n)

    def _settle(self, state: ArmState) -> ArmState:
        """The ten settle rounds through the free-part kernel, then the
        reset variants."""
        parts = settle_parts(self._free_physics, state.parts, state.group, self.config.sim)
        return apply_reset_variants(self.ops, self.config, state._replace(parts=parts))

    def reset_batch(self, num_envs: int, generator: torch.Generator) -> ArmState:
        """Batched reset: placement and robot init sampled on ``generator``,
        then 10 settle rounds of 10 gravity-compensated substeps, each one
        launch of the free-part kernel."""
        return self._settle(self._reset_unsettled(num_envs, generator))

    def restore_snapshot(self, state: ArmState, snap: dict) -> ArmState:
        """Overwrite the dynamic fields of ``state`` with one recorded demo
        ``states`` entry (arrays without the batch dimension go to every
        env); ``state`` supplies the remaining bookkeeping fields."""
        B = state.group.shape[0]

        def field(name, like):
            x = torch.as_tensor(np.asarray(snap[name]), device=self.device).to(like.dtype)
            return x.expand(like.shape).clone() if x.dim() < like.dim() else x

        parts = PartState(
            pos=field("parts_pos", state.parts.pos),
            quat=field("parts_quat", state.parts.quat),
            lin_vel=field("parts_lin_vel", state.parts.lin_vel),
            ang_vel=field("parts_ang_vel", state.parts.ang_vel),
        )
        qpos = field("qpos", state.qpos)
        # refresh the persistent IK target at the restored hand pose
        tpos, hqi = self._hand_targets(qpos)
        return state._replace(
            parts=parts,
            qpos=qpos,
            qvel=field("qvel", state.qvel),
            ik_target_pos=tpos,
            hand_quat_init=hqi,
            group=field("group", state.group),
            weld_active=field("weld_active", state.weld_active),
            conn_connected=field("conn_connected", state.conn_connected),
            num_connected=field("num_connected", state.num_connected).reshape(B),
        )

    def observe(self, state: ArmState) -> dict:
        """Observation dict (batched): object_ob [B,7P], robot_ob, subtask_ob."""
        cfg = self.config
        r = self.robot
        B = state.group.shape[0]
        obs = {}
        if cfg.object_ob:
            obs["object_ob"] = torch.cat([state.parts.pos, state.parts.quat], -1).reshape(B, -1)
        if cfg.robot_ob:
            fk_out = K.fk(r, state.qpos)
            feats = []
            if self.control_type in ("impedance", "torque"):
                for arm in self.arms:
                    feats.append(state.qpos[:, self._arm_joints[arm]])
                    feats.append(state.qvel[:, self._arm_joints[arm]])
            for arm in self.arms:
                site_pos, _ = K.site_world(r, fk_out, arm)
                _, hand_quat = K.eef_pose(r, fk_out, arm)
                Jsite = K.point_jacobian(r, fk_out, r.eef_body[arm], site_pos)
                vel6 = (Jsite @ state.qvel[..., None])[..., 0]
                feats.extend(
                    [
                        state.qpos[:, self._grip_joints[arm]][:, :2],
                        site_pos,
                        T.convert_quat(hand_quat, to="xyzw"),
                        vel6[:, :3],
                        vel6[:, 3:],
                    ]
                )
            obs["robot_ob"] = torch.cat(feats, -1)
        if cfg.subtask_ob:
            obs["subtask_ob"] = state.subtask + 1
        return obs

    # -- step ------------------------------------------------------------------

    def step_batch(self, states: ArmState, actions):
        """One control step for a batch: ``(state, obs, reward [B], done [B],
        info)``, with the whole substep loop in one kernel launch per
        control step."""
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        prev_connected = states.num_connected
        states = self._step_physics_batch(states, actions)
        return self._finish_step(states, actions, prev_connected)

    # -- single-env views --------------------------------------------------------

    def reset(self, generator: torch.Generator) -> ArmState:
        """Single-env reset: the B=1 batch without its batch dimension."""
        return _squeeze(self.reset_batch(1, generator))

    def step(self, state: ArmState, action):
        """Single-env step without the batch dimension."""
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        s, obs, rew, done, info = self.step_batch(_unsqueeze(state), action[None])
        squeeze = lambda d: {k: v[0] for k, v in d.items()}
        return _squeeze(s), squeeze(obs), rew[0], done[0], squeeze(info)


# -- agent-specific conveniences ------------------------------------------------


def make_arm_env(agent_type: str):
    """Factory-of-factories used by the registry in ``furniture_tpu_torch.api``."""

    def factory(config: EnvConfig, device=None) -> ArmEnv:
        return ArmEnv(config.replace(agent_type=agent_type), device=device)

    return factory


SawyerEnv = make_arm_env("Sawyer")
PandaEnv = make_arm_env("Panda")
JacoEnv = make_arm_env("Jaco")
FetchEnv = make_arm_env("Fetch")
BaxterEnv = make_arm_env("Baxter")
