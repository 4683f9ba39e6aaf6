"""Dense-reward Sawyer assembly environment, batched.

The port's counterpart of ``furniture_tpu.envs.sawyer_dense``: the
reference's 8-phase reward curriculum (``furniture_sawyer_dense.py``) as a
masked, array-indexed state machine over a batch of envs.

Phase curriculum (``furniture_sawyer_dense.py:88-97``):
  0 init_eef → 1 move_eef_above_leg → 2 lower_eef → 3 grasp_leg →
  4 lift_leg → 5 align_leg → 6 move_leg → 7 move_leg_fine

Per-subtask reward variables (leg/table parts, conn sites, grasp-target
sites, lift waypoints; ``_update_reward_variables`` :149-221) are compiled
from the assembly recipe into static per-subtask tables on the device, which
each env's ``subtask_step`` indexes. Every phase reward has the reference's
``diff_rew`` potential-difference form (:579-944) with the coefficients of
``DenseRewardConfig``.

Every env is in its own phase: all eight phase rewards are computed for the
whole batch and each env takes its own with a gather, and the advance to the
next subtask (a ``lax.cond`` in the JAX package) is a per-env select. The
step has no host synchronisation. The physics is ``ArmEnv``'s: the dense
layer is the ``_finish_step`` hook of the inherited ``step_batch``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T
from ..config import EnvConfig
from ..models import CompiledModel
from ..physics.state import PartState
from ..robots import kinematics as K
from .arm import ArmEnv
from .assembly import rows, tree_where

N_PHASES = 8
(
    INIT_EEF,
    MOVE_EEF_ABOVE_LEG,
    LOWER_EEF,
    GRASP_LEG,
    LIFT_LEG,
    ALIGN_LEG,
    MOVE_LEG,
    MOVE_LEG_FINE,
) = range(N_PHASES)

# phases where the grip must point down / align with the grasp vector / be
# open (furniture_sawyer_dense.py:75-87)
_GRIP_UP_PHASES = (INIT_EEF, MOVE_EEF_ABOVE_LEG, LOWER_EEF, GRASP_LEG, LIFT_LEG)
_GRIP_FORWARD_PHASES = (MOVE_EEF_ABOVE_LEG, LOWER_EEF, GRASP_LEG, LIFT_LEG)
_GRIP_OPEN_PHASES = (INIT_EEF, MOVE_EEF_ABOVE_LEG, LOWER_EEF)


class Prev(NamedTuple):
    """Potential-difference trackers (reference ``_prev_*`` scalars), [B]
    each."""

    init_eef_dist: torch.Tensor
    eef_above_leg_dist: torch.Tensor
    eef_leg_dist: torch.Tensor
    grasp_dist: torch.Tensor
    lift_leg_z_dist: torch.Tensor
    lift_leg_xy_dist: torch.Tensor
    move_pos_dist: torch.Tensor
    move_up_ang_dist: torch.Tensor
    move_forward_ang_dist: torch.Tensor
    proj_t: torch.Tensor
    proj_l: torch.Tensor


class DenseState(NamedTuple):
    """ArmState fields + the dense-reward machine state, flat, so that
    ``ArmEnv`` and ``AssemblyOps`` work on it unchanged (every field leads
    with B)."""

    # -- ArmState fields ----------------------------------------------------
    parts: PartState
    group: torch.Tensor
    conn_connected: torch.Tensor
    weld_active: torch.Tensor
    num_connected: torch.Tensor
    subtask: torch.Tensor
    connect_step: torch.Tensor
    connected_body1: torch.Tensor
    connected_body1_pos: torch.Tensor
    connected_body1_quat: torch.Tensor
    qpos: torch.Tensor
    qvel: torch.Tensor
    ik_target_pos: torch.Tensor
    hand_quat_init: torch.Tensor
    touched: torch.Tensor
    picked: torch.Tensor
    touch_l: torch.Tensor
    touch_r: torch.Tensor
    t: torch.Tensor
    # -- dense machine ------------------------------------------------------
    phase_i: torch.Tensor           # [B] int32 0..7
    subtask_step: torch.Tensor      # [B] int32
    leg_dropped: torch.Tensor       # [B] bool
    table_moved: torch.Tensor       # [B] bool
    leg_lift: torch.Tensor          # [B] bool
    leg_fine_aligned: torch.Tensor  # [B] int32
    init_eef_pos: torch.Tensor      # [B,3]
    init_table_site_pos: torch.Tensor  # [B,3]
    init_lift_leg_z: torch.Tensor   # [B]
    lift_leg_pos: torch.Tensor      # [B,3]
    prev: Prev


def _norm(x):
    return torch.linalg.norm(x, dim=-1)


class FurnitureSawyerDenseRewardEnv(ArmEnv):
    """Dense-reward assembly env (reference
    ``FurnitureSawyerDenseRewardEnv``, ``furniture_sawyer_dense.py:12``)."""

    def __init__(
        self,
        config: EnvConfig | None = None,
        model: CompiledModel | None = None,
        device=None,
    ):
        config = (config or EnvConfig()).replace(
            agent_type=(config.agent_type if config and config.agent_type != "Cursor" else "Sawyer"),
            num_connect_steps=0,  # furniture_sawyer_dense.py:74
        )
        super().__init__(config, model, device)
        self._compile_subtask_tables()

    # -- static recipe → per-subtask arrays ----------------------------------

    def _compile_subtask_tables(self):
        m = self.model
        recipe = m.recipe_raw
        if recipe is None:
            raise ValueError(f"{m.name}: the dense env needs a recipe")
        part2id = {n: i for i, n in enumerate(m.part_names)}
        conn2id = {n: i for i, n in enumerate(m.conn_names)}
        site2id = {n: i for i, n in enumerate(m.site_names)}

        S = len(recipe["recipe"])
        legs, tables, lsites, tsites = [], [], [], []
        gls, grs, lift_z, angles = [], [], [], []
        has_ginit, ginit_off, ginit_z = [], [], []
        used = set()
        for s in range(S):
            leg, table = recipe["recipe"][s]
            legs.append(part2id[leg])
            tables.append(part2id[table])
            sr = recipe["site_recipe"][s]
            lsites.append(conn2id[sr[0]])
            tsites.append(conn2id[sr[1]])
            angles.append(float(sr[2]) if len(sr) > 2 else np.nan)
            # first unused grasp-site pair (furniture_sawyer_dense.py:198-204)
            gl = gr = None
            for i in range(S):
                cl, cr = f"{leg}_ltgt_site{i}", f"{leg}_rtgt_site{i}"
                if cl not in used and cr not in used and cl in site2id:
                    used.add(cl)
                    used.add(cr)
                    gl, gr = site2id[cl], site2id[cr]
                    break
            if gl is None:
                raise ValueError(f"{leg}: no grasp target sites")
            gls.append(gl)
            grs.append(gr)
            lift_z.append(float(recipe["waypoints"][s][0][2]))
            gi = recipe.get("grip_init_pos", [None] * S)[s]
            if gi is not None:
                has_ginit.append(True)
                off = list(gi[0])
                ginit_off.append(off[:3])
                ginit_z.append(off[3] - 0.085 if len(off) == 4 else np.nan)
            else:
                has_ginit.append(False)
                ginit_off.append([0.0, 0.0, 0.0])
                ginit_z.append(np.nan)

        # the tables as numpy (what the JAX package keeps) and on the device
        self._st = {
            "leg": np.array(legs, np.int32),
            "table": np.array(tables, np.int32),
            "leg_site": np.array(lsites, np.int32),
            "table_site": np.array(tsites, np.int32),
            "gl": np.array(gls, np.int32),
            "gr": np.array(grs, np.int32),
            "lift_z": np.array(lift_z, np.float32),
            "angle": np.array(angles, np.float32),
            "has_ginit": np.array(has_ginit),
            "ginit_off": np.array(ginit_off, np.float32),
            "ginit_z": np.array(ginit_z, np.float32),
        }
        dev = self.device
        self._stt = {
            k: torch.as_tensor(v, device=dev).long() if v.dtype == np.int32
            else torch.as_tensor(v, device=dev)
            for k, v in self._st.items()
        }
        self.n_subtasks = S
        self._z_finedist = float(recipe.get("z_finedist", 0.05))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self._ez = f32([0.0, 0.0, 1.0])
        self._down = f32([0.0, 0.0, -1.0])
        self._lower_off = f32([0.0, 0.0, -0.015])
        self._above_off = f32([0.0, 0.0, 0.05])
        self._phase_sets = {
            name: torch.as_tensor(p, dtype=torch.int32, device=dev)
            for name, p in (("up", _GRIP_UP_PHASES), ("fwd", _GRIP_FORWARD_PHASES),
                            ("open", _GRIP_OPEN_PHASES))
        }

    def _subtask(self, state):
        """Each env's subtask index into the tables, [B] int64, clamped to
        the recipe as the JAX package's gathers clamp."""
        return torch.clamp(state.subtask_step.long(), 0, self.n_subtasks - 1)

    # -- geometric helpers ----------------------------------------------------

    def _site_pos(self, parts: PartState, site_idx):
        """World position of site ``site_idx`` [B] in each env, [B,3]."""
        p = self.ops.site_part[site_idx]
        return rows(parts.pos, p) + T.quat_rotate(rows(parts.quat, p), self.ops.site_pos[site_idx])

    def _conn_pose(self, parts: PartState, conn_idx):
        """World pose of connector ``conn_idx`` [B] in each env."""
        p = self.ops.conn_part[conn_idx]
        q = rows(parts.quat, p)
        return rows(parts.pos, p) + T.quat_rotate(q, self.ops.conn_pos[conn_idx]), q

    def _collect_values(self, state: DenseState, fk_out):
        """All sensor values the reward machine needs
        (``_collect_values``, furniture_sawyer_dense.py:222-271), [B,...]."""
        st = self._stt
        s = self._subtask(state)
        parts = state.parts
        leg = st["leg"][s]
        lsite = st["leg_site"][s]
        tsite = st["table_site"][s]

        leg_pos = rows(parts.pos, leg)
        lpos, lquat = self._conn_pose(parts, lsite)
        tpos, tquat = self._conn_pose(parts, tsite)
        leg_up = T.up_vector_from_quat(lquat)
        table_up = T.up_vector_from_quat(tquat)
        leg_fwd = T.forward_vector_from_quat(lquat)
        table_fwd = T.forward_vector_from_quat(tquat)

        # leg forward rotated by the recipe angle about leg up
        # (_project_connector_forward, env/furniture.py:1178-1199)
        angle = st["angle"][s]
        has_angle = ~torch.isnan(angle)
        fwd_rot_fixed = T.rotate_vector(
            leg_fwd, leg_up, torch.where(has_angle, angle, torch.zeros_like(angle))
        )
        cos = T.cos_siml(leg_fwd, table_fwd)
        f_pos = T.rotate_vector_cos_siml(leg_fwd, leg_up, cos, 1.0)
        f_neg = T.rotate_vector_cos_siml(leg_fwd, leg_up, cos, -1.0)
        better = (T.cos_siml(f_pos, table_fwd) > T.cos_siml(f_neg, table_fwd))[:, None]
        free = torch.where(better, f_pos, f_neg)
        leg_fwd_rotated = torch.where(has_angle[:, None], fwd_rot_fixed, free)

        eef_pos = K.tip_world(self.robot, fk_out, "right")
        gl = self._site_pos(parts, st["gl"][s])
        gr = self._site_pos(parts, st["gr"][s])
        leg_grasp_pos = 0.5 * (gl + gr)
        leg_grasp_vec = gr - gl

        touched = state.touch_l[:, 0] & state.touch_r[:, 0]
        leg_touched = rows(touched, leg)
        above_tpos = tpos + self._ez * self._z_finedist

        return {
            "eef_pos": eef_pos,
            "leg_touched": leg_touched,
            "leg_safe_grasp": leg_touched & (eef_pos[:, 2] < leg_grasp_pos[:, 2]),
            "leg_grasp_pos": leg_grasp_pos,
            "leg_grasp_vec": leg_grasp_vec,
            "leg_pos": leg_pos,
            "leg_site_pos": lpos,
            "table_site_pos": tpos,
            "above_table_site_pos": above_tpos,
            "move_pos_dist": _norm(tpos - lpos),
            "move_above_pos_dist": _norm(above_tpos - lpos),
            "move_up_ang_dist": T.cos_siml(leg_up, table_up),
            "move_forward_ang_dist": T.cos_siml(leg_fwd_rotated, table_fwd),
            "proj_table": T.cos_siml(-table_up, lpos - tpos),
            "proj_leg": T.cos_siml(leg_up, tpos - lpos),
            "table_displacement": _norm(tpos - state.init_table_site_pos),
            "lsite": lsite,
            "tsite": tsite,
        }

    # -- reset ----------------------------------------------------------------

    def _subtask_vars(self, state: DenseState, fk_out) -> DenseState:
        """(Re)initialize the per-subtask reward variables of every env
        (``_update_reward_variables``, furniture_sawyer_dense.py:149-221)."""
        st = self._stt
        s = self._subtask(state)
        parts = state.parts
        leg = st["leg"][s]
        tpos, _ = self._conn_pose(parts, st["table_site"][s])
        leg_pos = rows(parts.pos, leg)
        lift_z = st["lift_z"][s]
        lift_leg_pos = leg_pos + self._ez * lift_z[:, None]

        eef_pos = K.tip_world(self.robot, fk_out, "right")
        gi_z = st["ginit_z"][s]
        init_eef = eef_pos + st["ginit_off"][s]
        init_eef = torch.cat(
            [init_eef[:, :2], torch.where(torch.isnan(gi_z), init_eef[:, 2], gi_z)[:, None]], -1
        )
        phase_i = torch.where(
            st["has_ginit"][s],
            torch.full_like(s, INIT_EEF),
            torch.full_like(s, MOVE_EEF_ABOVE_LEG),
        )

        gl = self._site_pos(parts, st["gl"][s])
        gr = self._site_pos(parts, st["gr"][s])
        above = 0.5 * (gl + gr) + self._above_off

        zero = torch.zeros_like(lift_z)
        prev = Prev(
            init_eef_dist=_norm(eef_pos - init_eef),
            eef_above_leg_dist=_norm(eef_pos - above),
            eef_leg_dist=zero,
            grasp_dist=torch.full_like(zero, -1.0),
            lift_leg_z_dist=lift_z,
            lift_leg_xy_dist=zero,
            move_pos_dist=zero,
            move_up_ang_dist=zero,
            move_forward_ang_dist=zero,
            proj_t=zero,
            proj_l=zero,
        )
        false = torch.zeros_like(state.leg_dropped)
        return state._replace(
            phase_i=phase_i.to(torch.int32),
            leg_dropped=false,
            table_moved=false,
            leg_lift=false,
            leg_fine_aligned=torch.zeros_like(state.leg_fine_aligned),
            init_eef_pos=init_eef,
            init_table_site_pos=tpos,
            init_lift_leg_z=leg_pos[:, 2],
            lift_leg_pos=lift_leg_pos,
            prev=prev,
        )

    def reset_batch(self, num_envs: int, generator: torch.Generator) -> DenseState:
        """``ArmEnv.reset_batch`` (placement, 10 settle launches of the
        free-part kernel) with the dense fields added and initialized for
        each env's first subtask."""
        base = super().reset_batch(num_envs, generator)
        B = num_envs
        dev = self.device
        z = torch.zeros((B,), device=dev)
        z3 = torch.zeros((B, 3), device=dev)
        i0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        f = torch.zeros((B,), dtype=torch.bool, device=dev)
        state = DenseState(
            **base._asdict(),
            phase_i=i0,
            subtask_step=i0,
            leg_dropped=f,
            table_moved=f,
            leg_lift=f,
            leg_fine_aligned=i0,
            init_eef_pos=z3,
            init_table_site_pos=z3,
            init_lift_leg_z=z,
            lift_leg_pos=z3,
            prev=Prev(*([z] * len(Prev._fields))),
        )
        return self._subtask_vars(state, K.fk(self.robot, state.qpos))

    # -- observation ------------------------------------------------------------

    def observe(self, state) -> dict:
        obs = super().observe(state)
        if self.config.dense.phase_ob and hasattr(state, "phase_i"):
            obs["phase_ob"] = torch.nn.functional.one_hot(
                state.phase_i.long(), N_PHASES
            ).to(torch.float32)
        return obs

    # -- dense reward machine -----------------------------------------------------

    def _finish_step(self, state: DenseState, action, prev_connected):
        """Dense-reward post-physics layer for the batch; the hook of the
        inherited ``step_batch``."""
        cfg = self.config
        d = cfg.dense
        state, unstable = self._guard(state)
        state = state._replace(t=state.t + 1)
        connected = state.num_connected > prev_connected

        fk_out = K.fk(self.robot, state.qpos)
        v = self._collect_values(state, fk_out)
        pr = state.prev
        phase = state.phase_i
        leg_touched = v["leg_touched"]
        table_moved_now = v["table_displacement"] > 0.1
        zero = torch.zeros_like(v["move_pos_dist"])
        where = torch.where
        fmin = lambda x, c: torch.clamp(x, max=c)
        # a negative-only part of a shaping term while the leg is not held
        held_or_neg = lambda r: where(leg_touched, r, fmin(r, 0.0))

        # ---- shared penalties/rewards ----
        # ctrl penalty (furniture_sawyer_dense.py:1002-1006)
        ctrl_penalty = -d.ctrl_penalty_coef * _norm(action[:, :-2])
        # stable grip (:946-983)
        _, hand_quat = K.eef_pose(self.robot, fk_out, "right")
        eef_up = T.up_vector_from_quat(hand_quat)
        eef_fwd = T.forward_vector_from_quat(hand_quat)
        eef_up_dist = T.cos_siml(eef_up, self._down)
        eef_up_rew = d.eef_up_dist_coef * (eef_up_dist - 1.0)
        gvec = v["leg_grasp_vec"]
        eef_fwd_dist = torch.maximum(T.cos_siml(eef_fwd, gvec), T.cos_siml(-eef_fwd, gvec))
        eef_fwd_rew = (torch.abs(eef_fwd_dist) - 1.0) * d.eef_forward_dist_coef
        in_up = torch.isin(phase, self._phase_sets["up"])
        in_fwd = torch.isin(phase, self._phase_sets["fwd"])
        stable_grip_reward = where(in_up, eef_up_rew, zero) + where(in_fwd, eef_fwd_rew, zero)
        sg_succ = (~in_up | (eef_up_dist > d.eef_rot_threshold)) & (
            ~in_fwd | (eef_fwd_dist > d.eef_rot_threshold)
        )
        # gripper penalty (:985-1000)
        grip_open_phase = torch.isin(phase, self._phase_sets["open"])
        grip_ac = action[:, -2]
        grip_penalty = where(grip_open_phase, -grip_ac, grip_ac) * d.gripper_penalty_coef
        grip_succ = where(grip_open_phase, grip_ac < 0, grip_ac > 0)
        # move-other-part penalty (:1008-1019)
        move_other_penalty = -d.move_other_part_penalty_coef * v["table_displacement"]

        # ---- per-phase diff rewards (diff_rew=True defaults) ----
        eef_pos = v["eef_pos"]
        # 0 init_eef (:579-601)
        init_dist = _norm(eef_pos - state.init_eef_pos)
        f0 = lambda x: torch.exp(-10 * fmin(x, 0.5))
        r0 = (f0(init_dist) - f0(pr.init_eef_dist)) * d.init_eef_pos_dist_coef * 10
        succ0 = init_dist < 0.03

        # 1 move_eef_above_leg (:603-627)
        above = v["leg_grasp_pos"] + self._above_off
        above_dist = _norm(eef_pos - above)
        r1 = (fmin(pr.eef_above_leg_dist, 1.0) - fmin(above_dist, 1.0)) * d.move_eef_pos_dist_coef * 10
        succ1 = above_dist < 0.03

        # 2 lower_eef (:629-655), also reused by grasp_leg
        lower = v["leg_grasp_pos"] + self._lower_off
        lower_xy = _norm(eef_pos[:, :2] - lower[:, :2])
        lower_z = torch.abs(eef_pos[:, 2] - lower[:, 2])
        lower_dist = _norm(eef_pos - lower)
        r2 = (fmin(pr.eef_leg_dist, 0.2) - fmin(lower_dist, 0.2)) * d.lower_eef_pos_dist_coef * 10
        succ2 = (lower_xy < 0.02) & (lower_z < 0.015)

        # 3 grasp_leg (:657-676)
        r3 = r2 + (grip_ac - pr.grasp_dist) * d.grasp_dist_coef
        succ3 = leg_touched & v["leg_safe_grasp"]

        # 4 lift_leg (:678-729)
        xy_dist = _norm(state.lift_leg_pos[:, :2] - v["leg_pos"][:, :2])
        z_dist = torch.abs(state.lift_leg_pos[:, 2] - v["leg_pos"][:, 2])
        lift_z_rew = (fmin(pr.lift_leg_z_dist, 0.5) - fmin(z_dist, 0.5)) * d.lift_z_dist_coef * 10
        lift_xy_rew = (fmin(pr.lift_leg_xy_dist, 0.8) - fmin(xy_dist, 0.8)) * d.lift_xy_dist_coef * 10
        leg_lift_now = v["leg_pos"][:, 2] > (state.init_lift_leg_z + 0.01)
        lift_bonus = where(
            leg_touched & leg_lift_now & v["leg_safe_grasp"] & ~state.leg_lift,
            torch.full_like(zero, d.phase_bonus / 2),
            zero,
        )
        r4 = held_or_neg(lift_z_rew + lift_xy_rew) + lift_bonus
        succ4 = (xy_dist < d.lift_xy_pos_threshold) & (z_dist < d.lift_z_pos_threshold)

        # 5 align_leg (:731-791)
        align_pos_dist = _norm(state.lift_leg_pos - v["leg_pos"])
        a_pos = (fmin(pr.move_pos_dist, 0.4) - fmin(align_pos_dist, 0.4)) * d.align_pos_dist_coef * 10
        a_up = (v["move_up_ang_dist"] - pr.move_up_ang_dist) * d.align_rot_dist_coef * 10
        a_fwd = (v["move_forward_ang_dist"] - pr.move_forward_ang_dist) * d.align_rot_dist_coef * 10
        r5 = held_or_neg(a_pos) + held_or_neg(a_up) + held_or_neg(a_fwd)
        succ5 = (
            (align_pos_dist < d.align_pos_threshold)
            & (v["move_up_ang_dist"] > d.align_rot_threshold)
            & (v["move_forward_ang_dist"] > d.align_rot_threshold)
            & leg_touched
        )

        # 6 move_leg (:793-851)
        relu = lambda x: torch.clamp(x, min=0.0)
        m_pos = (fmin(pr.move_pos_dist, 0.5) - fmin(v["move_above_pos_dist"], 0.5)) * d.move_pos_dist_coef * 10
        m_up = (relu(v["move_up_ang_dist"]) - relu(pr.move_up_ang_dist)) * d.move_rot_dist_coef * 10
        m_fwd = (
            (relu(v["move_forward_ang_dist"]) - relu(pr.move_forward_ang_dist))
            * d.move_rot_dist_coef * 10
        )
        r6 = held_or_neg(m_pos) + held_or_neg(m_up) + held_or_neg(m_fwd)
        succ6 = (
            ((v["move_above_pos_dist"] < d.move_pos_threshold) | (v["move_pos_dist"] < d.move_pos_threshold))
            & (v["move_up_ang_dist"] > d.move_rot_threshold)
            & (v["move_forward_ang_dist"] > d.move_rot_threshold)
            & leg_touched
        )

        # 7 move_leg_fine (:853-944)
        ef = lambda x: torch.exp(d.move_fine_pos_exp_coef * x)
        fine_pos = (ef(v["move_pos_dist"]) - ef(pr.move_pos_dist)) * d.move_fine_pos_dist_coef * 10
        ang = lambda x: torch.exp(-2 * (1 - torch.clamp(x, min=d.move_rot_threshold - 0.1)))
        fine_up = (ang(v["move_up_ang_dist"]) - ang(pr.move_up_ang_dist)) * d.move_fine_rot_dist_coef * 10
        fine_fwd = (
            (ang(v["move_forward_ang_dist"]) - ang(pr.move_forward_ang_dist))
            * d.move_fine_rot_dist_coef * 10
        )
        pf = lambda x: torch.exp(-3 * (1 - torch.clamp(torch.abs(x), min=0.5)))
        fine_pt = (pf(v["proj_table"]) - pf(pr.proj_t)) * d.move_fine_rot_dist_coef * 5
        fine_pl = (pf(v["proj_leg"]) - pf(pr.proj_l)) * d.move_fine_rot_dist_coef * 5
        aligned_now, _ = self.ops.alignment(state.parts)
        bidx = torch.arange(aligned_now.shape[0], device=self.device)
        fine_succ = aligned_now[bidx, v["lsite"], v["tsite"]]
        connect_rew = where(fine_succ, (action[:, -1] + 1.0) * d.aligned_bonus_coef, zero)
        r7 = (
            held_or_neg(fine_pos) + held_or_neg(fine_up) + held_or_neg(fine_fwd)
            + held_or_neg(fine_pt) + held_or_neg(fine_pl) + connect_rew
        )
        r7 = where(connected, zero, r7)

        ph = phase.long()[:, None]
        phase_reward = torch.stack([r0, r1, r2, r3, r4, r5, r6, r7], -1).gather(1, ph)[:, 0]

        # ---- transitions (furniture_sawyer_dense.py:380-556) ----
        gates = sg_succ & grip_succ
        carry_ok = leg_touched & ~table_moved_now
        adv0 = (phase == INIT_EEF) & succ0 & gates
        adv1 = (phase == MOVE_EEF_ABOVE_LEG) & succ1 & gates
        adv2 = (phase == LOWER_EEF) & succ2 & gates
        adv3 = (phase == GRASP_LEG) & succ3 & sg_succ
        adv4 = (phase == LIFT_LEG) & carry_ok & succ4
        adv5 = (phase == ALIGN_LEG) & carry_ok & succ5
        adv6 = (phase == MOVE_LEG) & carry_ok & succ6
        adv = adv0 | adv1 | adv2 | adv3 | adv4 | adv5 | adv6
        next_phase = where(adv, phase + 1, phase)
        bonus = where(adv0 | adv1 | adv2 | adv3 | adv4, torch.full_like(zero, d.phase_bonus), zero)
        bonus = bonus + where(adv5 | adv6, torch.full_like(zero, d.phase_bonus * 2), zero)

        # skip transitions (when phase_ob is off; :306-346)
        if not d.phase_ob:
            skip_lift = v["leg_safe_grasp"] & sg_succ & (next_phase < GRASP_LEG)
            next_phase = where(skip_lift, torch.full_like(next_phase, LIFT_LEG), next_phase)
            in_45 = (next_phase == LIFT_LEG) | (next_phase == ALIGN_LEG)
            skip_fine = (
                leg_touched
                & in_45
                & ((v["move_pos_dist"] < d.move_pos_threshold) | (v["move_above_pos_dist"] < d.move_pos_threshold))
                & (v["move_up_ang_dist"] > d.move_rot_threshold)
                & (v["move_forward_ang_dist"] > d.move_rot_threshold)
            )
            next_phase = where(skip_fine, torch.full_like(next_phase, MOVE_LEG_FINE), next_phase)
        else:
            skip_fine = torch.zeros_like(adv)

        # drop / table-move bookkeeping (early_termination=False default:
        # flag + one-time drop penalty, no episode end; :444-556, :563-567)
        dropped_now = (phase > GRASP_LEG) & ~leg_touched & ~state.leg_dropped & ~connected
        table_moved_flag = state.table_moved | table_moved_now
        leg_dropped = state.leg_dropped | dropped_now
        done = torch.zeros_like(adv)
        if d.early_termination:
            drop_penalty = zero
            moved_first = table_moved_now & ~state.table_moved
            done = done | dropped_now | moved_first
            bonus = bonus - where(dropped_now, torch.full_like(zero, d.phase_bonus / 2), zero)
            bonus = bonus - where(moved_first, torch.full_like(zero, d.phase_bonus / 2), zero)
        else:
            drop_penalty = where(leg_dropped, torch.full_like(zero, -d.drop_penalty_coef), zero)

        # connect handling (:516-556 + :367-391)
        correct_connect = connected & fine_succ
        wrong_connect = connected & ~fine_succ
        bonus = bonus + where(correct_connect, torch.full_like(zero, d.phase_bonus * 2), zero)
        bonus = bonus - where(
            correct_connect, state.leg_fine_aligned.to(torch.float32) * d.aligned_bonus_coef, zero
        )
        done = done | wrong_connect
        subtask_done = state.subtask_step + 1 >= self.success_num_connects
        success = correct_connect & subtask_done
        done = done | success

        leg_fine_aligned = where(
            fine_succ & (phase == MOVE_LEG_FINE), state.leg_fine_aligned + 1, state.leg_fine_aligned
        )

        # ---- prev updates ----
        in_phase = lambda p: phase == p
        new_prev = Prev(
            init_eef_dist=where(in_phase(INIT_EEF), init_dist, pr.init_eef_dist),
            eef_above_leg_dist=where(adv0 | in_phase(MOVE_EEF_ABOVE_LEG), above_dist, pr.eef_above_leg_dist),
            eef_leg_dist=where(adv1 | in_phase(LOWER_EEF) | in_phase(GRASP_LEG), lower_dist, pr.eef_leg_dist),
            grasp_dist=where(in_phase(GRASP_LEG), grip_ac, pr.grasp_dist),
            lift_leg_z_dist=where(in_phase(LIFT_LEG), z_dist, pr.lift_leg_z_dist),
            lift_leg_xy_dist=where(in_phase(LIFT_LEG), xy_dist, pr.lift_leg_xy_dist),
            move_pos_dist=where(
                adv4, zero,
                where(
                    adv5, v["move_above_pos_dist"],
                    where(
                        adv6 | skip_fine, v["move_pos_dist"],
                        where(
                            in_phase(ALIGN_LEG), align_pos_dist,
                            where(
                                in_phase(MOVE_LEG), v["move_above_pos_dist"],
                                where(in_phase(MOVE_LEG_FINE), v["move_pos_dist"], pr.move_pos_dist),
                            ),
                        ),
                    ),
                ),
            ),
            move_up_ang_dist=where(
                adv4 | skip_fine | (phase >= ALIGN_LEG), v["move_up_ang_dist"], pr.move_up_ang_dist
            ),
            move_forward_ang_dist=where(
                adv4 | skip_fine | (phase >= ALIGN_LEG), v["move_forward_ang_dist"], pr.move_forward_ang_dist
            ),
            proj_t=where(adv6 | skip_fine | in_phase(MOVE_LEG_FINE), v["proj_table"], pr.proj_t),
            proj_l=where(adv6 | skip_fine | in_phase(MOVE_LEG_FINE), v["proj_leg"], pr.proj_l),
        )

        state = state._replace(
            phase_i=next_phase.to(torch.int32),
            prev=new_prev,
            leg_dropped=leg_dropped,
            table_moved=table_moved_flag,
            leg_lift=state.leg_lift | (leg_lift_now & leg_touched & v["leg_safe_grasp"]),
            leg_fine_aligned=leg_fine_aligned,
        )

        # advance to the next subtask on a correct connect (:141-147): a
        # per-env select of the re-initialized state
        advanced = self._subtask_vars(
            state._replace(
                subtask_step=state.subtask_step + 1,
                phase_i=torch.zeros_like(state.phase_i),
            ),
            fk_out,
        )
        state = tree_where(correct_connect & ~subtask_done, advanced, state)

        reward = (
            ctrl_penalty
            + phase_reward
            + stable_grip_reward
            + grip_penalty
            + bonus
            + move_other_penalty
            + drop_penalty
            - cfg.reward.unstable_penalty_coef * unstable.to(torch.float32)
        )
        done = done | (state.t >= cfg.max_episode_steps) | unstable

        obs = self.observe(state)
        info = {
            "success": success,
            "unstable": unstable,
            "phase_i": state.phase_i + N_PHASES * state.subtask_step,
            "subtask": state.subtask_step,
            "phase_bonus": bonus,
            "phase_reward": phase_reward,
            "ctrl_penalty": ctrl_penalty,
            "stable_grip_reward": stable_grip_reward,
            "gripper_penalty": grip_penalty,
            "move_other_part_penalty": move_other_penalty,
            "touch": leg_touched,
            "num_connected": state.num_connected,
        }
        return state, obs, reward, done, info
