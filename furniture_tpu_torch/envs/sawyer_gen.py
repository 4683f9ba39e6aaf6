"""Scripted demonstration generator, batched.

The port's counterpart of ``furniture_tpu.envs.sawyer_gen``: the reference's
12-phase waypoint planner (``furniture_sawyer_gen.py``) as a batched scripted
policy ``scripted_action(gen, env_state) -> (action, gen)`` over a small
``GenPolicyState`` whose fields lead with the env dimension B, so a batch of
scripted assembly episodes runs as one loop of ``scripted_action`` and
``step_batch`` on the card.

Phase machine (``furniture_sawyer_gen.py:29-80``):
  0 init_grip  1 xy_move_g  2 align_g  3 z_move_g  4 move_waypoints
  5 align_conn  6 xy_move_conn  7 z_move_conn  8 align_conn_fine
  9 z_move_conn_fine  10 move_nogrip_safepos  11 part_done

Every env is in its own phase. Each of the twelve phase branches is
evaluated for the whole batch and every env takes its own branch's action
and policy fields with a select on ``gen.phase``; the move to the next part
(a ``lax.cond`` in the JAX package) is a per-env select too. A decision is
one pass of tensor operations with no host synchronisation.

The P-control primitives ``move_xy/move_xyz/move_z`` (:272-345) are the
reference's; its per-plane 2D alignment feedback (``align2D``,
``align_gripsites``, ``get_closest_xy_fwd`` :214-270) is replaced, as in the
JAX package, by exact world rotation-vector corrections mapped into the IK
euler slots through the accumulated hand-target frame. Recipe parameters
(eps, magnitudes, waypoint offsets) are compiled into per-subtask tables.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T
from ..config import EnvConfig
from ..robots import kinematics as K
from .assembly import rows, tree_where
from .sawyer_dense import FurnitureSawyerDenseRewardEnv

(
    INIT_GRIP,
    XY_MOVE_G,
    ALIGN_G,
    Z_MOVE_G,
    MOVE_WAYPOINTS,
    ALIGN_CONN,
    XY_MOVE_CONN,
    Z_MOVE_CONN,
    ALIGN_CONN_FINE,
    Z_MOVE_CONN_FINE,
    MOVE_NOGRIP_SAFEPOS,
    PART_DONE,
) = range(12)
N_GEN_PHASES = 12

MAXW = 3  # static safepos buffer capacity (recipes use 1-2 waypoints)

# per-step records copied to the host once a segment of this many steps
SEGMENT = 400


class GenPolicyState(NamedTuple):
    """Scripted-policy state of a batch (every field leads with B)."""

    phase: torch.Tensor          # [B] int32 0..11
    part: torch.Tensor           # [B] int32 current subtask (mirrors subtask_step)
    safepos: torch.Tensor        # [B,MAXW,3] absolute waypoint targets
    safepos_len: torch.Tensor    # [B] int32
    safepos_idx: torch.Tensor    # [B] int32
    z_move_g_prev: torch.Tensor  # [B] f32 griptip ratchet (:498-507)
    noise_wp: torch.Tensor       # [B,3] per-episode waypoint noise
    noise_ng: torch.Tensor       # [B,3] per-episode nogrip noise
    drop_count: torch.Tensor     # [B] int32 consecutive carry steps with no grasp
    phase_steps: torch.Tensor    # [B] int32 steps spent in the current phase


# per-phase step budget and fallthrough target: align phases that
# limit-cycle fall through to their next phase, while stuck move/approach
# phases reopen and re-grasp (the JAX package's robustification: the
# reference's host-side generator discards the whole episode on any stall,
# furniture_sawyer_gen.py:430-697)
_PHASE_LIMIT = np.array(
    [100, 200, 80, 150, 150, 120, 200, 200, 120, 200, 100, 1 << 30], np.int32
)
_PHASE_FALLTHROUGH = np.array(
    [
        XY_MOVE_G,      # INIT_GRIP
        XY_MOVE_G,      # XY_MOVE_G (unreachable leg: keep trying)
        Z_MOVE_G,       # ALIGN_G
        XY_MOVE_G,      # Z_MOVE_G
        ALIGN_CONN,     # MOVE_WAYPOINTS (leg held; skip stuck waypoint)
        XY_MOVE_CONN,   # ALIGN_CONN
        XY_MOVE_G,      # XY_MOVE_CONN
        XY_MOVE_G,      # Z_MOVE_CONN
        Z_MOVE_CONN_FINE,  # ALIGN_CONN_FINE
        XY_MOVE_G,      # Z_MOVE_CONN_FINE
        PART_DONE,      # MOVE_NOGRIP_SAFEPOS
        PART_DONE,      # PART_DONE
    ],
    np.int32,
)


# -- planner primitives (furniture_sawyer_gen.py:214-345), on [..., n] ---------


def _axis(like: torch.Tensor, i: int) -> torch.Tensor:
    """The unit vector along axis ``i`` in the shape of ``like`` [..., 3],
    made on its device (no host copy)."""
    out = torch.zeros_like(like)
    out[..., i] = 1.0
    return out


def _move_xy(cur, tgt, eps, noise=None):
    """Returns (d2, reached): P-move in xy with per-axis deadband and
    0.04-saturation (:272-294). ``reached`` advances the phase."""
    d = tgt - cur
    if noise is not None:
        d = d + noise[..., :2]
    reached = (torch.abs(d[..., 0]) <= eps) & (torch.abs(d[..., 1]) <= eps)
    d = torch.where(torch.abs(d) < eps, torch.zeros_like(d), d)
    d = torch.where(torch.abs(d) > 0.04, torch.sign(d), d)
    return torch.where(reached[..., None], torch.zeros_like(d), d), reached


def _move_xyz(cur, tgt, eps, noise=None):
    """(d3, reached) xyz variant (:295-320)."""
    d = tgt - cur
    if noise is not None:
        d = d + noise
    reached = torch.all(torch.abs(d) <= eps, dim=-1)
    d = torch.where(torch.abs(d) < eps, torch.zeros_like(d), d)
    d = torch.where(torch.abs(d) > 0.04, torch.sign(d), d)
    return torch.where(reached[..., None], torch.zeros_like(d), d), reached


def _move_z(cur, tgt, eps, conn_dist, fine=None):
    """z-approach with a conn_dist offset (:321-345); ``conn_dist`` is a
    scalar or one per env ([...])."""
    if isinstance(conn_dist, torch.Tensor):
        conn_dist = conn_dist[..., None]
    tgt = tgt + _axis(tgt, 2) * conn_dist
    d = tgt - cur
    d = torch.where(torch.abs(d) < eps, torch.zeros_like(d), d)
    if fine is not None:
        d = torch.clamp(d / fine, -0.02, 0.02)
    return d


def _wrap_pi(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _shortest_arc(v, target):
    """World rotation vector (axis·angle, radians) taking unit ``v`` onto
    unit ``target``; picks a deterministic perpendicular axis at the
    antiparallel singularity."""
    c = torch.clamp(torch.sum(v * target, -1), -1.0, 1.0)
    axis = T.cross(v, target)
    n = torch.linalg.norm(axis, dim=-1)
    angle = torch.atan2(n, c)
    # antiparallel fallback: any axis perpendicular to v
    perp = torch.where((torch.abs(v[..., 0]) < 0.9)[..., None], _axis(v, 0), _axis(v, 1))
    anti = T.unit(T.cross(v, perp))
    axis = torch.where(
        (n < 1e-6)[..., None],
        torch.where((c < 0)[..., None], anti, torch.zeros_like(anti)),
        axis / torch.clamp(n, min=1e-8)[..., None],
    )
    return axis * angle[..., None]


def _deadband(w, eps):
    """``w`` where its norm reaches ``eps``, else zero."""
    return torch.where((torch.linalg.norm(w, dim=-1) < eps)[..., None], torch.zeros_like(w), w)


def _up_correction(rel_quat, eps):
    """World rotation vector aligning a held part's conn-site up row-vector
    with the target site's: the shortest arc taking ``rel·e_z`` onto e_z
    (the predicate ``_is_aligned`` checks, ``env/furniture.py:1057-1153``)."""
    ez = _axis(rel_quat[..., :3], 2)
    v = T.quat_rotate(rel_quat, ez)
    return _deadband(_shortest_arc(v, ez), eps)


def _fwd_correction(rel_quat, angles, angle_mask, has_angles, eps):
    """World-z rotation vector aligning the conn-site forward row-vectors up
    to the connector's allowed angle set (``env/furniture.py:1088-1131``;
    reference ``get_closest_xy_fwd`` :222-248). Valid once the up axes are
    aligned. ``angles``/``angle_mask`` [..., A], ``has_angles`` [...]."""
    vf = T.quat_rotate(rel_quat, _axis(rel_quat[..., :3], 0))
    theta = torch.atan2(vf[..., 1], vf[..., 0])
    cand = torch.deg2rad(angles)
    err = _wrap_pi(cand - theta[..., None])
    err = torch.where(angle_mask, torch.abs(err), torch.full_like(err, math.inf))
    best = torch.argmin(err, dim=-1, keepdim=True)
    # sites with no angle list accept any xy orientation
    phi = torch.where(
        has_angles, _wrap_pi(torch.gather(cand, -1, best)[..., 0] - theta), torch.zeros_like(theta)
    )
    phi = torch.where(torch.abs(phi) < eps, torch.zeros_like(phi), phi)
    return _axis(rel_quat[..., :3], 2) * phi[..., None]


def _grip_fwd_correction(hand_quat, gvec2, eps):
    """World-z rotation aligning the finger separation axis (hand body-y in
    world) with the grasp vector's xy direction, nearest of the two senses
    (the goal of the reference's ``align_gripsites``, :214-221)."""
    f = T.quat_rotate(hand_quat, _axis(hand_quat[..., :3], 1))[..., :2]
    phi = _wrap_pi(torch.atan2(gvec2[..., 1], gvec2[..., 0]) - torch.atan2(f[..., 1], f[..., 0]))
    # fingers are symmetric: rotate to the nearer of ±gvec
    phi = torch.where(phi > math.pi / 2, phi - math.pi, phi)
    phi = torch.where(phi < -math.pi / 2, phi + math.pi, phi)
    phi = torch.where(torch.abs(phi) < eps, torch.zeros_like(phi), phi)
    return _axis(hand_quat[..., :3], 2) * phi[..., None]


def _grip_up_correction(hand_quat, eps):
    """World rotation pointing the gripper z-axis straight down (the role of
    the reference's align_g yz/xz corrections, :468-477)."""
    ez = _axis(hand_quat[..., :3], 2)
    w = T.quat_rotate(hand_quat, ez)
    return _deadband(_shortest_arc(w, -ez), eps)


def _set(act, cols, value):
    """A copy of ``act`` [B,8] with ``cols`` (an int or a slice) set."""
    out = act.clone()
    out[:, cols] = value
    return out


class FurnitureSawyerGenEnv(FurnitureSawyerDenseRewardEnv):
    """Dense env + batched scripted assembly policy (reference
    ``FurnitureSawyerGenEnv``, ``furniture_sawyer_gen.py:13``)."""

    def __init__(self, config: EnvConfig | None = None, model=None, device=None):
        super().__init__(config, model, device)
        p = self.model.recipe_raw
        S = self.n_subtasks
        self.eps = float(p["eps"])
        self.eps_fine = float(p["eps_fine"])
        self.rot_eps = float(p["rot_eps"])
        self.rot_eps_fine = float(p["rot_eps_fine"])
        self.lat_mag = float(p["lat_magnitude"])
        self.rot_mag = float(p["rot_magnitude"])
        self.fine_mag = float(p["fine_magnitude"])
        zc = p["z_conn_dist"]
        self._z_conn = np.array(zc if isinstance(zc, list) else [zc] * S, np.float32)
        self.max_success_steps = int(p.get("max_success_steps", 2000))

        def pad_offsets(key):
            out = np.zeros((S, MAXW, 4), np.float32)
            lens = np.zeros(S, np.int32)
            for s, entry in enumerate(p.get(key, [None] * S)):
                if entry is None:
                    continue
                for w, off in enumerate(entry[:MAXW]):
                    out[s, w, : len(off)] = off
                    out[s, w, 3] = off[3] if len(off) == 4 else np.nan
                lens[s] = min(len(entry), MAXW)
            return out, lens

        self._ginit, self._ginit_len = pad_offsets("grip_init_pos")
        self._wp, self._wp_len = pad_offsets("waypoints")
        self._ng, self._ng_len = pad_offsets("nogrip_safepos")
        ga = p.get("grip_angles")
        self._skip_align_g = np.array([ga is not None and ga[s] is None for s in range(S)])
        # gripper base collision geom (reference gripbase_site,
        # furniture_sawyer_gen.py:362)
        names = self.robot.geom_names
        cand = [i for i, n in enumerate(names) if "gripper_base" in n]
        self._gripbase_geom = cand[0] if cand else int(np.flatnonzero(self.robot.hand_geoms)[0])

        # the same tables on the device, made once
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        self._gt = {
            "z_conn": f32(self._z_conn),
            "ginit": f32(self._ginit),
            "ginit_len": i32(self._ginit_len),
            "wp": f32(self._wp),
            "wp_len": i32(self._wp_len),
            "ng": f32(self._ng),
            "ng_len": i32(self._ng_len),
            "skip_align_g": torch.as_tensor(self._skip_align_g, device=dev),
            "limit": i32(_PHASE_LIMIT),
            "fallthrough": i32(_PHASE_FALLTHROUGH),
            "gripbase_local": f32(self.robot.geom_pos[self._gripbase_geom]),
        }

    # -- policy ----------------------------------------------------------------

    def init_policy_state(self, env_state, generator: torch.Generator) -> GenPolicyState:
        """A fresh policy state for each env of ``env_state``; the per-episode
        waypoint and nogrip noises are uniform in [0, 2·furn_xyz_rand), drawn
        from ``generator`` (waypoint noise first)."""
        r = self.config.furn_xyz_rand
        B = env_state.qpos.shape[0]
        dev = self.device
        noise_wp = torch.rand((B, 3), generator=generator, device=dev) * (2 * r)
        noise_ng = torch.rand((B, 3), generator=generator, device=dev) * (2 * r)
        i0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        gen = GenPolicyState(
            phase=i0,
            part=i0,
            safepos=torch.zeros((B, MAXW, 3), device=dev),
            safepos_len=i0,
            safepos_idx=i0,
            z_move_g_prev=torch.full((B,), math.inf, device=dev),
            noise_wp=noise_wp,
            noise_ng=noise_ng,
            drop_count=i0,
            phase_steps=i0,
        )
        return self._enter_part(gen, K.fk(self.robot, env_state.qpos))

    def _gripbase_pos(self, fk_out):
        b = int(self.robot.geom_body[self._gripbase_geom])
        return fk_out["body_pos"][:, b] + T.quat_rotate(
            fk_out["body_quat"][:, b], self._gt["gripbase_local"]
        )

    def _enter_part(self, gen: GenPolicyState, fk_out) -> GenPolicyState:
        """Per-part (re)initialization (furniture_sawyer_gen.py:386-422):
        grip_init safepos, or skip to xy_move_g."""
        s = torch.clamp(gen.part.long(), 0, self.n_subtasks - 1)
        base = self._gripbase_pos(fk_out)
        off = self._gt["ginit"][s]                              # [B,MAXW,4]
        tgt = base[:, None, :] + off[..., :3]
        tgt = torch.cat(
            [tgt[..., :2], torch.where(torch.isnan(off[..., 3]), tgt[..., 2], off[..., 3])[..., None]], -1
        )
        n = self._gt["ginit_len"][s]
        return gen._replace(
            phase=torch.where(n > 0, INIT_GRIP, XY_MOVE_G).to(torch.int32),
            safepos=tgt,
            safepos_len=n,
            safepos_idx=torch.zeros_like(gen.safepos_idx),
            z_move_g_prev=torch.full_like(gen.z_move_g_prev, math.inf),
        )

    def scripted_action(self, gen: GenPolicyState, env_state):
        """One planner decision for every env (the body of the reference's
        generate_demos inner loop, furniture_sawyer_gen.py:430-697). Returns
        (action [B,8], gen)."""
        st, gt = self._stt, self._gt
        s = torch.clamp(gen.part.long(), 0, self.n_subtasks - 1)
        phase_in = gen.phase
        B = phase_in.shape[0]
        dev = self.device
        fk_out = K.fk(self.robot, env_state.qpos)
        parts = env_state.parts

        gripbase = self._gripbase_pos(fk_out)
        grip_pos, hand_quat = K.site_world(self.robot, fk_out, "right")
        griptip = K.tip_world(self.robot, fk_out, "right")

        gl = self._site_pos(parts, st["gl"][s])
        gr = self._site_pos(parts, st["gr"][s])
        g_pos = 0.5 * (gl + gr)
        g_vec = gr - gl

        gconn = st["leg_site"][s]
        tconn = st["table_site"][s]
        gconn_pos, gconn_quat = self._conn_pose(parts, gconn)
        tconn_pos, tconn_quat = self._conn_pose(parts, tconn)

        # velocity-lead prediction of the held leg's conn site, one control
        # step ahead (the JAX package's damping of the compliant grasp's swing)
        leg_idx = st["leg"][s]
        v_conn = rows(parts.lin_vel, leg_idx) + T.cross(
            rows(parts.ang_vel, leg_idx), gconn_pos - rows(parts.pos, leg_idx)
        )
        gconn_pred = gconn_pos + (1.0 / self.config.sim.control_freq) * v_conn

        angles = self.ops.conn_angles[gconn]
        amask = self.ops.conn_angle_mask[gconn]
        has_angles = self.ops.conn_has_angles[gconn]
        z_conn = gt["z_conn"][s]

        # relative conn-site rotation: the quantity every align phase controls
        rel = T.quat_mul(gconn_quat, T.quat_inv(tconn_quat))
        hand_tgt = env_state.hand_quat_init[:, 0]

        # the env's own connectability predicate for the current pair: the
        # fine phases press connect the moment the env would accept it
        aligned_now, _ = self.ops.alignment(parts)
        bidx = torch.arange(B, device=dev)
        fine_ok = aligned_now[bidx, gconn, tconn]

        def to_act(omega_world):
            """World rotation vector [rad] → euler action slots 3:6, in the
            hand target's body frame (``_do_ik_step`` semantics,
            ``env/furniture.py:2917-2922``)."""
            return T.quat_rotate(T.quat_inv(hand_tgt), omega_world)

        zeros = torch.zeros((B, 8), device=dev)
        grip_open = _set(zeros, 6, -1.0)
        grip_closed = _set(zeros, 6, 1.0)
        i32 = lambda x: x.to(torch.int32)
        zero_i = torch.zeros_like(gen.safepos_idx)

        def safepos_at(idx):
            i = torch.clamp(idx.long(), 0, MAXW - 1)
            return gen.safepos[bidx, i]

        # travel waypoints are coarse via points: they accept 3x eps
        wp_eps = 3.0 * self.eps

        def ph_init_grip():
            d, reached = _move_xyz(gripbase, safepos_at(gen.safepos_idx), wp_eps)
            act = _set(grip_open, slice(0, 3), d)
            idx = torch.where(reached, gen.safepos_idx + 1, gen.safepos_idx)
            advance = idx >= gen.safepos_len
            return act, gen._replace(
                safepos_idx=torch.where(advance, zero_i, idx),
                phase=i32(torch.where(advance, XY_MOVE_G, gen.phase)),
            )

        def ph_xy_move_g():
            # keep a safe traverse height: a low open gripper plows into
            # lying parts
            d, reached = _move_xy(grip_pos[:, :2], g_pos[:, :2], self.eps)
            climb = torch.clamp(0.35 - gripbase[:, 2], min=0.0)
            act = _set(grip_open, slice(0, 2), d)
            act = _set(act, 2, torch.where(climb > 0.02, climb, torch.zeros_like(climb)))
            return act, gen._replace(phase=i32(torch.where(reached, ALIGN_G, gen.phase)))

        def ph_align_g():
            # gripper straight down + fingers across the grasp vector,
            # corrected together with xy, with a 2x rotation tolerance
            w_up = _grip_up_correction(hand_quat, 2 * self.rot_eps)
            w_fwd = _grip_fwd_correction(hand_quat, g_vec[:, :2], 2 * self.rot_eps)
            rot = w_up + w_fwd
            rot_zero = torch.all(rot == 0.0, dim=-1)
            d, reached = _move_xy(grip_pos[:, :2], g_pos[:, :2], self.eps)
            act = _set(_set(grip_open, slice(0, 2), d), slice(3, 6), to_act(rot))
            skip = gt["skip_align_g"][s]
            advance = skip | (rot_zero & reached)
            return act, gen._replace(phase=i32(torch.where(advance, Z_MOVE_G, gen.phase)))

        def ph_z_move_g():
            d = g_pos - grip_pos
            descending = (torch.abs(d[:, 2]) > self.eps) & (griptip[:, 2] < gen.z_move_g_prev)
            act = torch.where(descending[:, None], _set(grip_open, slice(0, 3), d), grip_closed)
            # on grasp: safepos <- gripbase + waypoint offsets, carry height
            # floored at 0.40
            tgt = gripbase[:, None, :] + gt["wp"][s, :, :3] + gen.noise_wp[:, None, :]
            tgt = torch.cat([tgt[..., :2], torch.clamp(tgt[..., 2:], min=0.40)], -1)
            dsc = descending[:, None, None]
            return act, gen._replace(
                z_move_g_prev=torch.where(descending, griptip[:, 2] - 1e-4, gen.z_move_g_prev),
                phase=i32(torch.where(descending, gen.phase, MOVE_WAYPOINTS)),
                safepos=torch.where(dsc, gen.safepos, tgt),
                safepos_len=torch.where(descending, gen.safepos_len, gt["wp_len"][s]),
                safepos_idx=torch.where(descending, gen.safepos_idx, zero_i),
            )

        def through_waypoints(base_act, next_phase):
            done_wp = gen.safepos_idx >= gen.safepos_len
            d, reached = _move_xyz(gripbase, safepos_at(gen.safepos_idx), wp_eps)
            act = _set(base_act, slice(0, 3), torch.where(done_wp[:, None], torch.zeros_like(d), d))
            idx = torch.where(reached & ~done_wp, gen.safepos_idx + 1, gen.safepos_idx)
            return act, gen._replace(
                safepos_idx=torch.where(done_wp, zero_i, idx),
                phase=i32(torch.where(done_wp, next_phase, gen.phase)),
            )

        def ph_move_waypoints():
            return through_waypoints(grip_closed, ALIGN_CONN)

        # safe traverse height for the held leg's conn site
        z_keep = tconn_pos[:, 2] + z_conn + self._z_finedist + 0.04

        def hold_z(act):
            # an altitude floor, not a target: push up only when the tip
            # sinks below the safe height
            dz = torch.clamp(z_keep - gconn_pred[:, 2], 0.0, 0.3)
            return _set(act, 2, torch.where(dz > self.eps, dz, torch.zeros_like(dz)))

        def press(act, when):
            return torch.where(when[:, None], _set(act, 7, 1.0), act)

        def ph_align_conn():
            # up axes first, then the allowed-angle xy rotation, doubled
            w_up = _up_correction(rel, self.rot_eps)
            up_zero = torch.all(w_up == 0.0, dim=-1)
            w_fwd = _fwd_correction(rel, angles, amask, has_angles, self.rot_eps)
            done_rot = up_zero & torch.all(w_fwd == 0.0, dim=-1)
            rot = 2.0 * torch.where(up_zero[:, None], w_fwd, w_up)
            act = hold_z(_set(grip_closed, slice(3, 6), to_act(rot)))
            return act, gen._replace(phase=i32(torch.where(done_rot, XY_MOVE_CONN, gen.phase)))

        def ph_xy_move_conn():
            d, reached = _move_xy(gconn_pred[:, :2], tconn_pos[:, :2], self.eps)
            # opportunistic press whenever the env's predicate holds
            act = press(hold_z(_set(grip_closed, slice(0, 2), d)), fine_ok)
            return act, gen._replace(phase=i32(torch.where(reached, Z_MOVE_CONN, gen.phase)))

        def ph_z_move_conn():
            d = _move_z(gconn_pred, tconn_pos, self.eps, z_conn + self._z_finedist)
            act = press(_set(grip_closed, slice(0, 3), torch.clamp(d, -0.3, 0.3)), fine_ok)
            reached = torch.all(d == 0, dim=-1)
            return act, gen._replace(phase=i32(torch.where(reached, ALIGN_CONN_FINE, gen.phase)))

        def fine_rotation():
            w_up = _up_correction(rel, self.rot_eps_fine)
            up_zero = torch.all(w_up == 0.0, dim=-1)
            w_fwd = _fwd_correction(rel, angles, amask, has_angles, self.rot_eps_fine)
            fwd_zero = torch.all(w_fwd == 0.0, dim=-1)
            return torch.where(up_zero[:, None], w_fwd, w_up), up_zero & fwd_zero

        def ph_align_conn_fine():
            rot, rot_zero = fine_rotation()
            d, reached = _move_xy(gconn_pred[:, :2], tconn_pos[:, :2], self.eps_fine)
            act = torch.where(
                rot_zero[:, None],
                _set(grip_closed, slice(0, 2), d),
                _set(grip_closed, slice(3, 6), to_act(rot)),
            )
            advance = (rot_zero & reached) | fine_ok
            return act, gen._replace(phase=i32(torch.where(advance, Z_MOVE_CONN_FINE, gen.phase)))

        def ph_z_move_conn_fine():
            d = _move_z(gconn_pred, tconn_pos, self.eps_fine, z_conn, fine=self.fine_mag)
            rot, _ = fine_rotation()
            act = _set(_set(grip_closed, slice(0, 3), d), slice(3, 6), to_act(rot))
            # press whenever idle or the env's predicate accepts; the phase
            # is left only on evidence of a connect (below)
            act = press(act, torch.all(act[:, 0:6] == 0, dim=-1) | fine_ok)
            return act, gen

        def ph_move_nogrip():
            return through_waypoints(grip_open, PART_DONE)

        def ph_part_done():
            return zeros, gen

        branches = (
            ph_init_grip, ph_xy_move_g, ph_align_g, ph_z_move_g, ph_move_waypoints,
            ph_align_conn, ph_xy_move_conn, ph_z_move_conn, ph_align_conn_fine,
            ph_z_move_conn_fine, ph_move_nogrip, ph_part_done,
        )
        # every branch for the whole batch; each env takes its own
        action, out = zeros, gen
        for i, branch in enumerate(branches):
            a_i, g_i = branch()
            mine = phase_in == i
            action = torch.where(mine[:, None], a_i, action)
            out = tree_where(mine, g_i, out)
        gen = out

        # connected-evidence redirect: whatever align/approach phase the
        # policy was in when the env registered the connect, retreat to the
        # nogrip safepos and let PART_DONE advance to the next part
        connected_evt = (
            (env_state.subtask_step > gen.part) | (env_state.num_connected >= self.n_subtasks)
        ) & (gen.phase >= ALIGN_CONN) & (gen.phase <= Z_MOVE_CONN_FINE)
        tgt_ng = gripbase[:, None, :] + gt["ng"][s, :, :3] + gen.noise_ng[:, None, :]
        gen = gen._replace(
            phase=i32(torch.where(connected_evt, MOVE_NOGRIP_SAFEPOS, gen.phase)),
            safepos=torch.where(connected_evt[:, None, None], tgt_ng, gen.safepos),
            safepos_len=i32(torch.where(connected_evt, gt["ng_len"][s], gen.safepos_len)),
            safepos_idx=i32(torch.where(connected_evt, zero_i, gen.safepos_idx)),
        )

        # magnitudes + clip (:679-683, :117-124); the reference's min_rot_act
        # floor is not applied (the simulated wrist has no stiction)
        scale = torch.ones(8, device=dev)
        scale[0:3] = self.lat_mag
        scale[3:6] = self.rot_mag
        action = torch.clamp(action * scale, -1.0, 1.0)

        # translation caps: connector descent 10%, carrying 25%, pre-grasp
        # approach 50% (the JAX package's measured remedies against a
        # compliant grasp and the IK target's low-pass)
        ph = gen.phase
        carrying = (ph == MOVE_WAYPOINTS) | (ph == XY_MOVE_CONN)
        pregrasp = (ph == INIT_GRIP) | (ph == XY_MOVE_G) | (ph == ALIGN_G)
        one = torch.ones((B,), device=dev)
        cap = torch.where(
            ph == Z_MOVE_CONN, 0.1 * one,
            torch.where(carrying, 0.25 * one, torch.where(pregrasp, 0.5 * one, one)),
        )[:, None]
        action = torch.cat([torch.minimum(torch.maximum(action[:, :3], -cap), cap), action[:, 3:]], -1)

        # advance to the next part when the env connected this part: a
        # per-env select of the re-entered policy state
        next_part = (
            (gen.phase == PART_DONE)
            & (env_state.subtask_step > gen.part)
            & (env_state.subtask_step < self.n_subtasks)
        )
        entered = self._enter_part(gen._replace(part=env_state.subtask_step.to(torch.int32)), fk_out)
        gen = tree_where(next_part, entered, gen)

        # drop recovery: a leg un-grasped through 8 carry/align/approach
        # steps sends the policy back to re-grasp it where it landed
        held = rows(env_state.touch_l[:, 0], leg_idx) & rows(env_state.touch_r[:, 0], leg_idx)
        in_carry = (gen.phase >= MOVE_WAYPOINTS) & (gen.phase <= Z_MOVE_CONN_FINE)
        dc = torch.where(in_carry & ~held, gen.drop_count + 1, torch.zeros_like(gen.drop_count))
        regrasp = dc >= 8

        # per-phase step budget: stalled phases fall through
        psteps = torch.where(gen.phase == phase_in, gen.phase_steps + 1, torch.zeros_like(gen.phase_steps))
        gph = gen.phase.long()
        timed_out = psteps >= gt["limit"][gph]
        new_phase = torch.where(
            regrasp, XY_MOVE_G, torch.where(timed_out, gt["fallthrough"][gph], gen.phase)
        )
        # the lift-first redirect: drop recoveries and timeouts of the LOW
        # phases (not INIT_GRIP or XY_MOVE_G, whose fallthrough is XY_MOVE_G)
        low_phase = (
            (gen.phase == Z_MOVE_G) | (gen.phase == XY_MOVE_CONN)
            | (gen.phase == Z_MOVE_CONN) | (gen.phase == Z_MOVE_CONN_FINE)
        )
        reset_grasp = regrasp | (timed_out & low_phase)
        # re-grasp through a lift-in-place waypoint first
        lift = torch.cat([gripbase[:, :2], torch.full((B, 1), 0.37, device=dev)], -1)
        lifted = torch.cat([lift[:, None], gen.safepos[:, 1:]], 1)
        gen = gen._replace(
            drop_count=i32(torch.where(regrasp, torch.zeros_like(dc), dc)),
            phase_steps=i32(torch.where(regrasp | timed_out, torch.zeros_like(psteps), psteps)),
            phase=i32(torch.where(reset_grasp, INIT_GRIP, new_phase)),
            safepos=torch.where(reset_grasp[:, None, None], lifted, gen.safepos),
            safepos_len=i32(torch.where(reset_grasp, 1, gen.safepos_len)),
            safepos_idx=i32(torch.where(reset_grasp, zero_i, gen.safepos_idx)),
            z_move_g_prev=torch.where(
                reset_grasp, torch.full_like(gen.z_move_g_prev, math.inf), gen.z_move_g_prev
            ),
        )
        return action, gen

    # -- batched generation ------------------------------------------------------

    @staticmethod
    def state_snap(env_s) -> dict:
        """Per-step env-state stream entry (the reference DemoRecorder's
        ``states``, ``util/demo_recorder.py:33-56``): parts pose and
        velocity, robot joints and the assembly fields a replay restores."""
        return {
            "parts_pos": env_s.parts.pos,
            "parts_quat": env_s.parts.quat,
            "parts_lin_vel": env_s.parts.lin_vel,
            "parts_ang_vel": env_s.parts.ang_vel,
            "qpos": env_s.qpos,
            "qvel": env_s.qvel,
            "group": env_s.group,
            "weld_active": env_s.weld_active,
            "conn_connected": env_s.conn_connected,
            "num_connected": env_s.num_connected,
        }

    def generate_demos(
        self,
        n_demos: int,
        seed: int = 0,
        batch: int | None = None,
        store_path: str | None = None,
        demo_dir: str | None = None,
        max_steps: int | None = None,
        record_obs: bool = True,
    ):
        """Batched scripted demo generation: ``batch`` scripted episodes in
        parallel on the env's device (one ``scripted_action`` and one
        ``step_batch`` a step, driven by a host loop), returning the
        successful trajectories (reference ``generate_demos`` :347-731 and
        its DemoRecorder save at :716-718).

        Per-step records stay on the device and go to the host once a
        segment of ``SEGMENT`` steps, in one copy. Demos carry per-step
        observations in the reference's ``DemoRecorder`` schema
        (``len(obs) == len(actions) + 1``); ``demo_dir`` also saves each
        demo as a numbered pickle, ``store_path`` writes (actions, rewards)
        through the native trajectory store.

        Returns ``(demos, stats)``; ``stats`` holds the success rate, the
        connect-count histogram and the first-success steps."""
        batch = batch or max(n_demos, 8)
        # the in-policy drop recovery retries failed grasps: twice the
        # reference's success budget by default
        max_steps = max_steps or 2 * self.max_success_steps
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)

        env_s = self.reset_batch(batch, generator)
        gen_s = self.init_policy_state(env_s, generator)
        obs0 = {k: v.cpu().numpy() for k, v in self.observe(env_s).items()}
        state0 = {k: v.cpu().numpy() for k, v in self.state_snap(env_s).items()}

        chunks, pending = [], []
        for t in range(max_steps):
            action, gen_s = self.scripted_action(gen_s, env_s)
            env_s, obs, rew, done, info = self.step_batch(env_s, action)
            rec = {
                "action": action,
                "rew": rew,
                "succ": info["success"],
                "nconn": env_s.num_connected,
                **{f"state/{k}": v for k, v in self.state_snap(env_s).items()},
            }
            if record_obs:
                rec.update({f"obs/{k}": v for k, v in obs.items()})
            pending.append(rec)
            if len(pending) == SEGMENT or t == max_steps - 1:
                chunks.append(_to_host(pending))
                pending = []
        traj = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        actions, rewards = traj["action"], traj["rew"]
        successes, n_conn = traj["succ"], traj["nconn"]
        states_t = {k[6:]: v for k, v in traj.items() if k.startswith("state/")}
        obs_t = {k[4:]: v for k, v in traj.items() if k.startswith("obs/")}

        succ = successes.any(axis=0)                         # [B]
        first = np.where(succ, successes.argmax(0) + 1, max_steps)

        def ob_slice(t, b):
            """One env's observation dict at step t (t == -1: the reset's)."""
            if t < 0:
                return {k: np.asarray(v[b]) for k, v in obs0.items()}
            return {k: np.asarray(v[t, b]) for k, v in obs_t.items()}

        def state_slice(t, b):
            if t < 0:
                return {k: v[b] for k, v in state0.items()}
            return {k: v[t, b] for k, v in states_t.items()}

        demos = []
        for b in np.flatnonzero(succ)[:n_demos]:
            t_end = int(first[b])
            d = {
                "actions": actions[:t_end, b],
                "rewards": rewards[:t_end, b],
                "num_connected": int(n_conn[t_end - 1, b]),
                # reference-schema per-step streams: states has one more
                # entry than actions (the reset state first)
                "states": [state_slice(-1, b)] + [state_slice(t, b) for t in range(t_end)],
                "connect_actions": (actions[:t_end, b, -1] > 0.0).tolist(),
            }
            if record_obs:
                d["obs"] = [ob_slice(-1, b)] + [ob_slice(t, b) for t in range(t_end)]
            demos.append(d)

        if demo_dir is not None and demos:
            from ..utils.demo import DemoRecorder

            rec = DemoRecorder(demo_dir, metadata={
                "agent": self.config.agent_type,
                "furniture_name": self.config.furniture_name,
                "seed": seed,
            })
            for i, d in enumerate(demos):
                for t, a in enumerate(d["actions"]):
                    rec.add(
                        ob=d["obs"][t] if record_obs else None,
                        state=d["states"][t],
                        action=a,
                        reward=float(d["rewards"][t]),
                        connect_action=d["connect_actions"][t],
                    )
                rec.add(
                    ob=d["obs"][len(d["actions"])] if record_obs else None,
                    state=d["states"][len(d["actions"])],
                )
                rec.save(f"Sawyer_{self.config.furniture_name}_", count=i)

        if store_path is not None and demos:
            from ..utils.traj_store import TrajStore

            with TrajStore(os.fspath(store_path), "w") as ts:
                for d in demos:
                    ts.append(d["actions"], d["rewards"])
                ts.flush()

        final_conn = n_conn[-1]
        stats = {
            "batch": int(batch),
            "max_steps": int(max_steps),
            "seed": int(seed),
            "success_rate": float(succ.mean()),
            "connect_histogram": np.bincount(final_conn, minlength=self.n_subtasks + 1).tolist(),
            "mean_num_connected": float(final_conn.mean()),
            "first_success_steps": sorted(int(f) for f in first[succ]),
        }
        return demos, stats


_NUMPY = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32}


def _to_host(records: list) -> dict:
    """A segment of per-step records (dicts of [B,...] tensors on one
    device) as numpy arrays [T,B,...], through one device-to-host copy: the
    fields are stacked over the steps and packed as bytes into one buffer on
    the device."""
    names = list(records[0])
    stacked = [torch.stack([r[k] for r in records]) for k in names]
    flat = torch.cat([x.contiguous().reshape(-1).view(torch.uint8) for x in stacked])
    host = flat.cpu().numpy()
    out, at = {}, 0
    for k, x in zip(names, stacked):
        n = x.numel() * x.element_size()
        out[k] = host[at: at + n].view(_NUMPY[x.dtype]).reshape(tuple(x.shape))
        at += n
    return out
