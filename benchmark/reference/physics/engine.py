"""Group-composite rigid-body integrator + masked Jacobi contact solver.

The port's counterpart of ``furniture_tpu.physics.engine``, written for a
batch of envs at once (every tensor leads with the env dimension B). Welded
parts move as one composite rigid body selected by the per-env ``group``
label array.

This module is the **plain PyTorch version** of the free-part kernel
(``physics/megakernel.py``, ``physics/csrc/megakernel.cu``): the kernel's
wrapper runs it for CPU tensors, and the tests and ``chip_smoke.py`` hold
the kernel against it. With ``extra_contacts`` (the robot gripper lanes of
``collide.robot_contacts``) the same substep is the part half of the arm
kernel's plain version (``physics/arm_megakernel.py``).

Shapes: B envs, P parts, K contact lanes (static capacity).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T
from .collide import (
    _CORNER_SIGNS,
    _SAMPLE_SIGNS15,
    Contacts,
    attach_betas,
    concat_contacts,
    edge_contacts,
    floor_contacts,
    pair_contacts,
    precompute_collision_tables,
    torch_tables,
)
from .state import PartState, zero_vel

# warm-start normal-impulse cap, in acceleration units (m/s²): ~20 g, so a
# persistent contact can warm-start with well above its share of the weight
# impulse, while one-substep impact spikes are discarded
WARM_CAP_ACC = 200.0
# robot (kinematic-finger) lanes carry a tighter cap: a stale over-applied
# impulse between two stiff kinematic pads grows into an oscillation that
# ejects held parts
ROBOT_WARM_CAP_ACC = WARM_CAP_ACC * 0.15


def _inv3(a):
    """Closed-form 3x3 inverse (adjugate/det) with the det guard 1e-18."""
    m00, m01, m02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    m10, m11, m12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    m20, m21, m22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    rows = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        dim=-2,
    )
    return rows * inv_det[..., None, None]


def _group_aggregates(pt, state: PartState, group):
    """Composite mass properties of each part's rigid group; every part
    carries its group's values. ``pt`` holds the part tables on device."""
    mass, com_l, I_l = pt["mass"], pt["com"], pt["inertia"]
    member = (group[:, :, None] == group[:, None, :]).to(torch.float32)  # [B,P,P]
    com_w = state.pos + T.quat_rotate(state.quat, com_l)                # [B,P,3]
    R = T.quat_to_mat(state.quat)                                       # [B,P,3,3]
    I_w = R @ I_l @ R.transpose(-1, -2)

    g_mass = member @ mass                                              # [B,P]
    g_com = (member @ (mass[:, None] * com_w)) / g_mass[..., None]      # [B,P,3]

    d = com_w[:, None, :, :] - g_com[:, :, None, :]                     # [B,P,P,3]
    d2 = torch.sum(d * d, dim=-1)
    eye = torch.eye(3, dtype=torch.float32, device=d.device)
    pa = mass[None, None, :, None, None] * (
        d2[..., None, None] * eye - d[..., :, None] * d[..., None, :]
    )                                                                   # [B,P,P,3,3]
    g_inertia = torch.einsum("bpq,bqij->bpij", member, I_w) + torch.sum(
        member[..., None, None] * pa, dim=2
    )
    g_inv_mass = 1.0 / g_mass
    g_inv_inertia = _inv3(g_inertia + 1e-8 * eye)
    return member, g_com, g_inv_mass, g_inv_inertia


def _tangent_basis(n):
    """Orthonormal (t1, t2) perpendicular to n (branch-free)."""
    use_z = (torch.abs(n[..., 2]) < 0.9).to(n.dtype)
    ref = torch.stack([1.0 - use_z, torch.zeros_like(use_z), use_z], dim=-1)
    t1 = T.unit(T.cross(n, ref))
    t2 = T.cross(n, t1)
    return t1, t2


class LanePrep(NamedTuple):
    """Per-lane constants of one contact solve (every field leads with B
    unless noted): what both solvers, the warm-started one below and the
    lane solver of ``physics/lane_solver.py``, sweep over."""

    pa: torch.Tensor          # [K] side-a part
    pb: torch.Tensor          # [K] side-b part (0 where the lane has none)
    hb: torch.Tensor          # [K] float: the lane has a side b
    r_a: torch.Tensor         # [B,K,3] contact point from the a group's COM
    r_b: torch.Tensor         # [B,K,3]
    dirs: torch.Tensor        # [B,K,3dir,3]: normal, tangent 1, tangent 2
    inv_w: torch.Tensor       # [B,K,3] inverse effective mass per direction
    bias: torch.Tensor        # [B,K] depenetration velocity
    fmask: torch.Tensor       # [B,K] float: lane active
    lane_scale: torch.Tensor  # [B,K] relaxation / contention
    mem_a: torch.Tensor       # [B,K,P] float: part in the a side's group
    mem_b: torch.Tensor       # [B,K,P]


def lane_prep(
    c: Contacts, group, g_com, g_inv_mass, g_inv_inertia, dt: float,
    relaxation: float, slop: float,
) -> LanePrep:
    """Lever arms, tangent basis, effective masses (floored at 1e-8), the
    solref Baumgarte bias capped at 0.5 m/s, group membership and the
    mass-splitting lane scale of every contact lane."""
    fmask = (c.mask & (c.depth > -slop)).to(torch.float32)          # [B,K]
    has_b = c.part_b >= 0                                          # [K]
    hb = has_b.to(torch.float32)
    pa = c.part_a
    pb = torch.where(has_b, c.part_b, torch.zeros_like(c.part_b))

    r_a = c.point - g_com[:, pa]                                   # [B,K,3]
    r_b = c.point - g_com[:, pb]
    inv_m_a = g_inv_mass[:, pa]
    inv_m_b = g_inv_mass[:, pb] * hb
    inv_I_a = g_inv_inertia[:, pa]                                 # [B,K,3,3]
    inv_I_b = g_inv_inertia[:, pb] * hb[:, None, None]

    t1, t2 = _tangent_basis(c.normal)
    dirs = torch.stack([c.normal, t1, t2], dim=2)                  # [B,K,3dir,3]
    rxd_a = T.cross(r_a[:, :, None, :], dirs)                      # [B,K,3,3]
    rxd_b = T.cross(r_b[:, :, None, :], dirs)

    def quad(rxd, inv_I):
        t = torch.sum(inv_I[:, :, None, :, :] * rxd[:, :, :, None, :], dim=-1)
        return torch.sum(rxd * t, dim=-1)

    w = (
        inv_m_a[..., None]
        + inv_m_b[..., None]
        + quad(rxd_a, inv_I_a)
        + quad(rxd_b, inv_I_b)
    )                                                              # [B,K,3]
    inv_w = 1.0 / torch.clamp(w, min=1e-8)
    # per-lane Baumgarte (solref-derived), depenetration speed capped at 0.5
    bias = -torch.clamp((c.beta / dt) * torch.clamp(c.depth - slop, min=0.0), max=0.5)

    # membership scatter (group of part_a / part_b -> all member parts)
    mem_a = (group[:, pa][:, :, None] == group[:, None, :]).to(torch.float32)  # [B,K,P]
    mem_b = (
        (group[:, pb][:, :, None] == group[:, None, :]) & has_b[None, :, None]
    ).to(torch.float32)

    # mass splitting: scale each lane by 1/n of the most contended side
    cnt_p = torch.einsum("bk,bkp->bp", fmask, mem_a + mem_b)       # [B,P]
    n_a = cnt_p[:, pa]
    n_b = cnt_p[:, pb] * hb
    lane_scale = relaxation / torch.clamp(torch.maximum(n_a, n_b), min=1.0)
    return LanePrep(pa, pb, hb, r_a, r_b, dirs, inv_w, bias, fmask, lane_scale, mem_a, mem_b)


def _solve_contacts(
    c: Contacts,
    group,
    g_com,
    g_inv_mass,
    g_inv_inertia,
    lin_vel,
    ang_vel,
    dt: float,
    iters: int,
    relaxation: float,
    slop: float,
    lam0,
    warm_cap=None,
    min_normal=None,
):
    """Impulse-accumulating mass-split Jacobi solve, warm-started from
    ``lam0`` [B,K,3], capped at ``WARM_CAP_ACC`` or, per lane, at
    ``warm_cap`` [K]. Lanes with ``part_b == -1`` and a ``vel_b`` are
    kinematic colliders moving at that prescribed velocity. ``min_normal``
    ([K] or [B,K], optional) is a per-lane floor of the normal impulse on
    the active lanes (a general solver feature of the JAX package's
    ``_solve_contacts``; no caller of either package passes one, and no
    kernel takes it). Returns the updated group velocities, the converged
    ``lam`` for the next substep and the impulse [B,K,3] each lane applied
    to its part a."""
    pa, pb, hb, r_a, r_b, dirs, inv_w, bias, fmask, lane_scale, mem_a, mem_b = lane_prep(
        c, group, g_com, g_inv_mass, g_inv_inertia, dt, relaxation, slop
    )
    lam_floor = None if min_normal is None else min_normal * fmask

    mem_ab_t = (mem_a - mem_b).transpose(1, 2)                      # [B,P,K]
    mem_a_t = mem_a.transpose(1, 2)
    mem_b_t = mem_b.transpose(1, 2)

    def apply(lam):                                                 # lam [B,K,3]
        imp = torch.sum(lam[..., None] * dirs, dim=2) * fmask[..., None]
        tq_a = T.cross(r_a, imp)
        tq_b = T.cross(r_b, -imp)
        dlin = (mem_ab_t @ imp) * g_inv_mass[..., None]             # [B,P,3]
        ang_acc = mem_a_t @ tq_a + mem_b_t @ tq_b
        dang = torch.sum(g_inv_inertia * ang_acc[:, :, None, :], dim=-1)
        return lin_vel + dlin, ang_vel + dang

    fric = c.friction

    def body(lam):
        lv, av = apply(lam)
        va = lv[:, pa] + T.cross(av[:, pa], r_a)
        vb = (lv[:, pb] + T.cross(av[:, pb], r_b)) * hb[:, None]
        if c.vel_b is not None:
            vb = vb + c.vel_b
        v_rel = va - vb
        vd = torch.sum(v_rel[:, :, None, :] * dirs, dim=-1)         # [B,K,3]
        target = torch.stack([vd[..., 0] + bias, vd[..., 1], vd[..., 2]], -1)
        lam_new = lam - target * inv_w * lane_scale[..., None]
        if lam_floor is None:
            ln = torch.clamp(lam_new[..., 0], min=0.0)
        else:
            ln = torch.maximum(lam_new[..., 0], lam_floor)
        max_f = fric * ln
        lt = torch.minimum(
            torch.maximum(lam_new[..., 1:], -max_f[..., None]), max_f[..., None]
        )
        return torch.cat([ln[..., None], lt], dim=-1)

    # warm start capped at a resting-contact scale: a stale impact impulse
    # re-applied as the initial guess would launch the part
    cap = (WARM_CAP_ACC if warm_cap is None else warm_cap) * inv_w[..., 0] * dt
    ln0 = torch.minimum(lam0[..., 0], cap)
    mf0 = (fric * ln0)[..., None]
    lam = torch.cat(
        [ln0[..., None], torch.minimum(torch.maximum(lam0[..., 1:], -mf0), mf0)], -1
    )
    for _ in range(iters):
        lam = body(lam)
    lv, av = apply(lam)
    imp = torch.sum(lam[..., None] * dirs, dim=2) * fmask[..., None]
    return lv, av, lam, imp


def _integrate(state: PartState, g_com, dt: float) -> PartState:
    """Rigid group motion: rotate members about the group COM, translate."""
    w = state.ang_vel
    angle = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-18)
    axis = w / angle[..., None]
    dq = T.quat_from_axis_angle(axis, angle * dt)
    rel = state.pos - g_com
    new_pos = g_com + T.quat_rotate(dq, rel) + state.lin_vel * dt
    new_quat = T.quat_normalize(T.quat_mul(dq, state.quat))
    return state._replace(pos=new_pos, quat=new_quat)


def _floor_projection(tt, state: PartState, member, slop: float) -> PartState:
    """Position-level correction: lift each group by its deepest corner."""
    contacts = floor_contacts(tt, state.pos, state.quat, slop)
    pen = torch.where(contacts.mask, contacts.depth - slop, torch.zeros_like(contacts.depth))
    pen = torch.clamp(pen, min=0.0)                                # [B,Kf]
    assign = tt["floor_assign"]                                    # [P,Kf]
    per_part = torch.amax(
        torch.where(assign[None], pen[:, None, :], torch.zeros_like(pen[:, None, :])),
        dim=-1,
    )                                                              # [B,P]
    per_group = torch.amax(member * per_part[:, None, :], dim=-1)   # [B,P]
    pos = state.pos.clone()
    pos[..., 2] = pos[..., 2] + per_group
    return state._replace(pos=pos)


def _part_tables(model_np, device) -> dict:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        "mass": f32(model_np["part_mass"]),
        "com": f32(model_np["part_com"]),
        "inertia": f32(model_np["part_inertia"]),
    }


def _rounded(x, dtype):
    return x.to(dtype).to(torch.float32)


def make_substep(model_np, cfg_sim, device, state_dtype=None):
    """Build the batched single-substep function
    ``substep(state, group, gscale, lam_warm) -> (state, lam)``, closed over
    the model's tables on ``device``. The contacts are solved by the
    warm-started ``_solve_contacts``; the lane backend is not part of the
    reference. ``state_dtype`` (the control's lower precision) rounds the
    part state and the warm start through that type after every substep."""
    attach_betas(model_np, cfg_sim)
    tt = torch_tables(model_np, device)
    pt = _part_tables(model_np, device)
    dt = cfg_sim.timestep
    slop = cfg_sim.contact_slop
    NP = len(model_np["_pairs"])
    if cfg_sim.use_pallas == "lane":
        raise ValueError("the reference has no lane backend")

    def lanes(pos, quat, group):
        """The floor, pair and SAT lanes of a state."""
        fc = floor_contacts(tt, pos, quat, slop)
        pc = pair_contacts(tt, pos, quat, group, slop)
        B = pos.shape[0]
        # SAT edge lane for pairs whose corner lanes are all empty
        ch = (
            pc.mask[:, : NP * 8].reshape(B, NP, 8).any(-1)
            | pc.mask[:, NP * 8 :].reshape(B, NP, 8).any(-1)
        )
        ec = edge_contacts(tt, pos, quat, group, slop, corner_hit=ch)
        return concat_contacts(fc, concat_contacts(pc, ec))

    def solver_args(state: PartState, group, gravity_scale):
        """The group membership [B,P,P] and the contact solve's arguments
        for one substep from ``state``: aggregates, gravity applied to the
        linear velocity, and the floor, pair and SAT lanes."""
        member, g_com, g_inv_mass, g_inv_inertia = _group_aggregates(pt, state, group)
        lin_vel = state.lin_vel.clone()
        lin_vel[..., 2] = lin_vel[..., 2] + dt * cfg_sim.gravity * gravity_scale
        contacts = lanes(state.pos, state.quat, group)
        return member, (
            contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, state.ang_vel,
            dt, cfg_sim.solver_iters, cfg_sim.relaxation, slop,
        )

    def substep(state: PartState, group, gravity_scale, lam_warm, extra_contacts=None,
                extra_min_normal=None):
        """``extra_contacts`` (a prebuilt :class:`Contacts`, the robot
        gripper lanes) are appended to the floor, pair and SAT lanes with
        the tighter robot warm cap; their impulses are then returned as a
        third value. ``extra_min_normal`` ([K_extra] or [B,K_extra]) floors
        the normal impulse of those lanes (zero on the base lanes), as
        ``engine.substep``'s of the JAX package does. Like every call with
        ``extra_contacts``, it runs the plain ``_solve_contacts`` on every
        backend and device: neither kernel takes a floor, nor does the JAX
        package's lane solver (``pallas_solver.solve_contacts_pallas``),
        which the JAX package likewise bypasses for such calls."""
        if extra_min_normal is not None and extra_contacts is None:
            raise ValueError("extra_min_normal floors extra_contacts' lanes: pass both")
        member, solve_args = solver_args(state, group, gravity_scale)
        g_com = solve_args[2]
        warm_cap = min_normal = None
        if extra_contacts is not None:
            contacts = solve_args[0]
            n_base = contacts.depth.shape[1]
            n_extra = extra_contacts.depth.shape[1]
            solve_args = (concat_contacts(contacts, extra_contacts),) + solve_args[1:]
            dev = contacts.depth.device
            warm_cap = torch.cat([
                torch.full((n_base,), WARM_CAP_ACC, device=dev),
                torch.full((n_extra,), ROBOT_WARM_CAP_ACC, device=dev),
            ])
            if extra_min_normal is not None:
                floor = torch.as_tensor(extra_min_normal, dtype=torch.float32, device=dev)
                floor = floor.expand(contacts.depth.shape[0], n_extra)
                min_normal = torch.cat([torch.zeros_like(contacts.depth), floor], -1)

        lv, av, lam, imp = _solve_contacts(*solve_args, lam_warm, warm_cap, min_normal)
        # safety velocity clamp (bounds energy so lanes never NaN)
        lv = torch.clamp(lv, -cfg_sim.max_velocity, cfg_sim.max_velocity)
        av = torch.clamp(av, -cfg_sim.max_velocity, cfg_sim.max_velocity)
        state = state._replace(lin_vel=lv, ang_vel=av)
        state = _integrate(state, g_com, dt)
        state = _floor_projection(tt, state, member, slop)
        if state_dtype is not None:
            # the control: the state and the warm start stored in a lower
            # precision between substeps (the arithmetic stays float32)
            state = PartState(*(_rounded(x, state_dtype) for x in state))
            lam = _rounded(lam, state_dtype)
        if extra_contacts is not None:
            return state, lam, imp[:, n_base:]
        return state, lam

    # 8 floor lanes per geom + 16 vertex + 1 SAT edge lane per pair
    substep.n_base_lanes = 8 * len(model_np["geom_part"]) + 17 * NP
    substep.tables = tt
    substep.solver_args = solver_args
    return substep


def substeps(substep_fn, state: PartState, group, gravity_scale, n: int) -> PartState:
    """Run ``n`` substeps; the converged contact impulses carry across
    substeps as the next substep's warm start (zero at the first)."""
    B = state.pos.shape[0]
    lam = torch.zeros(
        (B, substep_fn.n_base_lanes, 3), dtype=torch.float32, device=state.pos.device
    )
    for _ in range(n):
        state, lam = substep_fn(state, group, gravity_scale, lam)
    return state


def control_step(substep_fn, state: PartState, group, held, n_substeps: int) -> PartState:
    """One control step of free-part physics: all part velocities zeroed,
    held groups gravity-compensated, ``n_substeps`` integration steps, held
    groups re-stopped."""
    state = zero_vel(state)
    gravity_scale = torch.where(held, 0.0, 1.0)
    state = substeps(substep_fn, state, group, gravity_scale, n_substeps)
    hold3 = held[..., None]
    return state._replace(
        lin_vel=torch.where(hold3, 0.0, state.lin_vel),
        ang_vel=torch.where(hold3, 0.0, state.ang_vel),
    )


def physics_tables(model) -> dict:
    """All static numpy tables the engine needs, derived from CompiledModel."""
    out = precompute_collision_tables(model)
    out["geom_solref"] = np.asarray(model.geom_solref, dtype=np.float32)
    out["part_mass"] = np.asarray(model.part_mass, dtype=np.float32)
    out["part_com"] = np.asarray(model.part_com, dtype=np.float32)
    out["part_inertia"] = np.asarray(model.part_inertia, dtype=np.float32)
    return out


def robot_contact_tables(tables: dict, robot, lane_budget: int = 1700) -> dict:
    """Static tables for robot↔part contact coupling.

    Pairs every gripper-side robot geom (``CompiledRobot.hand_geoms``) with
    every part collision geom. Sample sets are per robot geom, densified in
    tiers under ``lane_budget`` (the total lane count K): all hand geoms at
    the 15-point set if that fits, else all finger geoms, else fingertips
    only, else 8 corners everywhere. Lanes are emitted as flat per-lane
    tables (``_rl_*``): side 1 (part-geom sample points vs robot box) first,
    then side 2 (robot-geom sample points vs part box). The plain narrow
    phase (``collide.robot_contacts``) and the arm kernel read these tables.
    """
    hand = np.flatnonzero(robot.hand_geoms)
    finger = set()
    for arm in robot.arms:
        finger |= set(np.asarray(robot.finger_geoms_l[arm]).tolist())
        finger |= set(np.asarray(robot.finger_geoms_r[arm]).tolist())
    part_geoms = np.arange(len(tables["geom_part"]))
    pairs = np.array(
        [(r, p) for r in hand for p in part_geoms], dtype=np.int32
    ).reshape(-1, 2)
    names = list(getattr(robot, "geom_names", [])) or [""] * (
        int(hand.max()) + 1 if len(hand) else 0
    )
    tip = {int(g) for g in hand if "fingertip" in names[int(g)]}
    k_base = 8 * len(tables["geom_part"]) + 17 * len(tables["_pairs"])

    def k_total(ns):
        return k_base + 2 * int(ns.sum())

    tiers = [
        np.full(len(pairs), 15, np.int32),
        np.array([15 if int(r) in finger else 8 for r, _ in pairs], np.int32),
        np.array([15 if int(r) in tip else 8 for r, _ in pairs], np.int32),
        np.full(len(pairs), 8, np.int32),
    ]
    ns_pair = tiers[-1]
    for t in tiers:
        if k_total(t) <= lane_budget:
            ns_pair = t
            break
    s15 = np.asarray(_SAMPLE_SIGNS15, np.float32)
    s8 = np.asarray(_CORNER_SIGNS, np.float32)

    rl_pair, rl_rgeom, rl_pgeom, rl_sign = [], [], [], []
    for i, (r, p) in enumerate(pairs):
        s = s15 if ns_pair[i] == 15 else s8
        rl_pair.append(np.full(len(s), i, np.int32))
        rl_rgeom.append(np.full(len(s), r, np.int32))
        rl_pgeom.append(np.full(len(s), p, np.int32))
        rl_sign.append(s)
    if pairs.size:
        rl_pair = np.concatenate(rl_pair)
        rl_rgeom = np.concatenate(rl_rgeom)
        rl_pgeom = np.concatenate(rl_pgeom)
        rl_sign = np.concatenate(rl_sign, axis=0)
    else:
        rl_pair = np.zeros(0, np.int32)
        rl_rgeom = np.zeros(0, np.int32)
        rl_pgeom = np.zeros(0, np.int32)
        rl_sign = np.zeros((0, 3), np.float32)
    return {
        "_robot_pairs": pairs,
        "_rl_pair": rl_pair,       # [L] pair index per side lane
        "_rl_rgeom": rl_rgeom,     # [L] robot geom per side lane
        "_rl_pgeom": rl_pgeom,     # [L] part geom per side lane
        "_rl_sign": rl_sign,       # [L,3] sample sign vector
        "_lane_rgeom": np.concatenate([rl_rgeom, rl_rgeom]),  # [2L]
        "robot_np": {
            "_box_sizes": np.asarray(robot.geom_size, dtype=np.float32),
            "geom_friction": np.asarray(robot.geom_friction, dtype=np.float32),
            "geom_solref": np.asarray(robot.geom_solref, dtype=np.float32),
        },
    }
