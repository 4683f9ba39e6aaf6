"""Collision tables and the batched narrow phase for part collision prims.

The port's counterpart of ``furniture_tpu.physics.collide``. The numpy table
builders are copies of the JAX package's, so both packages build identical
tables. The narrow phase works on a batch of envs at once: every potential
contact has a fixed lane and a validity mask.

* geom vs floor plane: the geom's 8 box corners;
* geom vs geom: vertex-in-box tests both ways (8+8 candidate points/pair);
* geom vs geom edge-edge: one SAT lane per pair (``edge_contacts``) covering
  crossing edges, emitted only where the pair's corner lanes are empty;
* part geom vs robot gripper geom (``robot_contacts``): sample points both
  ways, the robot side a kinematic collider with a prescribed velocity.

Batched tensors lead with the env dimension B; per-lane constants (part
indices, friction, solref betas) are static and unbatched.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T

_CORNER_SIGNS = np.array(
    [
        [sx, sy, sz]
        for sx in (-1.0, 1.0)
        for sy in (-1.0, 1.0)
        for sz in (-1.0, 1.0)
    ]
)  # [8,3]

# corners + 6 face centers + box center: the denser sample set used for
# gripper↔part contacts, where edge-edge and face-center configurations
# (a rotated fingertip pad pressing a flat part face) dominate
_SAMPLE_SIGNS15 = np.concatenate(
    [
        _CORNER_SIGNS,
        np.array(
            [
                [1.0, 0, 0], [-1.0, 0, 0],
                [0, 1.0, 0], [0, -1.0, 0],
                [0, 0, 1.0], [0, 0, -1.0],
                [0.0, 0, 0],
            ]
        ),
    ]
)  # [15,3]


class Contacts(NamedTuple):
    """A fixed-capacity contact set for a batch of envs.

    ``vel_b`` is the prescribed world velocity of the b side at the contact
    point for kinematic colliders (robot gripper geoms, ``part_b == -1``);
    ``None`` stands for zero (floor and part-part lanes)."""

    point: torch.Tensor     # [B,K,3] world position
    normal: torch.Tensor    # [B,K,3] world normal (pushes part_a along +n)
    depth: torch.Tensor     # [B,K] penetration (>0 means overlapping)
    mask: torch.Tensor      # [B,K] bool
    part_a: torch.Tensor    # [K] part index
    part_b: torch.Tensor    # [K] part index, -1 = static world (floor)
    friction: torch.Tensor  # [K]
    beta: torch.Tensor      # [K] per-lane Baumgarte fraction (solref-derived)
    vel_b: torch.Tensor | None = None  # [B,K,3] prescribed b-side velocity


# MuJoCo default solref for geoms that do not set one
_DEFAULT_SOLREF = np.array([0.02, 1.0], np.float32)
# the reference FloorArena plane keeps it
_FLOOR_SOLREF = np.array([0.02, 1.0], np.float32)


def solref_beta(solref_a, solref_b, dt: float, cap: float) -> np.ndarray:
    """Per-pair position-correction fraction from MuJoCo ``solref``:
    β ≈ dt/(τζ) of the penetration per substep, clamped at ``cap``
    (``SimConfig.baumgarte``); pair mixing is the elementwise mean."""
    sr = 0.5 * (np.asarray(solref_a, np.float64) + np.asarray(solref_b, np.float64))
    tz = np.maximum(sr[..., 0] * np.maximum(sr[..., 1], 1e-3), 1e-6)
    return np.minimum(cap, dt / tz).astype(np.float32)


def attach_betas(model_np: dict, cfg_sim) -> None:
    """Precompute per-lane solref betas into the tables dict (idempotent).

    Adds ``_floor_beta [G]``, ``_pair_beta [NP]`` and (when robot pairs are
    present) ``_robot_beta [NPr]``."""
    key = (float(cfg_sim.timestep), float(cfg_sim.baumgarte))
    if model_np.get("_beta_key") == key:
        return
    dt, cap = key
    sr = np.asarray(
        model_np.get(
            "geom_solref",
            np.tile(_DEFAULT_SOLREF, (len(model_np["geom_part"]), 1)),
        ),
        np.float64,
    )
    model_np["_floor_beta"] = solref_beta(sr, _FLOOR_SOLREF[None], dt, cap)
    pairs = model_np["_pairs"]
    if len(pairs):
        model_np["_pair_beta"] = solref_beta(
            sr[pairs[:, 0]], sr[pairs[:, 1]], dt, cap
        )
    else:
        model_np["_pair_beta"] = np.zeros(0, np.float32)
    rpairs = model_np.get("_robot_pairs")
    if rpairs is not None and len(rpairs):
        rsr = np.asarray(
            model_np["robot_np"].get(
                "geom_solref",
                np.tile(_DEFAULT_SOLREF, (int(rpairs[:, 0].max()) + 1, 1)),
            ),
            np.float64,
        )
        model_np["_robot_beta"] = solref_beta(
            sr[rpairs[:, 1]], rsr[rpairs[:, 0]], dt, cap
        )
    model_np["_beta_key"] = key


def geom_box_sizes(model_np) -> np.ndarray:
    """Effective box half-extents per geom (sphere r,r,r; cylinder r,r,h):
    the cylinder half-length moves to z before the radius overwrites y."""
    size = np.array(model_np["geom_size"], dtype=np.float32).copy()
    gtype = np.asarray(model_np["geom_type"])
    sphere = gtype == 1
    size[sphere, 1] = size[sphere, 0]
    size[sphere, 2] = size[sphere, 0]
    cyl = gtype == 2
    size[cyl, 2] = size[cyl, 1]
    size[cyl, 1] = size[cyl, 0]
    return size


def precompute_collision_tables(model) -> dict:
    """Host-side static tables used by the narrow phase (numpy)."""
    out = {
        "geom_part": np.asarray(model.geom_part),
        "geom_pos": np.asarray(model.geom_pos, dtype=np.float32),
        "geom_quat": np.asarray(model.geom_quat, dtype=np.float32),
        "geom_size": np.asarray(model.geom_size, dtype=np.float32),
        "geom_type": np.asarray(model.geom_type),
        "geom_friction": np.asarray(model.geom_friction, dtype=np.float32),
    }
    out["_box_sizes"] = geom_box_sizes(out)
    # floor friction: max(geom, floor=2.0)
    out["_floor_friction"] = np.maximum(out["geom_friction"], 2.0).astype(np.float32)
    gp = out["geom_part"]
    G = len(gp)
    pairs = [
        (i, j) for i in range(G) for j in range(i + 1, G) if gp[i] != gp[j]
    ]
    out["_pairs"] = np.asarray(pairs, dtype=np.int32).reshape(len(pairs), 2)
    # corner-lane -> part mask, sized by n_parts (a part may carry no geoms)
    P = int(model.n_parts)
    lane_part = np.repeat(gp, 8)
    out["_floor_assign"] = (
        lane_part[None, :] == np.arange(P)[:, None]
    )
    return out


def torch_tables(model_np: dict, device) -> dict:
    """Device copies of the tables the batched narrow phase reads (call
    after :func:`attach_betas`)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    pairs = np.asarray(model_np["_pairs"]).reshape(-1, 2)
    gp = np.asarray(model_np["geom_part"])
    return {
        "geom_part": i64(gp),
        "geom_pos": f32(model_np["geom_pos"]),
        "geom_quat": f32(model_np["geom_quat"]),
        "sizes": f32(model_np["_box_sizes"]),
        "geom_friction": f32(model_np["geom_friction"]),
        "floor_part": i64(np.repeat(gp, 8)),
        "floor_friction": f32(np.repeat(model_np["_floor_friction"], 8)),
        "floor_beta": f32(np.repeat(model_np["_floor_beta"], 8)),
        "floor_assign": torch.as_tensor(
            np.asarray(model_np["_floor_assign"]), device=device
        ),
        "ga": i64(pairs[:, 0]),
        "gb": i64(pairs[:, 1]),
        "pair_beta": f32(model_np["_pair_beta"]),
        "corners": f32(_CORNER_SIGNS),
    }


def _geom_world(tt, pos, quat):
    """World pose of every collision geom: part pose ∘ geom offset."""
    part = tt["geom_part"]
    ppos = pos[:, part]
    pquat = quat[:, part]
    wpos = ppos + T.quat_rotate(pquat, tt["geom_pos"])
    wquat = T.quat_mul(pquat, tt["geom_quat"])
    return wpos, wquat


def floor_contacts(tt, pos, quat, slop: float) -> Contacts:
    """Corners of every collision geom vs the floor plane z=0."""
    B = pos.shape[0]
    sizes = tt["sizes"]                                         # [G,3]
    G = sizes.shape[0]
    wpos, wquat = _geom_world(tt, pos, quat)
    corners_local = tt["corners"][None] * sizes[:, None]        # [G,8,3]
    cw = wpos[:, :, None] + T.quat_rotate(wquat[:, :, None], corners_local)
    cw = cw.reshape(B, G * 8, 3)
    depth = -cw[..., 2]
    normal = torch.zeros_like(cw)
    normal[..., 2] = 1.0
    part = tt["floor_part"]
    return Contacts(
        point=cw,
        normal=normal,
        depth=depth,
        mask=depth > -slop,
        part_a=part,
        part_b=torch.full_like(part, -1),
        friction=tt["floor_friction"],
        beta=tt["floor_beta"],
    )


def pair_contacts(tt, pos, quat, group, slop: float) -> Contacts:
    """Vertex-in-box contacts for all precompiled cross-part geom pairs;
    pairs whose parts are welded into one group are masked out."""
    sizes = tt["sizes"]
    gpart = tt["geom_part"]
    wpos, wquat = _geom_world(tt, pos, quat)
    fric = tt["geom_friction"]
    ga, gb = tt["ga"], tt["gb"]

    def verts_in_box(g_src, g_dst):
        """Corners of g_src tested against box g_dst: 8 points per pair."""
        corners = tt["corners"][None] * sizes[g_src][:, None]   # [NP,8,3]
        cw = wpos[:, g_src][:, :, None] + T.quat_rotate(
            wquat[:, g_src][:, :, None], corners
        )                                                       # [B,NP,8,3]
        inv_q = T.quat_inv(wquat[:, g_dst])
        local = T.quat_rotate(
            inv_q[:, :, None], cw - wpos[:, g_dst][:, :, None]
        )
        pen = sizes[g_dst][:, None] - torch.abs(local)          # [B,NP,8,3]
        inside = torch.all(pen > -slop, dim=-1)
        depth, ax = torch.min(pen, dim=-1)   # first minimum, as jnp.argmin
        sign = torch.sign(torch.gather(local, -1, ax[..., None]))[..., 0]
        n_local = torch.nn.functional.one_hot(ax, 3).to(cw.dtype) * sign[..., None]
        n_world = T.quat_rotate(wquat[:, g_dst][:, :, None], n_local)
        return cw, n_world, depth, inside

    B = pos.shape[0]
    cw_ab, n_ab, d_ab, in_ab = verts_in_box(ga, gb)
    cw_ba, n_ba, d_ba, in_ba = verts_in_box(gb, ga)
    point = torch.cat([cw_ab.reshape(B, -1, 3), cw_ba.reshape(B, -1, 3)], 1)
    normal = torch.cat([n_ab.reshape(B, -1, 3), n_ba.reshape(B, -1, 3)], 1)
    depth = torch.cat([d_ab.reshape(B, -1), d_ba.reshape(B, -1)], 1)
    inside = torch.cat([in_ab.reshape(B, -1), in_ba.reshape(B, -1)], 1)

    pa = torch.cat([gpart[ga].repeat_interleave(8), gpart[gb].repeat_interleave(8)])
    pb = torch.cat([gpart[gb].repeat_interleave(8), gpart[ga].repeat_interleave(8)])
    pair_fric = torch.maximum(fric[ga], fric[gb]).repeat_interleave(8)
    same_group = group[:, pa] == group[:, pb]
    return Contacts(
        point=point,
        normal=normal,
        depth=depth,
        mask=inside & ~same_group,
        part_a=pa,
        part_b=pb,
        friction=torch.cat([pair_fric, pair_fric]),
        beta=tt["pair_beta"].repeat_interleave(8).repeat(2),
    )


def concat_contacts(a: Contacts, b: Contacts) -> Contacts:
    """Lane-wise concatenation (batched fields on dim 1, static on dim 0)."""
    if a.vel_b is None and b.vel_b is None:
        vel_b = None
    else:
        va = torch.zeros_like(a.point) if a.vel_b is None else a.vel_b
        vb = torch.zeros_like(b.point) if b.vel_b is None else b.vel_b
        vel_b = torch.cat([va, vb], 1)
    return Contacts(
        point=torch.cat([a.point, b.point], 1),
        normal=torch.cat([a.normal, b.normal], 1),
        depth=torch.cat([a.depth, b.depth], 1),
        mask=torch.cat([a.mask, b.mask], 1),
        part_a=torch.cat([a.part_a, b.part_a]),
        part_b=torch.cat([a.part_b, b.part_b]),
        friction=torch.cat([a.friction, b.friction]),
        beta=torch.cat([a.beta, b.beta]),
        vel_b=vel_b,
    )


def robot_torch_tables(model_np: dict, device) -> dict:
    """Device copies of the flat per-lane robot tables
    (``engine.robot_contact_tables``; call after :func:`attach_betas`)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    rnp = model_np["robot_np"]
    beta = model_np["_robot_beta"][model_np["_rl_pair"]]
    return {
        "rg": i64(model_np["_rl_rgeom"]),
        "pg": i64(model_np["_rl_pgeom"]),
        "signs": f32(model_np["_rl_sign"]),
        "r_sizes": f32(rnp["_box_sizes"]),
        "r_fric": f32(rnp["geom_friction"]),
        "beta": f32(np.concatenate([beta, beta])),
    }


def _sample_in_box(point, box_pos, box_quat, box_size, slop: float):
    """World ``point`` against a box: (depth, inside, outward face normal of
    the least-penetrated axis, in the world frame)."""
    loc = T.quat_rotate(T.quat_inv(box_quat), point - box_pos)
    pen = box_size - torch.abs(loc)
    inside = torch.all(pen > -slop, dim=-1)
    depth, ax = torch.min(pen, dim=-1)          # first minimum, as jnp.argmin
    sign = torch.sign(torch.gather(loc, -1, ax[..., None]))[..., 0]
    n_local = torch.nn.functional.one_hot(ax, 3).to(point.dtype) * sign[..., None]
    return depth, inside, T.quat_rotate(box_quat, n_local)


def robot_contacts(tt, rt, pos, quat, rg_pos, rg_quat, rg_vel, rg_angvel, slop: float) -> Contacts:
    """Part geoms vs robot gripper geoms (kinematic colliders), batched.

    The robot side is treated as infinitely heavy: the part solver sees a
    prescribed contact-point velocity instead of b-side inverse mass.
    ``tt``/``rt`` are :func:`torch_tables`/:func:`robot_torch_tables`;
    ``rg_pos/rg_quat`` [B,RG,3/4] are the world poses of the robot collision
    geoms this substep, ``rg_vel/rg_angvel`` [B,RG,3] the world velocity of
    each geom center and its body's angular velocity. Lanes: side 1 (part
    sample points in the robot box), then side 2 (robot sample points in
    the part box), ``L`` each."""
    sizes = tt["sizes"]
    wpos, wquat = _geom_world(tt, pos, quat)
    rg, pg, signs = rt["rg"], rt["pg"], rt["signs"]
    r_sizes = rt["r_sizes"]

    # side 1: part-geom sample points inside the robot box; the normal
    # pushes the part out of the robot box
    c_p = wpos[:, pg] + T.quat_rotate(wquat[:, pg], signs * sizes[pg])
    d_p, in_p, n_p = _sample_in_box(c_p, rg_pos[:, rg], rg_quat[:, rg], r_sizes[rg], slop)
    # side 2: robot-geom sample points inside the part box; the part's face
    # normal pushes the robot point out, flipped to act on the part
    c_r = rg_pos[:, rg] + T.quat_rotate(rg_quat[:, rg], signs * r_sizes[rg])
    d_r, in_r, n_r = _sample_in_box(c_r, wpos[:, pg], wquat[:, pg], sizes[pg], slop)

    point = torch.cat([c_p, c_r], 1)
    pa = tt["geom_part"][pg].repeat(2)
    lane_fric = torch.maximum(tt["geom_friction"][pg], rt["r_fric"][rg])
    # prescribed velocity of the robot surface at each contact point
    rg2 = torch.cat([rg, rg])
    vel_b = rg_vel[:, rg2] + T.cross(rg_angvel[:, rg2], point - rg_pos[:, rg2])
    return Contacts(
        point=point,
        normal=torch.cat([n_p, -n_r], 1),
        depth=torch.cat([d_p, d_r], 1),
        mask=torch.cat([in_p, in_r], 1),
        part_a=pa,
        part_b=torch.full_like(pa, -1),
        friction=lane_fric.repeat(2),
        beta=rt["beta"],
        vel_b=vel_b,
    )


def _pick(x, idx):
    """``x[b, p, idx[b, p]]`` for ``x`` [B,NP,M,...] and ``idx`` [B,NP]."""
    ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    ix = ix.expand(idx.shape + (1,) + x.shape[3:])
    return torch.gather(x, 2, ix)[:, :, 0]


def edge_contacts(tt, pos, quat, group, slop: float, corner_hit) -> Contacts:
    """SAT box-box contact, one lane per precompiled geom pair, emitted only
    where the pair's corner lanes came up empty (``corner_hit`` [B,NP]).

    All 15 SAT axes (6 face + 9 edge cross) are tested per pair; the contact
    lies on the minimum-overlap axis at the midpoint of the closest points
    of the two supporting edges."""
    sizes = tt["sizes"]
    gpart = tt["geom_part"]
    wpos, wquat = _geom_world(tt, pos, quat)
    fric = tt["geom_friction"]
    ga, gb = tt["ga"], tt["gb"]
    NP = ga.shape[0]
    B = pos.shape[0]

    Ra = T.quat_to_mat(wquat[:, ga])                  # [B,NP,3,3] cols = axes
    Rb = T.quat_to_mat(wquat[:, gb])
    Sa = sizes[ga]                                    # [NP,3]
    Sb = sizes[gb]
    ca = wpos[:, ga]
    cb = wpos[:, gb]
    t = cb - ca                                       # [B,NP,3]
    a_ax = Ra.transpose(-1, -2)                       # [B,NP,3(axis),3(world)]
    b_ax = Rb.transpose(-1, -2)

    # face-axis overlaps
    absAB = torch.abs(torch.einsum("bpid,bpjd->bpij", a_ax, b_ax))
    ta = torch.einsum("bpd,bpid->bpi", t, a_ax)
    tb = torch.einsum("bpd,bpjd->bpj", t, b_ax)
    ov_a = Sa + torch.einsum("pj,bpij->bpi", Sb, absAB) - torch.abs(ta)
    ov_b = torch.einsum("pi,bpij->bpj", Sa, absAB) + Sb - torch.abs(tb)
    face_min = torch.minimum(ov_a.min(-1).values, ov_b.min(-1).values)

    # 9 cross axes n_ij = a_i x b_j
    n = T.cross(a_ax[:, :, :, None, :], b_ax[:, :, None, :, :])  # [B,NP,3,3,3]
    n_len = torch.linalg.norm(n, dim=-1)
    parallel = n_len < 1e-6
    n_hat = n / torch.clamp(n_len, min=1e-12)[..., None]
    a_dot_n = torch.einsum("bpkd,bpijd->bpkij", a_ax, n_hat)
    b_dot_n = torch.einsum("bpkd,bpijd->bpkij", b_ax, n_hat)
    rA = torch.einsum("pk,bpkij->bpij", Sa, torch.abs(a_dot_n))
    rB = torch.einsum("pk,bpkij->bpij", Sb, torch.abs(b_dot_n))
    t_n = torch.einsum("bpd,bpijd->bpij", t, n_hat)
    ov_e = rA + rB - torch.abs(t_n)
    ov_e = torch.where(parallel, torch.full_like(ov_e, 1e9), ov_e)

    ov_flat = ov_e.reshape(B, NP, 9)
    edge_min, best = torch.min(ov_flat, dim=-1)       # first minimum
    n_best = _pick(n_hat.reshape(B, NP, 9, 3), best)                       # [B,NP,3]
    tn_best = _pick(t_n.reshape(B, NP, 9), best)
    n_edge = torch.where((tn_best > 0)[..., None], -n_best, n_best)

    # best face axis of the 6
    ov6 = torch.cat([ov_a, ov_b], -1)
    t6 = torch.cat([ta, tb], -1)
    axes6 = torch.cat([a_ax, b_ax], 2)                # [B,NP,6,3]
    bf = torch.argmin(ov6, -1)
    n_face_raw = _pick(axes6, bf)
    sgn_f = torch.sign(_pick(t6, bf))
    n_face = -sgn_f[..., None] * n_face_raw

    use_face = face_min < edge_min
    n_out = torch.where(use_face[..., None], n_face, n_edge)
    depth_out = torch.minimum(face_min, edge_min)

    # supporting edges
    bi = torch.div(best, 3, rounding_mode="floor")
    bj = best % 3
    oh_i = torch.nn.functional.one_hot(bi, 3).to(t.dtype)   # [B,NP,3]
    oh_j = torch.nn.functional.one_hot(bj, 3).to(t.dtype)
    d1 = _pick(a_ax, bi)
    d2 = _pick(b_ax, bj)
    sgn_a = torch.sign(torch.einsum("bpkd,bpd->bpk", a_ax, -n_out))
    sgn_b = torch.sign(torch.einsum("bpkd,bpd->bpk", b_ax, n_out))
    off_a = torch.einsum("bpk,bpkd->bpd", Sa * sgn_a * (1.0 - oh_i), a_ax)
    off_b = torch.einsum("bpk,bpkd->bpd", Sb * sgn_b * (1.0 - oh_j), b_ax)
    pa0 = ca + off_a
    pb0 = cb + off_b
    r12 = pb0 - pa0
    d12 = torch.sum(d1 * d2, -1)
    denom = torch.clamp(1.0 - d12 * d12, min=1e-9)
    r_d1 = torch.sum(r12 * d1, -1)
    r_d2 = torch.sum(r12 * d2, -1)
    s1 = (r_d1 - d12 * r_d2) / denom
    s2 = (d12 * r_d1 - r_d2) / denom
    half1 = torch.sum(Sa * oh_i, -1)
    half2 = torch.sum(Sb * oh_j, -1)
    s1 = torch.minimum(torch.maximum(s1, -half1), half1)
    s2 = torch.minimum(torch.maximum(s2, -half2), half2)
    # in the face branch the point stays the edge closest-point midpoint
    # (the JAX package's accepted approximation, kept for parity)
    point = 0.5 * (pa0 + s1[..., None] * d1 + pb0 + s2[..., None] * d2)

    intersect = (
        torch.all(ov_a > -slop, -1)
        & torch.all(ov_b > -slop, -1)
        & (edge_min > -slop)
    )
    pa_part = gpart[ga]
    pb_part = gpart[gb]
    same_group = group[:, pa_part] == group[:, pb_part]
    return Contacts(
        point=point,
        normal=n_out,
        depth=depth_out,
        mask=intersect & ~corner_hit & ~same_group,
        part_a=pa_part,
        part_b=pb_part,
        friction=torch.maximum(fric[ga], fric[gb]),
        beta=tt["pair_beta"],
    )
