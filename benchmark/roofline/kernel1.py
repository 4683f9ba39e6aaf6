"""Kernel 1, the free-part kernel (``mega_substeps_kernel``): its work per
launch, frozen from ``MegaPhysics.fp32_ops_per_env`` as the benchmark was
defined.

The count is of the *function* (``engine.py``'s substep): per solver pass
one impulse application per (lane, side) entry and one lambda update per
lane; each add, multiply, min/max, compare, divide, square root, sin and cos
counts one, index arithmetic does not. It does not depend on the data. The
bytes are each input and output of the launch once (pose, velocities, group
and gravity scale of every part in; pose and velocities out) and the
model's constant tables once (13 floats a part, 22 a lane), in no kernel's
layout.
"""

from __future__ import annotations

import numpy as np

PATTERN = "mega_substeps_kernel"

CROSS = 9                     # 6 multiplies, 3 subtracts
QROT = 2 * CROSS + 3 * 4      # u x v, u x (u x v), v + 2 (w uv + uuv)
QMUL = 28
QMAT = 8 + 4 + 27             # norm, 4 divides, 9 entries
MAT3 = 45                     # 3x3 product: 27 multiplies, 18 adds
INV3 = 9 * 3 + 5 + 1 + 9      # cofactors, determinant, divide, scale
SAT = (
    2 * QMAT + 3 + 9 * 6      # axes, center offset, |a_i . b_j|
    + 6 * 17                  # 6 face axes: overlap, sign, normal
    + 9 * 71                  # 9 edge axes: cross, norm, radii, overlap
    + 3 * 16 + 40             # supporting-edge anchors, closest points
)
PREP_LANE = 6 + 26 + 3 * 65 + 5   # r_a, r_b; tangent basis; 3 effective masses; bias
APPLY_ENTRY = 18 + CROSS + 6      # impulse, torque, accumulation
APPLY_PART = 6 * 5 + 6 + 18       # warp sums; lv; av = ang + I^-1 tau
UPDATE_LANE = 12 + 15 + 10 + 6    # v_a; 3 projections; 3 lambda steps; cone clamp
INTEGRATE = 12 + 15 + 2 + 3 * 3 + QROT + 9 + QMUL + 12   # clamp; axis-angle; sin/cos; move; rotate


def lanes(tables) -> dict:
    """The model's lane counts: floor (8 a geom), pair (16 a geom pair, both
    directions), SAT edge (1 a pair), all lanes and (lane, side) entries."""
    G = len(np.asarray(tables["geom_part"]))
    NP = len(np.asarray(tables["_pairs"]).reshape(-1, 2))
    P = len(np.asarray(tables["part_mass"]))
    Kf, Kp, Ke = 8 * G, 16 * NP, NP
    K = Kf + Kp + Ke
    return {"P": P, "Kf": Kf, "Kp": Kp, "Ke": Ke, "K": K, "E": K + Kp + Ke}


def ops_per_env(tables, solver_iters: int, n: int) -> int:
    """FP32 operations for one env in a launch of ``n`` substeps."""
    c = lanes(tables)
    P, Kf, Kp, Ke, K, E = c["P"], c["Kf"], c["Kp"], c["Ke"], c["K"], c["E"]
    Eb = E - K
    Kb = Kp + Ke
    parts = P * (QROT + 3 + QMAT + 2 * MAT3)            # 1. COM, R I R^T
    aggr = P * (P * 51 + 3 + INV3 + 3)                  # 2. group sums, inverse
    narrow = (                                          # 3. narrow phase
        Kf * (QROT + 4)
        + Kp * (4 * QROT + QMUL + 3 + 14 + 6 + 6)
        + Ke * (2 * QMUL + 2 * QROT + 6 + SAT)
    )
    prep = K * PREP_LANE                                # 3. solver prep
    counts = Ke * 16 + E + P * 5 + K * 12               # 4.-6.
    apply = E * APPLY_ENTRY + Eb * 3 + P * APPLY_PART   # 7. group velocities
    update = K * UPDATE_LANE + Kb * 15                  # 7. lambda update
    final = apply + P * INTEGRATE                       # 7. last pass
    floor = Kf * (QROT + 5) + P * P                     # 8. floor projection
    per_substep = (parts + aggr + narrow + prep + counts + solver_iters * (apply + update)
                   + final + floor)
    return int(n * per_substep)


def work(tables, solver_iters: int, B: int, n: int):
    """``(ops, bytes)`` of one launch of ``n`` substeps over ``B`` envs."""
    c = lanes(tables)
    P, K = c["P"], c["K"]
    nbytes = B * P * 4 * (13 + 1 + 1) + B * P * 4 * 13 + 4 * (13 * P + 22 * K)
    return ops_per_env(tables, solver_iters, n) * B, nbytes


def call_work(ref_env, solver_iters: int, args):
    """The work of one call of the port's launch method
    ``MegaPhysics.kernel_substeps(parts, group, gscale, n)``."""
    parts, n = args[0], args[3]
    return work(ref_env.tables, solver_iters, parts[0].shape[0], n)
