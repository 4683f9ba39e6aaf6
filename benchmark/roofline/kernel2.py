"""Kernel 2, the arm kernel (``arm_control_step_kernel``): its work per
launch, frozen from ``ArmMegaPhysics.fp32_ops_per_env`` as the benchmark was
defined.

Counted as kernel 1's (``kernel1.py``) with the robot's phases once a
substep: forward kinematics, hand-geom frames and velocities, the robot
lanes of ``collide.robot_contacts`` beside the part lanes, the gripper
gates, the contact reaction on the joints and the joint update (tanh counts
one). The bytes: parts, group, gravity scale, joints, controls, torques and
the two joint matrices in; parts, joints and the touch flags out; the
model's and the robot's constant tables once.
"""

from __future__ import annotations

import numpy as np

from .kernel1 import (
    APPLY_ENTRY, APPLY_PART, CROSS, INTEGRATE, INV3, MAT3, PREP_LANE, QMAT, QMUL, QROT, SAT,
    UPDATE_LANE, lanes,
)

PATTERN = "arm_control_step_kernel"
HINGE = 0   # robots/chain.py: the joint type of a hinge (1: a slide)


def arm_counts(tables, robot) -> dict:
    """Lane and robot counts of an (arm, furniture) model."""
    c = lanes(tables)
    rpairs = np.asarray(tables["_robot_pairs"]).reshape(-1, 2)
    L = len(np.asarray(tables["_rl_rgeom"]))
    hand = list(dict.fromkeys(rpairs[:, 0].tolist()))
    Kr = 2 * L
    K = c["K"] + Kr
    return dict(
        P=c["P"], Kf=c["Kf"], Kp=c["Kp"], Ke=c["Ke"], L=L, Kr=Kr, K=K,
        E=K + c["Kp"] + c["Ke"], NJ=int(robot.nj), NA=int(robot.na), NB=int(robot.nb),
        NRG=len(hand), n_arms=len(robot.arms),
        n_hinge=int(np.sum(np.asarray(robot.jnt_type) == HINGE)),
        anc=int(robot.ancestor[robot.geom_body[np.asarray(hand)]].sum()),
    )


def ops_per_env(tables, robot, solver_iters: int, n: int) -> int:
    """FP32 operations for one env in a launch of ``n`` substeps."""
    c = arm_counts(tables, robot)
    P, Kf, Kp, Ke, Kr, K = c["P"], c["Kf"], c["Kp"], c["Ke"], c["Kr"], c["K"]
    NJ, NA, NB, NRG, L = c["NJ"], c["NA"], c["NB"], c["NRG"], c["L"]
    E = c["E"]
    Eb = E - K
    Kpe = Kp + Ke
    n_hinge, anc = c["n_hinge"], c["anc"]
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
        + L * (QROT + 3 + box + 1)
        + L * (2 * QROT + QMUL + 6 + box + 4)
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
        + solver_iters * (apply + update) + final + floor + geom_ft + joints
    )
    return int(n * per_substep)


def work(tables, robot, solver_iters: int, B: int, n: int):
    """``(ops, bytes)`` of one launch of ``n`` substeps over ``B`` envs."""
    c = arm_counts(tables, robot)
    P, NJ, NA, NB, NRG, K = c["P"], c["NJ"], c["NA"], c["NB"], c["NRG"], c["K"]
    NT = 2 * c["n_arms"] * P
    b_in = B * 4 * (P * (13 + 1 + 1) + 2 * NJ + NA + NJ + 2 * NJ * NJ)
    b_out = B * (4 * (P * 13 + 2 * NJ) + NT)
    b_tables = 4 * (13 * P + 22 * K + 13 * NB + 10 * NJ + 7 * NRG + NRG * NJ + 5 * NA)
    return ops_per_env(tables, robot, solver_iters, n) * B, b_in + b_out + b_tables


def call_work(ref_env, solver_iters: int, args):
    """The work of one call of the port's launch method
    ``ArmMegaPhysics.kernel_control_step(parts, group, gscale, qpos, qvel,
    ctrl, tau_extra, G1, G2, n)``."""
    parts, n = args[0], args[9]
    return work(ref_env.tables, ref_env.robot, solver_iters, parts[0].shape[0], n)
