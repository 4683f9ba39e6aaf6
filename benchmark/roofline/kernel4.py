"""Kernel 4, the joint-dynamics kernel (``arm_dyn_matrices_kernel``): its
work per launch, frozen from the joint-dynamics function as the kernel was
defined.

The count is of the function for one env (each add, multiply, divide, square
root, max, sin and cos counts one; index arithmetic does not): the chain's
forward kinematics, the bodies' and joints' world frames, the mass matrix's
upper triangle over the bodies both joints move, the Cholesky factorisation
of A = M + dt·diag(D), the NJ substitutions and G1 = A⁻¹M, G2 = dt·A⁻¹. The
bytes: qpos in, G1 and G2 out, and the robot's constant tables once (body
[NB, 23] and [NB, 5] words, joint [NJ, 8] and [NJ, 2], the triangle's
NJ(NJ+1)/2 index pairs).
"""

from __future__ import annotations

import functools

import numpy as np

PATTERN = "arm_dyn_matrices_kernel"
HINGE = 0   # robots/chain.py: the joint type of a hinge (1: a slide)
QROT, QMUL = 30, 28
BODY_WORDS, JNT_WORDS = 23 + 5, 8 + 2


def ops_per_env(robot) -> int:
    """FP32 operations for one env of one launch."""
    nb, nj = int(robot.nb), int(robot.nj)
    hinge = np.asarray(robot.jnt_type) == HINGE
    bj = np.asarray(robot.body_joint)
    parent = np.asarray(robot.parent)
    chain = sum(
        (0 if parent[b] < 0 else QROT + 3 + QMUL)
        + (0 if bj[b] < 0 else (4 + QMUL + 2 * QROT + 6 if hinge[bj[b]] else QROT + 6))
        for b in range(nb)
    )
    frames = nb * (QROT + 3 + 13 + 39 + 90) + nj * (2 * QROT + 3)
    mass = 2 * nj                                                   # armature, dt·D
    for b in range(nb):
        js = np.flatnonzero(np.asarray(robot.ancestor)[b])
        for a, k in enumerate(js):
            for j in js[a:]:
                mass += 12 * (hinge[k] + hinge[j]) + 7 + (21 if hinge[k] and hinge[j] else 0)
    chol = sum(1 + (nj - k - 1) + (nj - k - 1) * (nj - k) for k in range(nj))
    solve = sum((nj - c) ** 2 + nj * nj for c in range(nj))
    return int(chain + frames + mass + chol + solve + nj * nj * (2 * nj + 1))


def work(robot, B: int):
    """``(ops, bytes)`` of one launch over ``B`` envs."""
    nb, nj = int(robot.nb), int(robot.nj)
    tables = 4 * (BODY_WORDS * nb + JNT_WORDS * nj + nj * (nj + 1) // 2)
    return ops_per_env(robot) * B, B * 4 * (nj + 2 * nj * nj) + tables


@functools.lru_cache(maxsize=None)
def _env_work(ref_env, B: int):
    return work(ref_env.robot, B)


def call_work(ref_env, solver_iters: int, args):
    """The work of one call of the port's launch method
    ``ArmDynamics.matrices(qpos)``: counted once for each batch size, since
    the count walks the chain in Python and is logged inside the traced
    step's ``ft.env.dynamics`` span."""
    return _env_work(ref_env, args[0].shape[0])
