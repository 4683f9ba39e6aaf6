"""PyTorch port: the joint-dynamics kernel's wrapper on the CPU, for every
arm (numpy and torch only; no JAX).

The kernel itself runs only on the card (``test_torch_arm_dynamics_gpu.py``).
Here: the tables the wrapper packs for it, held against the
``CompiledRobot`` they come from; the wrapper's CPU route, which is the
plain version itself and launches nothing; and its refusal of a robot
beyond the kernel's body and joint limits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from furniture_tpu_torch.physics.arm_dynamics import MAX_NB, MAX_NJ, ArmDynamics
from furniture_tpu_torch.robots import AGENT_SPECS, compile_robot
from furniture_tpu_torch.robots import kinematics as K
from furniture_tpu_torch.robots.chain import HINGE, POSITION, VELOCITY

torch.set_num_threads(1)

B = 3
DT = 0.002


def check_tables(r, t) -> None:
    """The packed tables of robot ``r`` (``ArmDynamics.tables``) against it."""
    nb, nj = r.nb, r.nj
    f32 = lambda a: np.asarray(a, np.float32)
    bf, bi, jf, ji = t["body_f"], t["body_i"], t["jnt_f"], t["jnt_i"]
    assert bf.shape == (nb, 23) and bi.shape == (nb, 5)
    assert jf.shape == (nj, 8) and ji.shape == (nj, 2)
    # topological order: the robot's own body order, a parent before its child
    parent = bi[:, 0]
    assert np.array_equal(parent, r.parent)
    assert np.all(parent < np.arange(nb))
    for b in range(nb):
        d, a = 0, int(r.parent[b])
        while a >= 0:
            d, a = d + 1, int(r.parent[a])
        assert bi[b, 3] == d, b
    assert t["nlev"] == bi[:, 3].max() + 1
    # joints and their types
    assert np.array_equal(bi[:, 1], r.body_joint)
    jt = np.where(r.body_joint >= 0, np.asarray(r.jnt_type)[np.maximum(r.body_joint, 0)], -1)
    assert np.array_equal(bi[:, 2], jt)
    assert np.array_equal(ji[:, 0], r.jnt_body) and np.array_equal(ji[:, 1], r.jnt_type)
    assert set(np.unique(r.jnt_type)) <= {HINGE, 1}
    # ancestor mask: bit j of body b is set iff joint j moves body b
    bits = (bi[:, 4].astype(np.int64) & 0xFFFFFFFF)[:, None] >> np.arange(nj) & 1
    assert np.array_equal(bits.astype(bool), r.ancestor)
    # body constants, and the hinge's unit rotation axis
    assert np.array_equal(bf[:, 0:3], f32(r.body_pos))
    assert np.array_equal(bf[:, 3:7], f32(r.body_quat))
    assert np.array_equal(bf[:, 10:13], f32(r.body_com))
    assert np.array_equal(bf[:, 13], f32(r.body_mass))
    assert np.array_equal(bf[:, 14:23], f32(r.body_inertia).reshape(nb, 9))
    has = r.body_joint >= 0
    assert np.all(bf[~has, 7:10] == 0)
    np.testing.assert_allclose(bf[has, 7:10], r.jnt_axis[r.body_joint[has]], atol=1e-7)
    # joint constants; D at the env's dt: joint damping + velocity-servo kv
    # + dt x position-servo kp, times dt
    assert np.array_equal(jf[:, 0:3], f32(r.jnt_axis))
    assert np.array_equal(jf[:, 3:6], f32(r.jnt_pos))
    assert np.array_equal(jf[:, 6], f32(r.jnt_armature))
    D = np.asarray(r.jnt_damping, np.float64).copy()
    for a in range(r.na):
        kind, gain = int(r.act_kind[a]), float(r.act_gain[a])
        D[r.act_joint[a]] += gain if kind == VELOCITY else DT * gain if kind == POSITION else 0.0
    np.testing.assert_allclose(jf[:, 7], DT * D, rtol=1e-6, atol=0)
    # M's upper triangle, each pair once
    k, j = t["pairs"] & 0xFFFF, t["pairs"] >> 16
    assert np.all(k <= j) and len(set(zip(k, j))) == nj * (nj + 1) // 2


@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_dynamics_tables_cpu_route_and_limits(agent):
    """For both control variants of the arm: the packed tables against the
    robot, and the wrapper's CPU route, exactly ``K.joint_dyn_matrices``
    with no launch. Then a robot with one body more than ``MAX_NB``, and
    one with one joint more than ``MAX_NJ``, is refused by name."""
    rng = np.random.default_rng(0)
    for use_torque in (False, True):
        r = compile_robot(agent, use_torque=use_torque)
        dyn = ArmDynamics(r, DT, "cpu")
        check_tables(r, dyn.tables)
        lo = np.maximum(r.jnt_range[:, 0], -2.0)
        hi = np.minimum(r.jnt_range[:, 1], 2.0)
        q = torch.as_tensor(rng.uniform(lo, hi, size=(B, r.nj)).astype(np.float32))
        G1, G2 = dyn.matrices(q)
        ref1, ref2 = K.joint_dyn_matrices(r, q, DT)
        assert torch.equal(G1, ref1) and torch.equal(G2, ref2)
        assert G1.shape == (B, r.nj, r.nj) and dyn.launches == 0

    r = compile_robot(agent)
    wide = dataclasses.replace(r, parent=np.concatenate([r.parent, np.zeros(MAX_NB + 1 - r.nb, np.int32)]))
    with pytest.raises(ValueError, match=f"MAX_NB = {MAX_NB}"):
        ArmDynamics(wide, DT, "cpu")
    many = dataclasses.replace(r, jnt_body=np.zeros(MAX_NJ + 1, np.int32))
    with pytest.raises(ValueError, match=f"MAX_NJ = {MAX_NJ}"):
        ArmDynamics(many, DT, "cpu")
