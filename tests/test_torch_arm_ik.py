"""PyTorch port: the IK kernel's wrapper (``controllers/ik.py::ArmIK``) on
the CPU, for every arm agent (numpy and torch only; no JAX).

The kernel itself runs only on the card (``test_torch_arm_ik_gpu.py``).
Here: the tables the wrapper packs for it, held against the
``CompiledRobot`` they come from; the wrapper's CPU route, which is the
plain version and must return, bit for bit, what the arm env's IK control
step returned before the kernel existed (a frozen copy of that method
below); the env's use of it; and its refusal of inputs of another shape,
type or device, of another control type and of a robot beyond the
kernel's limits.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.controllers.ik import (
    MAX_ARMS,
    MAX_CHAIN,
    MAX_NA,
    ArmIK,
    dls_ik,
)
from furniture_tpu_torch.convert import arm_state_to_numpy
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.robots import AGENT_SPECS, compile_robot
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

B = 3
MOVE, ROTATE = 0.1, 22.5
BOX_LO = np.array([-1.5, -1.5, 0.0], np.float32)
BOX_HI = np.array([1.5, 1.5, 1.5], np.float32)


def frozen_ik_prepare(r, control_type, qpos, ik_target_pos, hand_quat_init, action):
    """``ArmEnv._ik_prepare``'s arithmetic as it stood before the IK kernel,
    word for word (the env's fields as arguments): ``(ik_target_pos,
    hand_quat_init, q_cmd)``."""
    min_gripper_pos, max_gripper_pos = torch.as_tensor(BOX_LO), torch.as_tensor(BOX_HI)
    aw = 7 if control_type == "ik_quaternion" else 6
    new_tpos, new_hqi = [], []
    q_cmd = qpos
    fk_out = K.fk(r, qpos)
    for i, arm in enumerate(r.arms):
        a = action[:, aw * i : aw * i + aw]
        move = a[:, :3] * MOVE
        hand_pos, hand_quat = K.eef_pose(r, fk_out, arm)
        dpos = torch.minimum(
            torch.maximum(move, min_gripper_pos - hand_pos),
            max_gripper_pos - hand_pos,
        )
        if control_type == "ik_quaternion":
            dq_in = T.quat_normalize(a[:, 3:7])
            dq_in = torch.where(dq_in[:, 0:1] < 0, -dq_in, dq_in)
            hqi = T.quat_normalize(T.quat_mul(hand_quat, dq_in))
        else:
            hqi = T.quat_mul(
                hand_quat_init[:, i],
                T.euler_to_quat(0.3 * a[:, 3:6] * ROTATE),
            )
            hqi = T.quat_normalize(hqi)
        dq = T.quat_mul(hqi, T.quat_inv(hand_quat))
        dq = torch.where(dq[:, 0:1] < 0, -dq, dq)
        ang = 2.0 * torch.arccos(torch.clamp(dq[:, 0], -1.0, 1.0))
        frac = torch.clamp((math.pi / 4) / torch.clamp(ang, min=1e-6), max=1.0)
        hqi = T.quat_slerp(hand_quat, hqi, frac)
        tpos = ik_target_pos[:, i] + 0.3 * dpos
        err = tpos - hand_pos
        err_n = torch.linalg.norm(err, dim=-1, keepdim=True)
        tpos = hand_pos + err * torch.clamp(0.15 / torch.clamp(err_n, min=1e-6), max=1.0)
        q_cmd = dls_ik(r, arm, q_cmd, tpos, hqi)
        new_tpos.append(tpos)
        new_hqi.append(hqi)
    return torch.stack(new_tpos, 1), torch.stack(new_hqi, 1), q_cmd


def ik_inputs(r, width: int, n: int, seed: int):
    """numpy-drawn IK inputs for ``n`` envs of robot ``r``: joint positions
    within the joint ranges (unlimited ones within +-2), targets within
    0.2 m of the hand, unit target quats, actions in [-1, 1] of the env's
    width (the per-arm blocks, the gripper scalars and connect)."""
    rng = np.random.default_rng(seed)
    A = len(r.arms)
    lo = np.maximum(r.jnt_range[:, 0], -2.0)
    hi = np.minimum(r.jnt_range[:, 1], 2.0)
    q = torch.as_tensor(rng.uniform(lo, hi, size=(n, r.nj)).astype(np.float32))
    fk_out = K.fk(r, q)
    hand = torch.stack([K.eef_pose(r, fk_out, arm)[0] for arm in r.arms], 1)
    tpos = hand + torch.as_tensor(rng.uniform(-0.2, 0.2, (n, A, 3)).astype(np.float32))
    quat = rng.normal(size=(n, A, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    act = rng.uniform(-1, 1, (n, width * A + A + 1)).astype(np.float32)
    return q, tpos, torch.as_tensor(quat), torch.as_tensor(act)


@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_ik_tables(agent):
    """Each hand chain is root-first, parent before child, and ends at the
    hand body; its rows are the bodies' and joints' constants; the arm
    joints are the ones ``dls_ik`` moves, each at its body's place on the
    chain, with ``robot_tables``' ranges."""
    r = compile_robot(agent)
    t = ArmIK(r, "ik", MOVE, ROTATE, BOX_LO, BOX_HI, "cpu").tables
    rt = K.robot_tables(r, "cpu")
    A = len(r.arms)
    assert t["chain_f"].shape == (A, MAX_CHAIN, 16) and t["chain_i"].shape == (A, MAX_CHAIN, 3)
    assert t["arm_f"].shape == (A, MAX_NA, 8) and t["arm_i"].shape == (A, MAX_NA, 3)
    for i, arm in enumerate(r.arms):
        nc, na = t["arm_n"][i]
        bodies = t["chain_i"][i, :nc, 0]
        assert bodies[-1] == r.eef_body[arm] and r.parent[bodies[0]] == -1
        assert all(r.parent[bodies[c]] == bodies[c - 1] for c in range(1, nc))
        assert np.all(t["chain_i"][i, nc:] == -1) and np.all(t["chain_f"][i, nc:] == 0)
        assert np.array_equal(t["chain_i"][i, :nc, 1], r.body_joint[bodies])
        f = t["chain_f"][i, :nc]
        assert np.array_equal(f[:, 0:3], np.float32(r.body_pos[bodies]))
        assert np.array_equal(f[:, 3:7], np.float32(r.body_quat[bodies]))
        for c, b in enumerate(bodies):
            j = r.body_joint[b]
            if j >= 0:
                assert t["chain_i"][i, c, 2] == r.jnt_type[j]
                np.testing.assert_allclose(f[c, 7:10], r.jnt_axis[j], atol=1e-7)
                assert np.array_equal(f[c, 10:13], np.float32(r.jnt_axis[j]))
                assert np.array_equal(f[c, 13:16], np.float32(r.jnt_pos[j]))
            else:
                assert t["chain_i"][i, c, 2] == -1 and np.all(f[c, 7:] == 0)
        joints = np.asarray(r.arm_joints[arm])
        assert na == len(joints) and np.array_equal(t["arm_i"][i, :na, 0], joints)
        assert np.all(t["arm_i"][i, na:] == -1)
        for k, j in enumerate(joints):
            c = t["arm_i"][i, k, 1]
            assert (c >= 0) == bool(r.ancestor[r.eef_body[arm], j])
            assert c < 0 or bodies[c] == r.jnt_body[j]
            assert t["arm_i"][i, k, 2] == r.jnt_type[j]
        af = t["arm_f"][i, :na]
        assert np.array_equal(af[:, 0:3], np.float32(r.jnt_axis[joints]))
        assert np.array_equal(af[:, 3:6], np.float32(r.jnt_pos[joints]))
        assert np.array_equal(af[:, 6], rt["lo"][joints].numpy())
        assert np.array_equal(af[:, 7], rt["hi"][joints].numpy())


@pytest.mark.parametrize("control_type", ["ik", "ik_quaternion"])
@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_ik_cpu_route_is_the_old_step(agent, control_type):
    """On CPU tensors the wrapper returns what the env's IK control step
    returned before the kernel, bit for bit, and launches nothing."""
    r = compile_robot(agent)
    ik = ArmIK(r, control_type, MOVE, ROTATE, BOX_LO, BOX_HI, "cpu")
    ins = ik_inputs(r, ik.width, B, seed=len(agent) + ik.width)
    got = ik.prepare(*ins)
    want = frozen_ik_prepare(r, control_type, *ins)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[2].shape == (B, r.nj) and ik.launches == 0
    assert not torch.equal(got[2], ins[0])     # the solve moved the joints


def test_arm_env_ik_prepare_through_the_wrapper():
    """``ArmEnv._ik_prepare`` on the CPU: the wrapper's outputs in the
    state, the gripper scalars after the per-arm blocks, and the same
    numbers as before the kernel; an impedance env has no IK wrapper."""
    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="ik",
                           sim=SimConfig(control_freq=100)), device="cpu")
    state = env.reset_batch(B, torch.Generator().manual_seed(0))
    act = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (B, env.dof)).astype(np.float32))
    s2, q_cmd, grip = env._ik_prepare(state, act)
    tpos, hqi, q_want = frozen_ik_prepare(env.robot, "ik", state.qpos, state.ik_target_pos,
                                          state.hand_quat_init, act)
    assert torch.equal(s2.ik_target_pos, tpos) and torch.equal(s2.hand_quat_init, hqi)
    assert torch.equal(q_cmd, q_want) and torch.equal(grip, act[:, 6:7])
    before, after = arm_state_to_numpy(state), arm_state_to_numpy(s2)
    for k in before:
        if k not in ("ik_target_pos", "hand_quat_init"):
            assert np.array_equal(before[k], after[k]), k
    assert env.ik.launches == 0
    imp = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance",
                           sim=SimConfig(control_freq=100)), device="cpu")
    assert imp.ik is None


def test_arm_ik_refuses():
    """Inputs of another shape, type or device raise, as do a control type
    other than ik and a robot beyond the kernel's limits."""
    r = compile_robot("Baxter")
    ik = ArmIK(r, "ik", MOVE, ROTATE, BOX_LO, BOX_HI, "cpu")
    q, tpos, hqi, act = ik_inputs(r, ik.width, B, seed=0)
    bad = {
        "qpos": [(q[:, :-1], tpos, hqi, act), (q.double(), tpos, hqi, act), (q[0], tpos, hqi, act)],
        "ik_target_pos": [(q, tpos[:, :1], hqi, act), (q, tpos[:2], hqi, act)],
        "hand_quat_init": [(q, tpos, hqi[..., :3], act), (q, tpos, hqi.half(), act)],
        "action": [(q, tpos, hqi, act[:, :11]), (q, tpos, hqi, act.double()),
                   (q, tpos, hqi, act[:2])],
    }
    for name, cases in bad.items():
        for args in cases:
            with pytest.raises(ValueError, match=name):
                ik.prepare(*args)
    meta = [x.to("meta") for x in (q, tpos, hqi, act)]
    for k in range(4):
        args = [(meta[i] if i == k else x) for i, x in enumerate((q, tpos, hqi, act))]
        with pytest.raises(ValueError, match="tables live on cpu"):
            ik.prepare(*args)
    on_meta = ArmIK(r, "ik", MOVE, ROTATE, BOX_LO, BOX_HI, "meta")
    with pytest.raises(RuntimeError, match="no IK for device meta"):
        on_meta.prepare(*meta)
    with pytest.raises(ValueError, match="no IK for control_type"):
        ArmIK(r, "impedance", MOVE, ROTATE, BOX_LO, BOX_HI, "cpu")
    three = dataclasses.replace(r, arms=r.arms + ("right",))
    with pytest.raises(ValueError, match=f"MAX_ARMS = {MAX_ARMS}"):
        ArmIK(three, "ik", MOVE, ROTATE, BOX_LO, BOX_HI, "cpu")
    wide = dataclasses.replace(
        r, arm_joints={**r.arm_joints, "left": list(r.arm_joints["left"]) * 2})
    with pytest.raises(ValueError, match=f"MAX_NA = {MAX_NA}"):
        ArmIK(wide, "ik", MOVE, ROTATE, BOX_LO, BOX_HI, "cpu")
