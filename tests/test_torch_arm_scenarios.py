"""PyTorch port: arm env scenarios on the port alone (CPU, no JAX compile).

Mirrors of ``tests/test_arm_env.py`` (reset, zero action, observation
layout, instability guard, one step of every ported control type) at B = 2
with ``SimConfig(control_freq=100)``, plus the vectorized entry point and
the snapshot restore. The physics is the arm kernel's plain version.
"""

import numpy as np
import pytest
import torch

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

B = 2
FAST = SimConfig(control_freq=100)


def make(control_type="ik", agent="Sawyer", **kw):
    return ArmEnv(EnvConfig(agent_type=agent, control_type=control_type, sim=FAST, **kw), device="cpu")


@pytest.fixture(scope="module")
def env():
    return make("ik")


@pytest.fixture(scope="module")
def reset_state(env):
    return env.reset_batch(B, torch.Generator().manual_seed(0))


def all_finite(tree):
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, tuple):
        return all(all_finite(v) for v in tree)
    return bool(torch.isfinite(tree.to(torch.float32)).all())


def test_reset_finite(env, reset_state):
    s = reset_state
    assert all_finite(s)
    # arm init pose and open gripper; every part its own group
    np.testing.assert_allclose(
        s.qpos[:, :7].numpy(), np.tile([-0.28, -0.60, 0.00, 1.86, 0.00, 0.3, 1.57], (B, 1)), atol=1e-5
    )
    assert (s.group == torch.arange(env._P, dtype=torch.int32)).all()
    assert not s.touch_l.any() and (s.t == 0).all()
    hand, _ = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    assert torch.allclose(s.ik_target_pos[:, 0], hand)


def test_zero_action_holds(env, reset_state):
    s = reset_state
    a = torch.zeros(B, env.dof)
    for _ in range(3):
        s, obs, rew, done, info = env.step_batch(s, a)
    drift = (s.qpos[:, :7] - reset_state.qpos[:, :7]).abs().max()
    assert drift < 5e-3, f"arm drifted {drift}"
    assert (s.t == 3).all() and not done.any()


def test_ik_moves_eef(env, reset_state):
    s = reset_state
    p0, _ = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    a = torch.zeros(B, env.dof)
    a[:, 2] = 1.0
    for _ in range(5):
        s, *_ = env.step_batch(s, a)
    p1, _ = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    # 5 control steps of 30 ms each at the +-1 rad/s velocity clip
    assert ((p1 - p0)[:, 2] > 0.01).all(), (p1 - p0)[:, 2]


def test_observation_layout(env, reset_state):
    obs = env.observe(reset_state)
    # ik robot_ob: gripper_qpos(2) + eef_pos(3) + eef_quat(4) + velp(3) + velr(3)
    assert obs["robot_ob"].shape == (B, 15)
    assert obs["object_ob"].shape == (B, env.model.n_parts * 7)
    imp = make("impedance")
    assert imp.dof == 9
    s = imp.reset_batch(B, torch.Generator().manual_seed(1))
    assert imp.observe(s)["robot_ob"].shape == (B, 7 + 7 + 15)
    sub = make("ik", subtask_ob=True)
    assert sub.observe(reset_state)["subtask_ob"].shape == (B, 2)


def test_arm_instability_guard(env, reset_state):
    """NaN qpos / flung parts are contained: the lane is sanitized,
    penalized and done; the other lane is untouched."""
    s = reset_state
    qpos = s.qpos.clone()
    qpos[0, 0] = float("nan")
    pos = s.parts.pos.clone()
    pos[0, 0, 2] = 50.0
    bad = s._replace(qpos=qpos, parts=s.parts._replace(pos=pos))
    s2, obs, rew, done, info = env.step_batch(bad, torch.zeros(B, env.dof))
    assert info["unstable"].tolist() == [True, False]
    assert done.tolist() == [True, False]
    assert rew[0] < 0 and rew[1] > -1
    assert all_finite(s2) and all_finite(obs)
    assert (s2.qvel[0] == 0).all()


@pytest.mark.parametrize("control_type", ["ik", "ik_quaternion", "impedance", "torque"])
def test_every_ported_control_type_steps(control_type):
    """Every ported control mode steps with a full-range action and keeps
    the state finite."""
    env = make(control_type)
    s = env.reset_batch(B, torch.Generator().manual_seed(0))
    a = torch.as_tensor(np.random.RandomState(0).uniform(-1, 1, (B, env.dof)).astype(np.float32))
    s2, obs, rew, done, info = env.step_batch(s, a)
    assert all_finite(s2) and all_finite(obs) and all_finite(rew)
    assert not info["unstable"].any()
    assert (s2.qpos != s.qpos).any()
    lo = torch.as_tensor(env.robot.jnt_range[:, 0], dtype=torch.float32)
    hi = torch.as_tensor(env.robot.jnt_range[:, 1], dtype=torch.float32)
    assert ((s2.qpos >= lo) & (s2.qpos <= hi)).all()


def test_baxter_bimanual_steps():
    env = make("ik", agent="Baxter")
    assert env.dof == 15 and env.physics.K == 1610
    s = env.reset_batch(B, torch.Generator().manual_seed(3))
    s, obs, rew, done, info = env.step_batch(s, torch.zeros(B, env.dof))
    assert all_finite(s) and s.touch_l.shape == (B, 2, env.model.n_parts)
    assert obs["robot_ob"].shape == (B, 30)


def test_vec_env_and_single_env_views():
    """``make_vec_env("IKEASawyer-v0", ...)`` on the CPU, and the B = 1
    views of reset and step."""
    vec = ft.make_vec_env("IKEASawyer-v0", B, device="cpu", control_type="impedance", sim=FAST)
    assert isinstance(vec.env, ArmEnv) and vec.env.config.agent_type == "Sawyer"
    obs = vec.reset()
    obs, rew, done, info = vec.step(torch.zeros(B, vec.env.dof))
    assert rew.shape == (B,) and obs["robot_ob"].shape == (B, 29)
    env = vec.env
    s = env.reset(torch.Generator().manual_seed(0))
    assert s.qpos.shape == (env.robot.nj,)
    s, obs, rew, done, info = env.step(s, torch.zeros(env.dof))
    assert s.parts.pos.shape == (env._P, 3) and rew.shape == ()


def test_restore_snapshot(env, reset_state):
    """A recorded demo state overwrites the dynamic fields and refreshes
    the IK target at the restored hand pose."""
    s = reset_state
    qpos = s.qpos[0].numpy().copy()
    qpos[1] -= 0.3
    snap = {
        "parts_pos": s.parts.pos[1].numpy() + 0.01,
        "parts_quat": s.parts.quat[1].numpy(),
        "parts_lin_vel": np.zeros((env._P, 3), np.float32),
        "parts_ang_vel": np.zeros((env._P, 3), np.float32),
        "qpos": qpos,
        "qvel": np.zeros(env.robot.nj, np.float32),
        "group": np.array([0, 1, 2, 3, 0], np.int32),
        "weld_active": np.zeros(env._W, bool),
        "conn_connected": np.zeros(env._C, bool),
        "num_connected": np.int32(1),
    }
    r = env.restore_snapshot(s, snap)
    assert r.group.tolist() == [[0, 1, 2, 3, 0]] * B and r.num_connected.tolist() == [1] * B
    assert torch.allclose(r.qpos, torch.as_tensor(qpos).expand(B, -1))
    hand, _ = K.eef_pose(env.robot, K.fk(env.robot, r.qpos), "right")
    assert torch.allclose(r.ik_target_pos[:, 0], hand)
    assert (r.ik_target_pos[:, 0, 2] > s.ik_target_pos[:, 0, 2]).all()
