"""PyTorch port: the arm env's grasp and rotation scenarios, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card.
Mirrors of ``tests/test_arm_env.py:111`` (grasp, lift, release), ``:152``
(fast transport keeps the grip), ``:242`` (Baxter grasp and lift) and
``:348`` (``ik_quaternion`` tracks a rotation), with their own bounds, at
their ``SimConfig(control_freq=20, solver_iters=12)``: tens of control
steps through the arm kernel, too long for the CPU plain version. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_arm_env_gpu.py
"""

import math

import numpy as np
import pytest
import torch

FAST_SIM = dict(control_freq=20, solver_iters=12)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the arm kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _env(agent="Sawyer", control_type="ik"):
    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.arm import ArmEnv

    return ArmEnv(EnvConfig(agent_type=agent, control_type=control_type,
                            furniture_name="table_lack_0825", sim=SimConfig(**FAST_SIM)),
                  device=_card())


def _reset(env, seed):
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    return env.reset_batch(1, gen)


def _act(env, **idx):
    a = torch.zeros((1, env.dof), device=env.device)
    for k, v in idx.items():
        a[0, int(k[1:])] = v
    return a


def _steps(env, s, a, n):
    for _ in range(n):
        s = env.step_batch(s, a)[0]
    return s


def _part0_under_grip(env, s, dz=-0.02):
    """Part 0 placed 2 cm under the right grip site (fingertips only)."""
    from furniture_tpu_torch.robots import kinematics as K

    gp, _ = K.site_world(env.robot, K.fk(env.robot, s.qpos), "right")
    pos = s.parts.pos.clone()
    pos[:, 0] = gp + torch.tensor([0.0, 0.0, dz], device=env.device)
    return s._replace(parts=s.parts._replace(pos=pos))


@pytest.mark.gpu
def test_grasp_lift_release():
    """A two-finger friction grasp lifts the part with the hand (> 0.1 m
    in 8 steps) and lets it go when opened (a gap > 0.2 m after 6 more)."""
    from furniture_tpu_torch.robots import kinematics as K

    env = _env()
    s = _part0_under_grip(env, _reset(env, 0))
    s = _steps(env, s, _act(env, a6=1.0), 3)
    assert bool(s.touch_l[0, 0, 0]), "left finger not touching"
    assert bool(s.touch_r[0, 0, 0]), "right finger not touching"
    assert bool(s.touched[0, 0]), "touch bookkeeping missing"

    p0 = s.parts.pos[0, 0].clone()
    s = _steps(env, s, _act(env, a2=1.0, a6=1.0), 8)
    dz = (s.parts.pos[0, 0, 2] - p0[2]).item()
    assert dz > 0.1, f"part not lifted with hand (dz={dz})"
    assert bool(s.picked[0, 0]), "pick bookkeeping missing"

    s = _steps(env, s, _act(env, a6=-1.0, a2=1.0), 6)
    gp2, _ = K.site_world(env.robot, K.fk(env.robot, s.qpos), "right")
    gap = (gp2[0, 2] - s.parts.pos[0, 0, 2]).item()
    assert gap > 0.2, f"part still glued to the hand after release (gap {gap})"


@pytest.mark.gpu
def test_fast_transport_keeps_grip():
    """A pinched part tracks the hand through 6 full-speed lateral steps:
    the hand moves > 0.08 m, both fingers keep touching, and the part's
    displacement stays within 0.06 m of the hand's."""
    from furniture_tpu_torch.robots import kinematics as K

    env = _env()
    s = _part0_under_grip(env, _reset(env, 0))
    s = _steps(env, s, _act(env, a6=1.0), 3)
    s = _steps(env, s, _act(env, a2=1.0, a6=1.0), 4)
    assert bool(s.touch_l[0, 0, 0] & s.touch_r[0, 0, 0])
    h0, _ = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    p0 = s.parts.pos[0, 0].clone()
    s = _steps(env, s, _act(env, a1=1.0, a6=1.0), 6)
    h1, _ = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    dh = (h1 - h0)[0]
    dp = s.parts.pos[0, 0] - p0
    assert torch.linalg.norm(dh).item() > 0.08, f"hand did not transport ({dh})"
    assert bool(s.touch_l[0, 0, 0] & s.touch_r[0, 0, 0]), "part slipped out during fast transport"
    assert torch.linalg.norm(dp - dh).item() < 0.06, f"part did not track the hand: {dh}, {dp}"


@pytest.mark.gpu
def test_baxter_grasp_lift():
    """Baxter's right gripper grasps the part staged between its fingertips
    (re-pinned while the fingers close) and lifts it > 0.08 m in 8 steps."""
    from furniture_tpu_torch.robots import kinematics as K

    env = _env("Baxter")
    s = _reset(env, 1)
    r = env.robot
    gpos, _ = K.geom_world(r, K.fk(r, s.qpos))
    tip_l = gpos[0, int(r.finger_geoms_l["right"][-1])]
    tip_r = gpos[0, int(r.finger_geoms_r["right"][-1])]
    pos = s.parts.pos.clone()
    pos[0, 0] = 0.5 * (tip_l + tip_r)
    s = s._replace(parts=s.parts._replace(pos=pos))
    close = _act(env, a12=1.0)     # ik layout: [right6, left6, grip_right, grip_left, connect]
    for _ in range(3):
        s = _steps(env, s, close, 1)
        s = s._replace(parts=s.parts._replace(pos=pos))
    s = _steps(env, s, close, 2)
    assert bool(s.touch_l[0, 0, 0]), "right-left finger not touching"
    assert bool(s.touch_r[0, 0, 0]), "right-right finger not touching"
    p0 = s.parts.pos[0, 0].clone()
    s = _steps(env, s, _act(env, a2=1.0, a12=1.0), 8)
    dz = (s.parts.pos[0, 0, 2] - p0[2]).item()
    assert dz > 0.08, f"Baxter did not lift the part (dz={dz})"


@pytest.mark.gpu
def test_ik_quaternion_tracks_rotation():
    """A pure-rotation quaternion action (~11 degrees about z, right-
    multiplied) rotates the hand by > 0.05 rad in 5 steps; the gripper slot
    follows the 7-dim arm block."""
    from furniture_tpu_torch import transforms as T
    from furniture_tpu_torch.robots import kinematics as K

    env = _env(control_type="ik_quaternion")
    assert env.dof == 7 + 1 + 1
    s = _reset(env, 0)
    _, hq0 = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    a = torch.zeros((1, env.dof), device=env.device)
    a[0, 3:7] = torch.tensor([math.cos(0.1), 0.0, 0.0, math.sin(0.1)])
    s = _steps(env, s, a, 5)
    _, hq1 = K.eef_pose(env.robot, K.fk(env.robot, s.qpos), "right")
    d = T.quat_mul(hq1, T.quat_inv(hq0))[0]
    ang = 2 * np.arccos(min(1.0, abs(d[0].item())))
    assert ang > 0.05, f"hand only rotated {ang:.3f} rad"
