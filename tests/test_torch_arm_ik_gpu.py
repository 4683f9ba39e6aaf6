"""PyTorch port: the IK kernel against float64 truth, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_arm_ik_gpu.py

For each arm agent and both IK control types, at B = 256 with inputs drawn
by numpy as an env meets them (joint positions within 0.3 rad of the
robot's initial pose, targets within 5 cm and 10 degrees of the hand,
actions in [-1, 1], the ``ik_quaternion`` deltas within ~11 degrees of the
identity): the kernel's ``ik_target_pos``, ``hand_quat_init`` and ``q_cmd``
no further from the truth (the plain version, ``controllers/ik.py::
ik_prepare``, in float64 on the CPU) than 4x the plain float32 path on the
card, by the rows' 90th percentile of their largest gap (a converged DLS
solve carries ~5e-4 rad of noise from ``arccos`` near 1 in either path);
and at this batch equal to the plain float32 path bit for bit (the
kernel rounds each operation as PyTorch's CUDA op does; the 20-iteration
solve turns any other rounding into ~1e-3 rad, ``arccos`` near 1); two
launches bit-identical; the launch, and the control span of an ik step
(the IK kernel, then ``action_repeat`` joint P-controls), make no host
synchronisation; one ik step adds one launch of the IK kernel and
``action_repeat`` of the arm kernel.
"""

import numpy as np
import pytest
import torch
from torch_gpu_holds import card, float64_twin, p90_gap

from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.controllers.ik import ik_prepare
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.robots import AGENT_SPECS
from furniture_tpu_torch.robots import kinematics as K

B = 256
PLAIN_FACTOR = 4.0


def ik_inputs(r, width: int, n: int, seed: int):
    """``(qpos, ik_target_pos, hand_quat_init, action)`` for ``n`` envs of
    robot ``r`` on the CPU, as an env meets them."""
    rng = np.random.default_rng(seed)
    A = len(r.arms)
    q = np.asarray(r.init_qpos, np.float64) + rng.uniform(-0.3, 0.3, (n, r.nj))
    q = torch.as_tensor(np.clip(q, r.jnt_range[:, 0], r.jnt_range[:, 1]).astype(np.float32))
    fk_out = K.fk(r, q)
    poses = [K.eef_pose(r, fk_out, arm) for arm in r.arms]
    hand = torch.stack([p[0] for p in poses], 1)
    tpos = hand + torch.as_tensor(rng.uniform(-0.05, 0.05, (n, A, 3)).astype(np.float32))
    deg = torch.as_tensor(rng.uniform(-10, 10, (n, A, 3)).astype(np.float32))
    hqi = T.quat_normalize(T.euler_to_quat(deg, torch.stack([p[1] for p in poses], 1)))
    act = rng.uniform(-1, 1, (n, width * A + A + 1)).astype(np.float32)
    if width == 7:
        for i in range(A):
            act[:, 7 * i + 3] = 1.0
            act[:, 7 * i + 4 : 7 * i + 7] = rng.uniform(-0.1, 0.1, (n, 3))
    return q, tpos, hqi, torch.as_tensor(act)


@pytest.mark.gpu
@pytest.mark.parametrize("control_type", ["ik", "ik_quaternion"])
@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_ik_kernel(agent, control_type, monkeypatch):
    card(monkeypatch)
    env = ArmEnv(EnvConfig(agent_type=agent, control_type=control_type), device="cuda")
    r, ik = env.robot, env.ik
    cpu_ins = ik_inputs(r, ik.width, B, seed=len(agent) + ik.width)
    ins = [x.cuda() for x in cpu_ins]

    launches = ik.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ik.prepare(*ins)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ik.launches == launches + 1
    box = [b.cpu() for b in ik.box]
    plain = ik_prepare(r, control_type, ik.move_speed, ik.rotate_speed, *ik.box, *ins)
    truth = ik_prepare(float64_twin(r), control_type, ik.move_speed, ik.rotate_speed,
                       *(b.double() for b in box), *(x.double() for x in cpu_ins))
    for name, g, p, t in zip(("ik_target_pos", "hand_quat_init", "q_cmd"), got, plain, truth):
        assert g.shape == p.shape
        err, plain_err = p90_gap(g, t), p90_gap(p, t)
        assert err <= PLAIN_FACTOR * plain_err, (name, err, plain_err)
        # at this batch every operation rounds as the plain version's does
        assert torch.equal(g, p), (name, (g - p).abs().max().item())
    again = ik.prepare(*ins)
    assert all(torch.equal(a, b) for a, b in zip(got, again))    # no atomics: one order


@pytest.mark.gpu
@pytest.mark.parametrize("control_type", ["ik", "ik_quaternion"])
@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_ik_step_launches_once_and_never_syncs(agent, control_type):
    """One ik ``step_batch`` launches the IK kernel once and the arm kernel
    ``action_repeat`` times; its control span runs under
    ``set_sync_debug_mode("error")``."""
    card()
    env = ArmEnv(EnvConfig(agent_type=agent, control_type=control_type), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = env.reset_batch(B, gen)
    action = torch.rand((B, env.dof), generator=gen, device="cuda") * 2 - 1
    ik_launches, arm_launches = env.ik.launches, env.physics.launches
    env.step_batch(state, action)
    assert env.ik.launches == ik_launches + 1
    assert env.physics.launches == arm_launches + env.config.action_repeat
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s2, q_cmd, grip = env._ik_prepare(state, action)
        for _ in range(env.config.action_repeat):
            env._ik_ctrl(s2.qpos, q_cmd, grip)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for t in (s2.ik_target_pos, s2.hand_quat_init, q_cmd):
        assert bool(torch.isfinite(t).all())
