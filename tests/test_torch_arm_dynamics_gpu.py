"""PyTorch port: the joint-dynamics kernel against float64 truth, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_arm_dynamics_gpu.py

For each arm, in both robot variants (velocity servos, and motors: another
D), at B = 512 with joint positions drawn by numpy within the
joint ranges (unlimited ones within +-2): the kernel's G1 and G2 within
1e-4 of their largest entry of the truth (``K.joint_dyn_matrices`` in
float64 on the CPU; 1e-4 is what ``test_torch_arm_kinematics.py`` holds
the port's G1, G2 to against the JAX package), and no further from it than
4x the plain float32 path on the card; one impedance step adds one launch,
one ik step ``action_repeat`` (3); the dynamics, and the whole control
step, make no host synchronisation.
"""

import numpy as np
import pytest
import torch
from torch_gpu_holds import card, float64_twin

from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.physics.arm_dynamics import ArmDynamics
from furniture_tpu_torch.robots import AGENT_SPECS, compile_robot
from furniture_tpu_torch.robots import kinematics as K

B = 512


def float64_truth(robot, qpos, dt):
    """``K.joint_dyn_matrices`` in float64 on the CPU."""
    return K.joint_dyn_matrices(float64_twin(robot), qpos.cpu().double(), dt)


def gap(x, truth) -> float:
    """Largest gap to the truth over its largest entry."""
    return ((x.cpu().double() - truth).abs().max() / truth.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("use_torque", [False, True])
@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_dynamics_kernel(agent, use_torque):
    card()
    r, dt = compile_robot(agent, use_torque=use_torque), SimConfig().timestep
    dyn = ArmDynamics(r, dt, "cuda")
    rng = np.random.default_rng(0)
    lo = np.maximum(r.jnt_range[:, 0], -2.0)
    hi = np.minimum(r.jnt_range[:, 1], 2.0)
    q = torch.as_tensor(rng.uniform(lo, hi, size=(B, r.nj)).astype(np.float32), device="cuda")

    launches = dyn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        G = dyn.matrices(q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dyn.launches == launches + 1
    plain = K.joint_dyn_matrices(r, q, dt)
    truth = float64_truth(r, q, dt)
    for name, g, p, t in zip(("G1", "G2"), G, plain, truth):
        err, plain_err = gap(g, t), gap(p, t)
        assert err < 1e-4, (name, err)
        assert err <= 4 * plain_err, (name, err, plain_err)
    again = dyn.matrices(q)
    assert all(torch.equal(a, b) for a, b in zip(G, again))    # no atomics: one order


@pytest.mark.gpu
@pytest.mark.parametrize("agent", list(AGENT_SPECS))
def test_arm_step_launches_dynamics_once_a_control_step(agent):
    """One impedance ``step_batch`` launches the kernel once, one ik step
    ``action_repeat`` times; an impedance control step (dynamics and arm
    kernel) runs under ``set_sync_debug_mode("error")``."""
    card()
    gen = torch.Generator(device="cuda")
    for control_type, b in (("impedance", B), ("ik", 16)):
        env = ArmEnv(EnvConfig(agent_type=agent, control_type=control_type), device="cuda")
        gen.manual_seed(0)
        state = env.reset_batch(b, gen)
        action = torch.rand((b, env.dof), generator=gen, device="cuda") * 2 - 1
        launches = env.dynamics.launches
        env.step_batch(state, action)
        want = env.config.action_repeat if control_type == "ik" else 1
        assert env.dynamics.launches == launches + want, control_type
        assert env.physics.launches == want
        if control_type == "impedance":
            ctrl = env._direct_ctrl(action[:, :-1])
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                env._substeps(state, ctrl, None, env.config.n_substeps)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
