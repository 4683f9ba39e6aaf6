"""PyTorch port: Baxter bimanual on swivel_chair_0700 on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The model's lane working set (2560
slots) is over the shared memory a block may have, so kernel 2 keeps it in
its global scratch buffer: the first model that takes that route at its own
widths. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_baxter_swivel_gpu.py
"""

import numpy as np
import pytest
import torch
from torch_gpu_holds import card

import furniture_tpu_torch as ft
from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.physics.state import PartState
from furniture_tpu_torch.robots import kinematics as K

KW = dict(agent_type="Baxter", control_type="impedance", furniture_name="swivel_chair_0700")


@pytest.mark.gpu
def test_arm_kernel_takes_global_scratch_and_matches_plain():
    """B = 32 (TF32 off), as ``test_arm_kernel_matches_plain``: from a reset
    with part 0's first geom on the first arm's left fingertip and both
    grippers closing, one substep within 5e-4 of the plain version with
    touch flags equal and set; from the plain reset, without contact, 5
    substeps within 5e-4. Every launch takes the global-scratch route, and a
    repeated launch gives the same bits."""
    card()
    dev = "cuda"
    env = ArmEnv(EnvConfig(**KW), device=dev)
    ph = env.physics
    nf, smem, in_smem = ph.lane_buffer()
    assert not in_smem and ph.K == 2145 and ph.slots["KS"] == 2560
    assert smem <= ph.smem_limit and ph.resident_blocks() >= 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B = 32
    free = env.reset_batch(B, gen)
    tip = K.geom_world(env.robot, K.fk(env.robot, free.qpos))[0][
        :, int(env.robot.finger_geoms_l[env.arms[0]][-1])
    ]
    # part 0's first geom (the chair's geoms lie off its origin) just off the
    # fingertip's center: a sample point exactly on a box center ties the
    # least-penetrated axis
    g0 = int(np.flatnonzero(np.asarray(env.tables["geom_part"]) == 0)[0])
    gpos = torch.as_tensor(np.asarray(env.tables["geom_pos"], np.float32)[g0], device=dev)
    pos = free.parts.pos.clone()
    pos[:, 0] = (tip + torch.tensor([0.004, 0.003, 0.002], device=dev)
                 - T.quat_rotate(free.parts.quat[:, 0], gpos.expand(B, 3)))
    touching = free._replace(parts=free.parts._replace(pos=pos))
    act = torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1
    act[:, -1 - env.n_arms : -1] = -1.0
    ctrl = env._direct_ctrl(act[:, :-1])
    launches, scratch = ph.launches, ph.scratch_launches
    for state, n, want_touch in ((touching, 1, True), (free, 5, False)):
        G1, G2 = K.joint_dyn_matrices(env.robot, state.qpos, env.config.sim.timestep)
        args = (
            PartState(*(t.contiguous() for t in state.parts)), state.group,
            torch.ones((B, env._P), device=dev), state.qpos, state.qvel, ctrl,
            torch.zeros((B, env.robot.nj), device=dev), G1.contiguous(), G2.contiguous(), n,
        )
        ref = ph.plain_control_step(*args)
        out = ph.kernel_control_step(*args)
        again = ph.kernel_control_step(*args)
        torch.cuda.synchronize()
        for a, b in list(zip(ref[0], out[0])) + [(ref[1], out[1]), (ref[2], out[2])]:
            assert (a - b).abs().max().item() < 5e-4
        assert torch.equal(ref[3], out[3])
        assert bool(out[3].any()) == want_touch
        for b, c in zip(list(out[0]) + list(out[1:]), list(again[0]) + list(again[1:])):
            assert torch.equal(b, c)
    assert ph.launches == launches + 4
    assert ph.scratch_launches == scratch + 4


@pytest.mark.gpu
def test_vec_env_b512_steps_finite():
    """``make_vec_env`` at the benchmark cell's size (B = 512, the default
    ``SimConfig``): a reset and 3 closed-loop steps on random actions stay
    finite, each step one launch of kernel 4 and one of kernel 2, every
    kernel-2 launch on the global-scratch route."""
    card()
    B = 512
    vec = ft.make_vec_env("IKEABaxter-v0", B, seed=2147483659, device="cuda", sim=SimConfig(),
                          control_type="impedance", furniture_name="swivel_chair_0700")
    vec.reset()
    env = vec.env
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for _ in range(3):
        obs, rew, done, info = vec.step(torch.rand((B, env.dof), generator=gen, device="cuda") * 2 - 1)
    torch.cuda.synchronize()
    s = vec.state
    for t in list(s.parts) + [s.qpos, s.qvel, rew] + list(obs.values()):
        if t.is_floating_point():
            assert bool(torch.isfinite(t).all())
    assert not bool(info["unstable"].any())
    assert env.physics.launches == 3 and env.physics.scratch_launches == 3
    assert env.dynamics.launches == 3
    assert obs["robot_ob"].shape == (B, 2 * (7 + 7 + 2 + 3 + 4 + 3 + 3))
