"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.physics.state import PartState
from furniture_tpu_torch.robots import kinematics as K


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["table_lack_0825", "chair_balser_0115"])
def test_free_part_kernel_matches_plain(name):
    """n = 5 substeps at B = 32 from a settled reset, free and with parts 0
    and 1 welded plus part 2 gravity-compensated, within 1e-4 (TF32 off).
    chair_balser_0115 (K = 4153) keeps its lane working set in the global
    scratch buffer, table_lack in shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    env = CursorEnv(EnvConfig(furniture_name=name), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, P = 32, env._P
    state = env.reset_batch(B, gen)
    phys = env.physics
    launches = phys.launches
    free = torch.arange(P, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    welded = free.clone()
    welded[:, 1] = 0
    gscale = torch.ones((B, P), device="cuda")
    gscale[:, 2] = 0.0
    for group in (free, welded):
        ref = phys.plain_substeps(state.parts, group, gscale, 5)
        out = phys.kernel_substeps(state.parts, group, gscale, 5)
        torch.cuda.synchronize()
        for f, a, b in zip(ref._fields, ref, out):
            err = (a - b).abs().max().item()
            assert err < 1e-4, (f, err)
    assert phys.launches == launches + 2


@pytest.mark.gpu
@pytest.mark.parametrize("agent", ["Sawyer", "Baxter"])
def test_arm_kernel_matches_plain(agent):
    """The arm kernel against its plain version at B = 32 (TF32 off): from a
    reset with part 0 on the first arm's left fingertip and the grippers
    closing, one substep within 5e-4 with touch flags equal and set (longer
    runs of that stiff contact are ill-conditioned in a few envs; the smoke
    script holds them by their spread); and from the plain reset, without
    contact, 5 substeps within 5e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    env = ArmEnv(EnvConfig(agent_type=agent, control_type="impedance"), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B = 32
    free = env.reset_batch(B, gen)
    tip = K.geom_world(env.robot, K.fk(env.robot, free.qpos))[0][
        :, int(env.robot.finger_geoms_l[env.arms[0]][-1])
    ]
    pos = free.parts.pos.clone()
    # off the fingertip's center: a sample point exactly on a box center
    # ties the least-penetrated axis
    pos[:, 0] = tip + torch.tensor([0.004, 0.003, 0.002], device=dev)
    touching = free._replace(parts=free.parts._replace(pos=pos))
    act = torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1
    act[:, -1 - env.n_arms : -1] = -1.0
    ctrl = env._direct_ctrl(act[:, :-1])
    ph = env.physics
    launches = ph.launches
    for state, n, want_touch in ((touching, 1, True), (free, 5, False)):
        G1, G2 = K.joint_dyn_matrices(env.robot, state.qpos, env.config.sim.timestep)
        args = (
            PartState(*(t.contiguous() for t in state.parts)), state.group,
            torch.ones((B, env._P), device=dev), state.qpos, state.qvel, ctrl,
            torch.zeros((B, env.robot.nj), device=dev), G1.contiguous(), G2.contiguous(), n,
        )
        ref = ph.plain_control_step(*args)
        out = ph.kernel_control_step(*args)
        torch.cuda.synchronize()
        for a, b in list(zip(ref[0], out[0])) + [(ref[1], out[1]), (ref[2], out[2])]:
            assert (a - b).abs().max().item() < 5e-4
        assert torch.equal(ref[3], out[3])
        assert bool(out[3].any()) == want_touch
    assert ph.launches == launches + 2
