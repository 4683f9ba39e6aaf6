"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.physics import engine, lane_solver
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
        again = phys.kernel_substeps(state.parts, group, gscale, 5)
        torch.cuda.synchronize()
        for f, a, b, c in zip(ref._fields, ref, out, again):
            err = (a - b).abs().max().item()
            assert err < 1e-4, (f, err)
            assert torch.equal(b, c), f      # the sums are taken in a fixed order
    assert phys.launches == launches + 4


@pytest.mark.gpu
def test_free_part_kernel_welded_by_connect():
    """table_lack with two recipe steps preassembled (a group of three parts
    beside two free ones), parts dropped onto the floor and pushed: n = 5
    within 1e-4 and n = 50 within 1e-3 of the plain version (TF32 off), two
    launches bit-identical, and the phase-clock build of the same source
    gives the same result and a clock count for every phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    env = CursorEnv(EnvConfig(preassembled=(0, 1)), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, P = 32, env._P
    state = env.reset_batch(B, gen)
    assert len(set(state.group[0].tolist())) < P
    phys = env.physics
    gscale = torch.ones((B, P), device="cuda")
    parts = phys.plain_substeps(state.parts, state.group, gscale, 50)
    parts = parts._replace(lin_vel=parts.lin_vel + 0.05, ang_vel=parts.ang_vel + 0.1)
    parts = PartState(*(t.contiguous() for t in parts))
    for n, tol in ((5, 1e-4), (50, 1e-3)):
        ref = phys.plain_substeps(parts, state.group, gscale, n)
        out = phys.kernel_substeps(parts, state.group, gscale, n)
        again = phys.kernel_substeps(parts, state.group, gscale, n)
        torch.cuda.synchronize()
        for f, a, b, c in zip(ref._fields, ref, out, again):
            assert (a - b).abs().max().item() < tol, (f, n)
            assert torch.equal(b, c), (f, n)
    launches = phys.launches
    clocks = phys.phase_clocks(parts, state.group, gscale, 5)
    torch.cuda.synchronize()
    assert phys.launches == launches           # a measuring aid, not a launch of the path
    assert clocks.shape[0] == B and bool((clocks[:, :6] > 0).all())
    # the last column counts the block barriers of the substep loop: after the
    # frames, after the narrow phase, after the lane half of each of the 13
    # passes and after the group half of all but the last, 5 substeps
    assert bool((clocks[:, -1] == 5 * 27).all())
    assert phys.resident_blocks() >= 1


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
        again = ph.kernel_control_step(*args)
        torch.cuda.synchronize()
        for a, b in list(zip(ref[0], out[0])) + [(ref[1], out[1]), (ref[2], out[2])]:
            assert (a - b).abs().max().item() < 5e-4
        assert torch.equal(ref[3], out[3])
        assert bool(out[3].any()) == want_touch
        # the sums are taken in a fixed order: a repeated launch gives the same bits
        for b, c in zip(list(out[0]) + list(out[1:]), list(again[0]) + list(again[1:])):
            assert torch.equal(b, c)
    assert ph.launches == launches + 4


@pytest.mark.gpu
def test_arm_kernel_welded_group():
    """Sawyer over table_lack with two recipe steps preassembled (a welded
    group of three parts), part 0 on the left fingertip and the gripper
    closing: one substep within 5e-4 of the plain version in every env (TF32
    off), touch flags equal and set, two launches bit-identical; the
    phase-clock build counts every phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance", preassembled=(0, 1)),
                 device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B = 32
    st = env.reset_batch(B, gen)
    assert len(set(st.group[0].tolist())) < env._P
    tip = K.geom_world(env.robot, K.fk(env.robot, st.qpos))[0][
        :, int(env.robot.finger_geoms_l[env.arms[0]][-1])
    ]
    pos = st.parts.pos.clone()
    pos[:, 0] = tip + torch.tensor([0.004, 0.003, 0.002], device=dev)
    st = st._replace(parts=st.parts._replace(pos=pos))
    act = torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1
    act[:, -1 - env.n_arms : -1] = -1.0
    ctrl = env._direct_ctrl(act[:, :-1])
    ph = env.physics
    G1, G2 = K.joint_dyn_matrices(env.robot, st.qpos, env.config.sim.timestep)
    args = (
        PartState(*(t.contiguous() for t in st.parts)), st.group,
        torch.ones((B, env._P), device=dev), st.qpos, st.qvel, ctrl,
        torch.zeros((B, env.robot.nj), device=dev), G1.contiguous(), G2.contiguous(), 1,
    )
    ref = ph.plain_control_step(*args)
    out = ph.kernel_control_step(*args)
    again = ph.kernel_control_step(*args)
    torch.cuda.synchronize()
    for a, b in list(zip(ref[0], out[0])) + [(ref[1], out[1]), (ref[2], out[2])]:
        assert (a - b).abs().max().item() < 5e-4
    assert torch.equal(ref[3], out[3]) and bool(out[3].any())
    for b, c in zip(list(out[0]) + list(out[1:]), list(again[0]) + list(again[1:])):
        assert torch.equal(b, c)
    clocks = ph.phase_clocks(*args)
    torch.cuda.synchronize()
    assert clocks.shape[0] == B and bool((clocks[:, :6] > 0).all())
    # barriers of the loop: the free-part kernel's 27 a substep, one after
    # the hand-geom forces, and the one after the last joint update
    assert bool((clocks[:, -1] == 28 + 1).all())
    assert ph.resident_blocks() >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["table_lack_0825", "chair_balser_0115"])
def test_lane_solver_kernel_matches_plain(name):
    """The lane solver's kernel against its plain version at B = 32 (TF32
    off) on the contacts of a reset dropped onto the floor with the parts
    pushed along and into it: 12 and 24 sweeps within 1e-4 on both
    velocities, two launches bit-identical, one launch counted per call.
    table_lack (K = 210) keeps a lane per thread in registers,
    chair_balser_0115 (K = 4153) keeps its prepared lanes in a global
    scratch buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    env = CursorEnv(EnvConfig(furniture_name=name, sim=SimConfig(use_pallas="lane")), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B = 32
    st = env.reset_batch(B, gen)
    ones = torch.ones((B, env._P), device=dev)
    parts = env.physics.substeps(st.parts, st.group, ones, 50)
    push = torch.tensor([0.1, 0.1, -0.1], device=dev)
    parts = parts._replace(lin_vel=parts.lin_vel + push, ang_vel=parts.ang_vel + 0.1)
    args = env.physics.solver_args(parts, st.group, ones)
    assert bool(args[0].mask.any())
    tables = env.physics.lane_tables
    for iters in (12, 24):
        a = args[:8] + (iters,) + args[9:]
        before = lane_solver.launches
        lv, av = lane_solver.solve_contacts_lane(*a, tables=tables)
        lv2, av2 = lane_solver.solve_contacts_lane(*a, tables=tables)
        assert lane_solver.launches == before + 2
        rl, ra = lane_solver.plain_solve_contacts_lane(*a)
        torch.cuda.synchronize()
        assert lane_solver.launches == before + 2      # the plain version launches nothing
        assert torch.equal(lv, lv2) and torch.equal(av, av2)
        assert (lv - rl).abs().max().item() < 1e-4
        assert (av - ra).abs().max().item() < 1e-4
        assert (lv - a[5]).abs().max().item() > 1e-3   # the solve did something


def _lane_args(dev, B=32, stack=True, **cfg):
    """Solver arguments of a table_lack reset on the lane backend with leg 0
    laid on the table top, dropped by 50 substeps, then pushed."""
    env = CursorEnv(EnvConfig(sim=SimConfig(use_pallas="lane"), **cfg), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = env.reset_batch(B, gen)
    ones = torch.ones((B, env._P), device=dev)
    parts = st.parts
    if stack:
        pos = parts.pos.clone()
        pos[:, 0] = pos[:, 4] + torch.tensor([0.05, 0.0, 0.02 + 0.015 - 0.002], device=dev)
        parts = parts._replace(pos=pos)
    parts = env.physics.substeps(parts, st.group, ones, 50)
    push = torch.tensor([0.1, 0.1, -0.1], device=dev)
    parts = parts._replace(lin_vel=parts.lin_vel + push, ang_vel=parts.ang_vel + 0.1)
    return env, st.group, env.physics.solver_args(parts, st.group, ones)


@pytest.mark.gpu
def test_lane_solver_kernel_cases():
    """The fused kernel against its plain version at 12 and 24 sweeps within
    1e-4 (TF32 off), two launches bit-identical: table_lack with a leg on
    the table top through both routes, with a non-zero ``vel_b`` on
    every lane (kinematic lanes), with every lane masked (the velocities
    come back exactly), and table_lack welded by connects
    (``preassembled=(0, 1)``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    _, _, args = _lane_args(dev)
    c = args[0]
    assert bool((c.mask & (c.part_b >= 0)).any())
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    vel_b = torch.randn(c.point.shape, generator=gen, device=dev) * 0.05
    env_w, group_w, args_w = _lane_args(dev, stack=False, preassembled=(0, 1))
    assert len(set(group_w[0].tolist())) < env_w._P
    cases = [(args, r) for r in (None, lane_solver.ROUTE_MEMORY)]
    cases += [((c._replace(vel_b=vel_b),) + args[1:], None), (args_w, None)]
    masked = (c._replace(mask=torch.zeros_like(c.mask)),) + args[1:]
    for case, route in cases + [(masked, None)]:
        tables = lane_solver.LaneTables.of(case[0], case[1].shape[1], route)
        for iters in (12, 24):
            a = case[:8] + (iters,) + case[9:]
            lv, av, _ = lane_solver.launch(tables, *a)
            lv2, av2, _ = lane_solver.launch(tables, *a)
            rl, ra = lane_solver.plain_solve_contacts_lane(*a)
            torch.cuda.synchronize()
            assert torch.equal(lv, lv2) and torch.equal(av, av2)
            assert (lv - rl).abs().max().item() < 1e-4, (route, iters)
            assert (av - ra).abs().max().item() < 1e-4, (route, iters)
            if case is masked:
                assert torch.equal(lv, a[5]) and torch.equal(av, a[6])
            else:
                assert (lv - a[5]).abs().max().item() > 1e-3


@pytest.mark.gpu
def test_lane_solver_one_launch_no_prep_no_sync(monkeypatch):
    """On the card ``solve_contacts_lane`` needs the model's tables (it
    raises without them) and is one launch: it never calls
    ``engine.lane_prep``, dispatches no PyTorch operation but the two
    output allocations, and neither it, nor the lane substeps around it,
    nor a whole ``step_batch`` of the lane path synchronises the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from torch.utils._python_dispatch import TorchDispatchMode

    dev = "cuda"
    env, group, args = _lane_args(dev)
    tables = env.physics.lane_tables
    with pytest.raises(ValueError):                  # the card needs the model's tables
        lane_solver.solve_contacts_lane(*args)
    lane_solver.solve_contacts_lane(*args, tables=tables)   # warm-up: the build

    def refuse(*a, **k):
        raise AssertionError("lane_prep ran on the kernel path")

    monkeypatch.setattr(engine, "lane_prep", refuse)
    monkeypatch.setattr(lane_solver, "lane_prep", refuse)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    B, P = group.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    st = env.reset_batch(B, gen)
    action = torch.rand((B, 15), generator=gen, device=dev) * 2 - 1
    env.step_batch(st, action)                      # warm-up of the step's own tables
    ones = torch.ones((B, P), device=dev)
    torch.cuda.synchronize()
    before = lane_solver.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with Ops() as ops:
            lane_solver.solve_contacts_lane(*args, tables=tables)
        # the lane backend's substeps: narrow phase, aggregates, the solve,
        # integration, one launch each; then a whole step of the lane path
        env.physics.substeps(st.parts, st.group, ones, 3)
        env.step_batch(st, action)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert lane_solver.launches == before + 1 + 3 + env.config.n_substeps + 1
    assert len(ops.ops) == 2 and all(op.startswith("aten.empty") for op in ops.ops), ops.ops
