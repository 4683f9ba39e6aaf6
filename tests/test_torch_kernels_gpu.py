"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch
from torch_gpu_holds import arm_args, card, hold_arm, hold_lane, kernel1_gap

from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.physics import engine, lane_solver
from furniture_tpu_torch.physics.state import PartState
from furniture_tpu_torch.robots import kinematics as K


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name,B",
    [pytest.param("table_lack_0825", 256, id="table_lack_0825"),
     pytest.param("chair_balser_0115", 256, id="chair_balser_0115"),
     pytest.param("chair_balser_0115", 1024, id="chair_balser_0115-b1024"),
     pytest.param("toy_table", 64, id="toy_table"),
     pytest.param("bed_dalselv_0270", 64, id="bed_dalselv_0270")],
)
def test_free_part_kernel_matches_plain(name, B):
    """n = 5 substeps at B = 32 from a settled reset, free and with parts 0
    and 1 welded plus part 2 gravity-compensated, within 1e-4 (TF32 off).
    Then at ``B``, free parts with velocities within 1e-4 at n = 5 and 1e-3
    at n = 50; the welded pair at n = 50 within 1e-3 or 10x the plain
    version's own spread under 1e-7 of position noise, the larger (two parts
    welded where they lie apart make one body whose 50-substep motion is
    chaotic). table_lack keeps a lane a thread; chair_balser_0115 (K =
    4153, 3 CTAs), toy_table (the largest model, 5 CTAs) and
    bed_dalselv_0270 (just over one block's shared memory, 2 CTAs) take the
    cluster route in every launch; B = 1024 is the batch of the benchmark's
    cell on chair_balser."""
    dev = card()
    env = CursorEnv(EnvConfig(furniture_name=name), device=dev)
    gen = torch.Generator(device=dev)
    P, phys = env._P, env.physics

    def staged(B):
        """A settled reset of B envs, the free and the welded groups, and
        gravity off for part 2."""
        gen.manual_seed(0)
        free = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        welded = free.clone()
        welded[:, 1] = 0
        gscale = torch.ones((B, P), device=dev)
        gscale[:, 2] = 0.0
        return env.reset_batch(B, gen), free, welded, gscale

    state, free, welded, gscale = staged(32)
    launches, cluster = phys.launches, phys.cluster_launches
    for group in (free, welded):
        assert kernel1_gap(phys, state.parts, group, gscale, 5) < 1e-4
    assert phys.launches == launches + 4
    assert phys.cluster_launches - cluster == (4 if phys.layout.route == "cluster" else 0)
    assert (phys.layout.route == "cluster") == (name != "table_lack_0825")
    state, free, welded, gscale = staged(B)
    parts = state.parts
    moving = parts._replace(lin_vel=parts.lin_vel + 0.05, ang_vel=parts.ang_vel + 0.1)
    ones = torch.ones_like(gscale)
    assert kernel1_gap(phys, moving, free, ones, 5) < 1e-4
    assert kernel1_gap(phys, moving, free, ones, 50) < 1e-3
    assert kernel1_gap(phys, parts, welded, gscale, 5) < 1e-4
    gen.manual_seed(7)
    eps = (torch.rand(parts.pos.shape, generator=gen, device=dev) - 0.5) * 2e-7
    ref = phys.plain_substeps(parts, welded, gscale, 50)
    ref2 = phys.plain_substeps(parts._replace(pos=parts.pos + eps), welded, gscale, 50)
    spread = max((a - b).abs().max().item() for a, b in zip(ref, ref2))
    assert kernel1_gap(phys, parts, welded, gscale, 50) <= max(1e-3, 10 * spread)


@pytest.mark.gpu
def test_free_part_kernel_sat_edge_lanes():
    """Leg 1 laid across leg 0 (edge on edge, no corner inside either box),
    settled into contact by the plain version, so that SAT edge lanes carry
    the contact: 1 and 5 substeps within 1e-4 (longer runs of this point
    contact are chaotic)."""
    from furniture_tpu_torch import transforms as T
    from furniture_tpu_torch.physics.collide import edge_contacts, pair_contacts, torch_tables

    dev = card()
    env = CursorEnv(EnvConfig(), device=dev)
    B, P = 64, env._P
    pos = torch.tensor([[2.0 + i, 2.0 + i, 0.02] for i in range(P)], device=dev)
    pos[0] = torch.tensor([0.0, 0.0, 0.017], device=dev)
    pos[1] = torch.tensor([0.0, 0.0, 0.055], device=dev)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(P, 1)
    y90 = T.euler_to_quat(torch.tensor([0.0, 90.0, 0.0], device=dev))
    quat[0] = y90
    quat[1] = T.quat_mul(T.euler_to_quat(torch.tensor([0.0, 0.0, 90.0], device=dev)), y90)
    pos = pos[None].repeat(B, 1, 1)
    pos[:, 1, 0] += torch.linspace(-0.01, 0.01, B, device=dev)
    group = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    gscale = torch.ones((B, P), device=dev)
    start = env.physics.plain_substeps(
        PartState(pos, quat[None].repeat(B, 1, 1), torch.zeros_like(pos), torch.zeros_like(pos)),
        group, gscale, 50,
    )
    tt = torch_tables(env.tables, dev)
    slop, NP = env.config.sim.contact_slop, env.physics.Ke
    pm = pair_contacts(tt, start.pos, start.quat, group, slop).mask
    hit = pm[:, : NP * 8].reshape(-1, NP, 8).any(-1) | pm[:, NP * 8 :].reshape(-1, NP, 8).any(-1)
    assert int(edge_contacts(tt, start.pos, start.quat, group, slop, hit).mask.sum()) > 0
    for n in (1, 5):
        assert kernel1_gap(env.physics, start, group, gscale, n) < 1e-4, n


@pytest.mark.gpu
def test_cluster_route_repeats_bit_for_bit():
    """chair_balser_0115 at B = 64 after a reset and 2 random steps, parts 0
    and 1 welded: three launches of the cluster route give the same bits
    (every sum in a fixed order, the CTAs' group partials added in rank
    order, no float atomics), within 1e-4 of the plain version
    after 5 substeps; the phase-clock build counts 39 block barriers a
    substep (one after the frames, two a pass and one after each group half
    but the last) and one cluster barrier (after the narrow phase; a pass's
    partials go through mbarriers), and one cluster barrier more before the
    CTAs leave; the card holds at least one cluster."""
    dev = card()
    env = CursorEnv(EnvConfig(furniture_name="chair_balser_0115"), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B, P, phys = 64, env._P, env.physics
    st = env.reset_batch(B, gen)
    for _ in range(2):
        st = env.step_batch(st, torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1)[0]
    group = st.group.clone()
    group[:, 1] = group[:, 0]
    parts = PartState(*(t.contiguous() for t in st.parts))
    gscale = torch.ones((B, P), device=dev)
    ref = phys.plain_substeps(parts, group, gscale, 5)
    runs = [phys.kernel_substeps(parts, group, gscale, 5) for _ in range(3)]
    clocks = phys.phase_clocks(parts, group, gscale, 5)
    torch.cuda.synchronize()
    for a, b in zip(ref, runs[0]):
        assert (a - b).abs().max().item() < 1e-4
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
    assert clocks.shape[0] == B and bool((clocks[:, :6] > 0).all())
    assert bool((clocks[:, -1] == 5 * 39).all()) and bool((clocks[:, 6] == 5 + 1).all())
    assert phys.cluster_launches == phys.launches
    assert phys.resident_blocks() >= 1


@pytest.mark.gpu
def test_free_part_kernel_welded_by_connect():
    """table_lack with two recipe steps preassembled (a group of three parts
    beside two free ones), parts dropped onto the floor and pushed: n = 5
    within 1e-4 and n = 50 within 1e-3 of the plain version (TF32 off), two
    launches bit-identical, also from the reset with a free leg
    gravity-compensated; and the phase-clock build of the same source
    gives the same result and a clock count for every phase."""
    card()
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
    # a free leg gravity-compensated, from the reset itself
    comp = gscale.clone()
    comp[:, 3] = 0.0
    assert kernel1_gap(phys, state.parts, state.group, comp, 5) < 1e-4
    assert kernel1_gap(phys, state.parts, state.group, comp, 50) < 1e-3
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
    runs of that stiff contact are ill-conditioned in a few envs:
    ``test_arm_kernel_pinched`` holds them by their spread); and from the
    plain reset, without contact, 5 substeps within 5e-4."""
    dev = card()
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
        args = arm_args(env, state, ctrl) + (n,)
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
    dev = card()
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
    args = arm_args(env, st, ctrl) + (1,)
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


# (agent, where part 0 lies, SimConfig fields, shared-memory limit, checks (n, tol, pinched))
PINCHED = {
    "sawyer-grip": ("Sawyer", "grip", {}, None, ((1, 5e-4, False), (5, 5e-4, True), (50, 1e-3, True))),
    "sawyer-grip-scratch": ("Sawyer", "grip", {}, 64 * 1024, ((5, 5e-4, True),)),
    "sawyer-free": ("Sawyer", "free", {}, None, ((50, 1e-3, False),)),
    "sawyer-uncoupled": ("Sawyer", "grip", {"robot_coupling": False}, None, ((5, 5e-4, True),)),
    "sawyer-held-clamp": ("Sawyer", "grip", {"held_vel_clamp": 0.05}, None, ((5, 5e-4, True),)),
    "baxter-tip": ("Baxter", "tip", {}, None, ((1, 5e-4, False), (5, 5e-4, True))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PINCHED))
def test_arm_kernel_pinched(case):
    """The arm kernel against its plain version at B = 256 (TF32 off) from an
    impedance reset with part 0 at the first arm's grip site ("grip"), in its
    left fingertip ("tip") or where it settled ("free"), under a random
    action with the grippers closing; also with ``robot_coupling=False``,
    with a held-velocity clamp, and on the global-scratch route forced by a
    lowered shared-memory limit. One substep is held to its bound in every
    env; over more substeps a part pinched between kinematic pads is
    ill-conditioned in a few envs (a lane on a threshold flips), so those
    are held by ``hold_arm``'s rule for a pinched part. Touch flags equal,
    and set where the part is gripped."""
    dev = card()
    agent, where, sim, smem_limit, checks = PINCHED[case]
    env = ArmEnv(EnvConfig(agent_type=agent, control_type="impedance", sim=SimConfig(**sim)), device=dev)
    assert env.physics.K == {"Sawyer": 1260, "Baxter": 1610}[agent]
    B = 256
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = env.reset_batch(B, gen)
    r, arm = env.robot, env.arms[0]
    fk_out = K.fk(r, st.qpos)
    if where != "free":
        if where == "grip":
            target, _ = K.site_world(r, fk_out, arm)
        else:
            # off the fingertip's center: a sample point exactly on a box
            # center ties the least-penetrated axis
            target = K.geom_world(r, fk_out)[0][:, int(r.finger_geoms_l[arm][-1])]
            target = target + torch.tensor([0.004, 0.003, 0.002], device=dev)
        pos = st.parts.pos.clone()
        pos[:, 0] = target
        st = st._replace(parts=st.parts._replace(pos=pos))
    gen.manual_seed(1)
    act = torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1
    act[:, -1 - env.n_arms : -1] = -1.0        # close every gripper hard
    ph = env.physics
    if smem_limit is not None:
        ph.smem_limit = smem_limit
        assert not ph.lane_buffer()[2], "the lowered limit did not select the global-scratch route"
    launches, scratch = ph.launches, ph.scratch_launches
    args = arm_args(env, st, env._direct_ctrl(act[:, :-1]))
    for n, tol, pinched in checks:
        h = hold_arm(ph, args, n, tol, pinched)
        assert h["problem"] is None, h
        assert where == "free" or h["n_touch"] > 0, h
    if smem_limit is not None:
        assert ph.scratch_launches - scratch == ph.launches - launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["table_lack_0825", "chair_balser_0115"])
def test_lane_solver_kernel_matches_plain(name):
    """The lane solver's kernel against its plain version at B = 32 (TF32
    off) on the contacts of a reset dropped onto the floor with the parts
    pushed along and into it: 12 and 24 sweeps within 1e-4 on both
    velocities, two launches bit-identical, one launch counted per call, and
    within 2e-3 / 5e-3 of the cold ``engine._solve_contacts``. table_lack (K = 210) keeps a lane per thread in registers,
    chair_balser_0115 (K = 4153) keeps its prepared lanes in a global
    scratch buffer."""
    dev = card()
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
    hold_lane(tables, args)       # also against the cold engine._solve_contacts


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
    (``preassembled=(0, 1)``); each also within 2e-3 / 5e-3 of the cold
    ``engine._solve_contacts`` (``hold_lane``)."""
    dev = card()
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
        hold_lane(lane_solver.LaneTables.of(case[0], case[1].shape[1], route), case, exact=case is masked)


@pytest.mark.gpu
def test_lane_solver_one_launch_no_prep_no_sync(monkeypatch):
    """On the card ``solve_contacts_lane`` needs the model's tables (it
    raises without them) and is one launch: it never calls
    ``engine.lane_prep``, dispatches no PyTorch operation but the two
    output allocations, and neither it, nor the lane substeps around it,
    nor a whole ``step_batch`` of the lane path synchronises the host."""
    card()
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


# (env id, control type or None, use_pallas, batch, steps stepped again on the CPU)
MAIN_PATHS = {
    "cursor-b4096": ("IKEACursor-v0", None, "auto", 4096, 3),
    "cursor-lane-b4096": ("IKEACursor-v0", None, "lane", 4096, 2),
    "sawyer-impedance-b512": ("IKEASawyer-v0", "impedance", "auto", 512, 3),
    "sawyer-ik-b256": ("IKEASawyer-v0", "ik", "auto", 256, 3),
    "sawyer-position_orientation-b512": ("IKEASawyer-v0", "position_orientation", "auto", 512, 0),
    "sawyer-joint_impedance-b512": ("IKEASawyer-v0", "joint_impedance", "auto", 512, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(MAIN_PATHS))
def test_vec_env_main_path(path):
    """``make_vec_env`` at its path's batch: a reset and 3 steps of uniform
    random actions launch what the code implies (kernel 1: 10 settle rounds
    a reset and, on the cursor, the n-substep and 1-substep snap launches a
    step; on the lane backend one lane-solver launch a substep and none of
    kernel 1; kernel 2 and 4 once a control step, ``action_repeat`` = 3 times
    an ik step, and kernel 5 once an ik step), and leave the state finite
    and in range (under the torque-space controllers: finite, no env
    unstable). Then, but for those, 8 envs through the card and through
    the port's CPU run (the plain versions): the discrete state exact, the
    floats within 1e-3 (under ik the joints within 5e-3 and their velocities
    within 5e-2: the converged DLS command carries ~5e-4 rad of arccos noise
    near w = 1 on either device)."""
    import furniture_tpu_torch as ft
    from furniture_tpu_torch import convert
    from furniture_tpu_torch.physics.megakernel import LanePhysics

    dev = card()
    env_id, control_type, backend, B, cpu_steps = MAIN_PATHS[path]
    arm, steps = control_type is not None, 3
    kw = {"control_type": control_type} if arm else {}
    vec = ft.make_vec_env(env_id, num_envs=B, seed=0, sim=SimConfig(use_pallas=backend), **kw)
    env = vec.env
    assert isinstance(env.physics, LanePhysics) == (backend == "lane")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    acts = [torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1 for _ in range(steps)]
    free = env.physics.free if arm else env.physics
    counters = [free, lane_solver] + ([env.physics, env.dynamics] if arm else [])
    counters += [env.ik] if arm and env.ik is not None else []
    for c in counters:
        c.launches = 0
    vec.reset()
    dones, unstable = 0, False
    for a in acts:
        _, rew, done, info = vec.step(a)
        dones += bool(done.any())
        unstable |= bool(info["unstable"].any())
    torch.cuda.synchronize()
    s = vec.state
    if arm:
        per_step = env.config.action_repeat if control_type == "ik" else 1
        want = [10 + 10 * dones, 0, per_step * steps, per_step * steps] + ([steps] if env.ik is not None else [])
        lo, hi = (torch.as_tensor(env.robot.jnt_range[:, i], dtype=torch.float32, device=dev) for i in (0, 1))
        floats = list(s.parts) + [s.qpos, s.qvel, s.ik_target_pos, s.hand_quat_init, rew]
        ranges = [(s.qpos >= lo) & (s.qpos <= hi), s.connect_step == 0, ~s.picked | s.touched,
                  (s.hand_quat_init.norm(dim=-1) - 1).abs() < 1e-3]
    else:
        n_sub = env.config.n_substeps
        want = [10 + 2 * steps + 10 * dones, 0] if backend != "lane" else \
            [0, 100 + (n_sub + 1) * steps + 100 * dones]
        floats = list(s.parts) + [rew]
        ranges = [(s.selected >= -1) & (s.selected < env._P),
                  (s.connect_step >= 0) & (s.connect_step <= env.config.num_connect_steps),
                  s.cursor_pos.abs() <= env.config.cursor_boundary]
    assert [c.launches for c in counters] == want, (path, dones)
    assert all(bool(torch.isfinite(t).all()) for t in floats)
    if control_type in ("position_orientation", "joint_impedance"):
        assert not unstable
        return
    ranges += [(s.group >= 0) & (s.group < env._P), (s.num_connected >= 0) & (s.num_connected <= env._W),
               (s.subtask >= -1) & (s.subtask < env._P), (s.t >= 0) & (s.t <= steps),
               (s.parts.quat.norm(dim=-1) - 1).abs() < 1e-3]
    assert [bool(r.all()) for r in ranges] == [True] * len(ranges)
    cpu_env = type(env)(env.config, device="cpu")
    to_np, from_np = ((convert.arm_state_to_numpy, convert.arm_state_from_numpy) if arm else
                      (convert.cursor_state_to_numpy, convert.cursor_state_from_numpy))
    gen.manual_seed(2)
    st_gpu = env.reset_batch(8, gen)
    st_cpu = from_np(to_np(st_gpu), "cpu")
    for a in acts[:cpu_steps]:
        st_gpu = env.step_batch(st_gpu, a[:8])[0]
        st_cpu = cpu_env.step_batch(st_cpu, a[:8].cpu())[0]
    g, c = to_np(st_gpu), to_np(st_cpu)
    exact = ["group", "num_connected", "connect_step", "t"]
    exact += ["touched", "picked", "touch_l", "touch_r"] if arm else ["selected"]
    for k in exact:
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    ik = control_type == "ik"
    bounds = {"pos": 1e-3, "quat": 1e-3, "lin_vel": 1e-3, "ang_vel": 1e-3}
    if arm:
        bounds |= {"ik_target_pos": 1e-3, "qpos": 5e-3 if ik else 1e-3, "qvel": 5e-2 if ik else 1e-3}
    gaps = {k: float(np.abs(g[k] - c[k]).max()) for k in bounds}
    assert all(gaps[k] <= bounds[k] for k in bounds), gaps
