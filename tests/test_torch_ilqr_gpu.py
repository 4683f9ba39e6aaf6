"""PyTorch port: the planners on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_ilqr_gpu.py

* one iLQR iteration on the cursor (the free-part kernel in every
  line-search step) runs under ``torch.cuda.set_sync_debug_mode("error")``:
  no host synchronisation, and exactly ``H + H`` kernel launches (the
  initial rollout, then one batched line-search rollout);
* the arm form's forward is the arm kernel (within 5e-4 of the plain
  version), and its Jacobian agrees with central differences of the
  kernel forward along random directions: within twice the plain
  forward's own gap, or 1e-3 of max |J d|, at whichever step of 1e-3,
  3e-4, 1e-4 the plain forward's differences come closest (the step is
  smooth only between contact onsets);
* iLQR at ``bench.py``'s configuration on both backends, with the physics
  kernel held at the planner's own inputs; MPPI and CEM on both backends.
"""

import pytest
import torch
from torch_gpu_holds import card, hold_lane, kernel1_gap, recording

from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.physics import lane_solver
from furniture_tpu_torch.planning import (
    CEMConfig, ILQRConfig, MPPIConfig, flatten_env_dynamics, make_cem, make_ilqr, make_mppi,
)


def _held_part_problem(dev, backend):
    """The cursor (``SimConfig(solver_iters=8)``) with cursor 0 holding part
    0, as ``bench.py``'s iLQR problem (10 substeps a planner step), and its
    quadratic costs on the part's distance to a target 18 cm away: ``(env,
    f, x0, unravel, running_cost, terminal_cost, target)``."""
    env = CursorEnv(EnvConfig(sim=SimConfig(solver_iters=8, use_pallas=backend)), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = env.reset_batch(1, gen)
    cursor = s.cursor_pos.clone()
    cursor[:, 0] = s.parts.pos[:, 0]
    s = s._replace(cursor_pos=cursor, selected=torch.tensor([[0, -1]], dtype=torch.int32, device=dev))
    f, x0, unravel = flatten_env_dynamics(env, s, substeps=10)
    target = unravel(x0)["pos"][0] + torch.tensor([0.12, 0.1, 0.08], device=dev)

    def rc(x, u, t):
        return 10.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1) + 0.05 * torch.sum(u**2, -1)

    def tc(x):
        return 100.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1)

    return env, f, x0, unravel, rc, tc, target


@pytest.mark.gpu
def test_ilqr_iteration_makes_no_host_sync():
    dev = card()
    env, f, x0, _, rc, tc, _ = _held_part_problem(dev, "auto")
    H = 16
    plan = make_ilqr(f, rc, tc, ILQRConfig(horizon=H, iterations=1, parallel_riccati=True))
    u0 = torch.zeros((H, env.dof), device=dev)
    plan(x0, u0)                                  # warm-up: libraries, tables
    torch.cuda.synchronize()
    before = env.physics.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        us, info = plan(x0, u0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert env.physics.launches - before == 2 * H
    assert torch.isfinite(us).all() and info["cost"].item() <= info["cost0"].item()


@pytest.mark.gpu
def test_arm_dynamics_forward_is_the_kernel():
    dev = card()
    cfg = EnvConfig(agent_type="Sawyer", control_type="impedance")
    env = ArmEnv(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = env.reset_batch(1, gen)
    f, x0, unravel = flatten_env_dynamics(env, s, substeps=5)
    n = x0.shape[0]
    # parts in motion: at zero angular velocity the integrator's axis w/|w|
    # has a 1e9 derivative, which would swamp every other entry
    for name in ("lin_vel", "ang_vel"):
        v = unravel(x0)[name]
        v.copy_(torch.linspace(-0.5, 0.5, v.numel(), device=dev).reshape(v.shape))
    # the fingers rest at their open limit, where the joint clamp makes the
    # step jump: joints within 5 mm (rad) of a limit go to mid-range
    q = unravel(x0)["qpos"]
    lim = torch.as_tensor(env.robot.jnt_range, dtype=q.dtype, device=dev)
    q.copy_(torch.where(((q - lim[:, 0]) < 5e-3) | ((lim[:, 1] - q) < 5e-3), lim.mean(-1), q))
    m = env.dof
    u = torch.linspace(-0.5, 0.5, m, device=dev)
    before = env.physics.launches
    y = f(x0[None], u[None])
    assert env.physics.launches == before + 1
    y_plain = f.f_grad(x0[None], u[None])
    assert (y - y_plain).abs().max().item() < 5e-4
    # the Jacobian through the Function (kernel forward, plain backward)
    # against central differences of the kernel forward
    X = x0[None].repeat(n, 1).requires_grad_(True)
    U = u[None].repeat(n, 1).requires_grad_(True)
    Jx, Ju = torch.autograd.grad(f(X, U), (X, U), torch.eye(n, device=dev))
    gen.manual_seed(5)
    dx = torch.rand((4, n), generator=gen, device=dev) * 2 - 1
    du = torch.rand((4, m), generator=gen, device=dev) * 2 - 1
    jd = dx @ Jx.T + du @ Ju.T

    def gap(fn, eps):
        with torch.no_grad():
            ys = fn(torch.cat([x0 + eps * dx, x0 - eps * dx]), torch.cat([u + eps * du, u - eps * du]))
        return ((ys[:4] - ys[4:]) / (2 * eps) - jd).abs().max().item() / jd.abs().max().item()

    plain = {eps: gap(f.f_grad, eps) for eps in (1e-3, 3e-4, 1e-4)}
    eps = min(plain, key=plain.get)
    assert gap(f, eps) <= max(2 * plain[eps], 1e-3), (eps, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["auto", "lane"])
def test_ilqr_solves_and_holds_its_kernel(backend):
    """iLQR at ``bench.py``'s configuration (parallel Riccati, 5 iterations;
    horizon 16): a cold solve beats the zero-control rollout, two solves
    warm-started as ``bench.py`` evolves them keep their cost at or below
    their start and move the held part toward its target, each solve
    ``H + 5 H`` launches of kernel 1; then the physics kernel at the
    planner's own inputs (the held group at gscale 0), recorded at t = 0,
    H/2 and H - 1 of an initial rollout (one env) and of a line search (one
    env a step size): kernel 1 within 1e-4 after 5 substeps and 1e-3 after
    the step's 10. On the lane backend one solve of 1 iteration (one
    lane-solver launch a substep) and kernel 3 at the recorded steps' first
    substep, at the configuration's 8 sweeps (``hold_lane``)."""
    dev = card()
    env, f, x0, unravel, rc, tc, target = _held_part_problem(dev, backend)
    H, lane = 16, backend == "lane"
    cfg = ILQRConfig(horizon=H, iterations=1 if lane else 5, parallel_riccati=True)
    plan = make_ilqr(f, rc, tc, cfg)
    counter = lane_solver if lane else env.physics
    u = torch.zeros((H, env.dof), device=dev)
    counter.launches = 0
    u, info = plan(x0, u)
    assert counter.launches == (2 * H * 10 if lane else H + 5 * H)
    assert torch.isfinite(u).all() and info["cost"].item() < info["cost0"].item()
    for i in range(0 if lane else 2):
        counter.launches = 0
        u, info = plan(x0 + 1e-4 * (i + 1), u)
        assert counter.launches == H + 5 * H
        assert torch.isfinite(u).all() and info["cost"].item() <= info["cost0"].item()
    if not lane:
        x = x0[None]
        with torch.no_grad():
            for ut in u:
                x = f(x, ut[None])
        start = torch.linalg.norm(unravel(x0)["pos"][0] - target).item()
        assert torch.linalg.norm(unravel(x)["pos"][0, 0] - target).item() < start
    xs, _ = plan.initial_rollout(x0, u)
    ks, Ks, _ = plan.backward(*plan.linearize(xs, u), torch.full((), cfg.reg_init, device=dev))
    with recording(env, 2 * H + 1) as calls:
        plan.initial_rollout(x0, u)
        plan.line_search(x0, xs, u, ks, Ks)
    assert len(calls) == 2 * H
    live = False
    for parts, group, gscale, n in [calls[o + t] for o in (0, H) for t in (0, H // 2, H - 1)]:
        if lane:
            args = env.physics.solver_args(parts, group, gscale)
            c = args[0]
            hit = bool((c.mask & (c.depth > -args[10])).any())
            live |= hit
            hold_lane(env.physics.lane_tables, args, sweeps=(args[8],), exact=not hit)
        else:
            assert kernel1_gap(env.physics, parts, group, gscale, 5) < 1e-4
            assert kernel1_gap(env.physics, parts, group, gscale, n) < 1e-3
    assert live or not lane, "no recorded step has an active contact lane"


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["auto", "lane"])
@pytest.mark.parametrize("planner", ["mppi", "cem"])
def test_sampling_planner_on_the_card(planner, backend):
    """MPPI (16 steps x 256 samples) and one CEM iteration (16 x 256, 32
    elites) on ``bench.py``'s planner env (``SimConfig(timestep=0.02,
    solver_iters=8)``) on either backend: 2 launches of kernel 1 a planner
    step, or one lane-solver launch a substep and the snap's, and none of
    the other; costs and plan finite, the mean within [-1, 1] (CEM's sigma
    at or above ``sigma_min``); the same seed gives the same plan."""
    dev = card()
    env = CursorEnv(EnvConfig(sim=SimConfig(timestep=0.02, solver_iters=8, use_pallas=backend)), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.reset_batch(1, gen)
    H = 16
    if planner == "mppi":
        fn = make_mppi(env, MPPIConfig(horizon=H, n_samples=256, sigma=0.3))
        inputs = (torch.zeros((H, env.dof), device=dev),)
    else:
        cfg = CEMConfig(horizon=H, n_samples=256, n_elite=32)
        fn = make_cem(env, cfg)
        inputs = (torch.zeros((H, env.dof), device=dev), torch.full((H, env.dof), cfg.sigma_init, device=dev))
    lane = backend == "lane"
    counters = (lane_solver, env.physics)
    outs = []
    for _ in range(2):
        for c in counters:
            c.launches = 0
        gen.manual_seed(10)
        outs.append(fn(state, *inputs, gen))
        want = H * (env.config.n_substeps + 1) if lane else 2 * H
        assert [c.launches for c in counters] == ([want, 0] if lane else [0, want])
    out, info = outs[0][:-1], outs[0][-1]
    assert torch.isfinite(info["costs"]).all() and all(bool(torch.isfinite(t).all()) for t in out)
    assert out[0].abs().max().item() <= 1.0 + 1e-6
    if planner == "cem":
        assert bool((out[1] >= cfg.sigma_min).all())
    assert all(torch.equal(a, b) for a, b in zip(out, outs[1][:-1]))
