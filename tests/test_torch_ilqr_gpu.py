"""PyTorch port: the iLQR planner on the card.

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
  smooth only between contact onsets).
"""

import pytest
import torch

from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.planning import ILQRConfig, flatten_env_dynamics, make_ilqr


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the physics kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_ilqr_iteration_makes_no_host_sync():
    dev = _card()
    env = CursorEnv(EnvConfig(sim=SimConfig(solver_iters=8)), device=dev)
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
    dev = _card()
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
