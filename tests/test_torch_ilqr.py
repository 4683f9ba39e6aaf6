"""PyTorch port: the iLQR planner against the JAX package.

* the double integrator of ``tests/test_ilqr.py``: the port's plan against
  the JAX plan (``us`` within 1e-3, cost within 1e-4 relative), and the
  port alone at the JAX test's own bars;
* ``riccati_elements`` and ``riccati_combine`` against JAX's on the same
  random inputs (1e-5 relative); the hand-written suffix scan against a
  sequential fold of ``riccati_combine`` (1e-4 relative); parallel ≡
  sequential at ``tests/test_ilqr.py``'s bars;
* the cursor dynamics at ``SimConfig(control_freq=100, solver_iters=4)``,
  ``substeps=2``, from a JAX reset state carried across: ``f`` within 1e-4
  of JAX's, the Jacobians ``A``, ``B`` within 1e-3 of max |J| of JAX's
  ``jacrev`` (which differentiates the surrogate), max |B| > 1e-3, a finite,
  nonzero gradient through ``f``;
* Sawyer impedance, ``substeps=2``: ``f`` within 5e-4 and its Jacobian
  within 1e-3 of max |J| of JAX's;
* the held-part-to-target problem of ``tests/test_ilqr.py`` on the port
  only: cost < 0.6 x cost0 and the final distance < 0.5 x the initial.

JAX only ever jits ``f`` and ``jacrev(f)`` of the envs here (never a JAX
``plan`` on an env, whose compile is what makes ``tests/test_ilqr.py``
slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.arm import ArmEnv as JArmEnv
from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
from furniture_tpu.planning import ILQRConfig as JILQRConfig
from furniture_tpu.planning import flatten_env_dynamics as jflatten
from furniture_tpu.planning import ilqr as jilqr
from furniture_tpu.planning import make_ilqr as jmake_ilqr
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import (
    arm_state_from_numpy,
    cursor_state_from_numpy,
    ilqr_flat_from_jax,
    ilqr_flat_to_jax,
)
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.planning import ILQRConfig, flatten_env_dynamics, make_ilqr
from furniture_tpu_torch.planning import ilqr as tilqr

torch.set_num_threads(1)

DT = 0.1


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _state_dict(s, batched=False):
    """A JAX env state as the flat numpy dict of ``convert`` (batch of 1)."""
    d = {f: np.asarray(getattr(s.parts, f)) for f in s.parts._fields}
    d.update({f: np.asarray(getattr(s, f)) for f in s._fields if f != "parts"})
    return d if batched else {k: v[None] for k, v in d.items()}


# -- analytic problems ---------------------------------------------------------


def _di_jax():
    def f(x, u):
        return jnp.stack([x[0] + DT * x[1], x[1] + DT * u[0]])

    def rc(x, u, t):
        return 0.01 * jnp.sum(u**2) + 0.1 * (x[0] - 1.0) ** 2

    def tc(x):
        return 10.0 * ((x[0] - 1.0) ** 2 + x[1] ** 2)

    return f, rc, tc


def _di_torch():
    def f(x, u):
        return torch.stack([x[:, 0] + DT * x[:, 1], x[:, 1] + DT * u[:, 0]], -1)

    def rc(x, u, t):
        return 0.01 * torch.sum(u**2, -1) + 0.1 * (x[:, 0] - 1.0) ** 2

    def tc(x):
        return 10.0 * ((x[:, 0] - 1.0) ** 2 + x[:, 1] ** 2)

    return f, rc, tc


@pytest.mark.parametrize("parallel", [False, True])
def test_double_integrator_matches_jax(parallel):
    """The port's plan against the JAX plan (us within 1e-3, cost within
    1e-4 relative), and the port at the JAX test's bars: cost < 0.15 x
    cost0, the final state within 0.05 of (1, 0)."""
    kw = dict(horizon=20, iterations=15, u_min=-5, u_max=5, parallel_riccati=parallel)
    jus, jinfo = jax.jit(jmake_ilqr(*_di_jax(), JILQRConfig(**kw)))(jnp.zeros(2), jnp.zeros((20, 1)))
    f, rc, tc = _di_torch()
    us, info = make_ilqr(f, rc, tc, ILQRConfig(**kw))(torch.zeros(2), torch.zeros(20, 1))
    assert np.abs(us.numpy() - np.asarray(jus)).max() < 1e-3
    assert _rel(info["cost"].item(), float(jinfo["cost"])) < 1e-4
    assert _rel(info["cost0"].item(), float(jinfo["cost0"])) < 1e-6
    assert info["history"].shape == (15,)
    assert info["cost"].item() < 0.15 * info["cost0"].item()
    x = torch.zeros(1, 2)
    for u in us:
        x = f(x, u[None])
    assert abs(x[0, 0].item() - 1.0) < 0.05 and abs(x[0, 1].item()) < 0.05


def _random_problem(rng, H=6, n=4, m=2):
    """A well-posed random LQ expansion: PSD cost Hessians, stable A."""
    A = np.eye(n) + 0.1 * rng.standard_normal((H, n, n))
    B = 0.3 * rng.standard_normal((H, n, m))
    Lx = rng.standard_normal((H, n, n)) * 0.3
    cxx = Lx @ Lx.transpose(0, 2, 1) + 0.1 * np.eye(n)
    Lu = rng.standard_normal((H, m, m)) * 0.3
    cuu = Lu @ Lu.transpose(0, 2, 1) + 0.5 * np.eye(m)
    cux = 0.05 * rng.standard_normal((H, m, n))
    cx = rng.standard_normal((H, n))
    cu = rng.standard_normal((H, m))
    Lv = rng.standard_normal((n, n)) * 0.5
    vxx = Lv @ Lv.T + np.eye(n)
    vx = rng.standard_normal(n)
    return [np.asarray(a, np.float32) for a in (A, B, cx, cu, cxx, cuu, cux, vx, vxx)]


def test_riccati_elements_and_combine_match_jax():
    """Both building blocks of the parallel pass against JAX's on the same
    random inputs, within 1e-5 relative (per output)."""
    args = _random_problem(np.random.default_rng(0))
    reg = np.float32(1e-3)
    je = jilqr.riccati_elements(*(jnp.asarray(a) for a in args), reg)
    te = tilqr.riccati_elements(*(torch.from_numpy(a) for a in args), torch.tensor(reg))
    for a, b in zip(te, je):
        assert _rel(a.numpy(), b) < 1e-5
    # combine two different intervals of the scan: elements 1..H-1 with 0..H-2
    j_early = tuple(e[:-1] for e in je)
    j_late = tuple(e[1:] for e in je)
    jc = jilqr.riccati_combine(j_early, j_late)
    tc = tilqr.riccati_combine(
        tuple(torch.from_numpy(np.asarray(e)) for e in j_early),
        tuple(torch.from_numpy(np.asarray(e)) for e in j_late),
    )
    for a, b in zip(tc, jc):
        assert _rel(a.numpy(), b) < 1e-5


def test_suffix_scan_matches_sequential_fold():
    """The Hillis-Steele suffix scan against e_t ⊗ (e_{t+1} ⊗ (…)) folded one
    element at a time, within 1e-4 relative (another bracketing of the same
    associative product in float32)."""
    args = [torch.from_numpy(a) for a in _random_problem(np.random.default_rng(1), H=11)]
    elems = tilqr.riccati_elements(*args, torch.tensor(1e-3))
    L = elems[0].shape[0]
    fold = [None] * L
    fold[L - 1] = tuple(e[L - 1] for e in elems)
    for t in reversed(range(L - 1)):
        fold[t] = tilqr.riccati_combine(tuple(e[t] for e in elems), fold[t + 1])
    scan = tilqr.suffix_scan(elems)
    for i in range(5):
        want = torch.stack([fold[t][i] for t in range(L)])
        assert _rel(scan[i].numpy(), want.numpy()) < 1e-4, i


def test_parallel_riccati_matches_sequential():
    """The port's two backward passes give the same plan, at
    ``tests/test_ilqr.py``'s bars (us 5e-2, cost 1e-3 relative)."""

    def f(x, u):
        return torch.stack(
            [x[:, 0] + DT * x[:, 2], x[:, 1] + DT * x[:, 3],
             x[:, 2] + DT * (u[:, 0] + 0.3 * u[:, 1]), x[:, 3] + DT * u[:, 1]], -1)

    tgt = torch.tensor([1.0, -0.5, 0.0, 0.0])

    def rc(x, u, t):
        return (0.02 * torch.sum(u**2, -1) + 0.1 * torch.sum((x - tgt) ** 2, -1)
                + 0.01 * u[:, 0] * x[:, 1])

    def tc(x):
        return 10.0 * torch.sum((x - tgt) ** 2, -1)

    x0 = torch.tensor([0.0, 0.3, 0.0, 0.0])
    u0 = torch.zeros(16, 2)
    kw = dict(horizon=16, iterations=8, u_min=-50.0, u_max=50.0)
    us_s, info_s = make_ilqr(f, rc, tc, ILQRConfig(**kw))(x0, u0)
    us_p, info_p = make_ilqr(f, rc, tc, ILQRConfig(parallel_riccati=True, **kw))(x0, u0)
    assert (us_s - us_p).abs().max().item() < 5e-2
    assert _rel(info_p["cost"].item(), info_s["cost"].item()) < 1e-3
    assert info_s["cost"].item() < 0.5 * info_s["cost0"].item()


# -- the cursor dynamics ---------------------------------------------------------


@pytest.fixture(scope="module")
def cursor_pair():
    """Both packages' cursor envs at SimConfig(control_freq=100,
    solver_iters=4), and a JAX reset state in which cursor 0 holds part 0."""
    sim = dict(control_freq=100, solver_iters=4)
    jenv = JCursorEnv(JEnvConfig(sim=JSimConfig(**sim)))
    tenv = CursorEnv(EnvConfig(sim=SimConfig(**sim)), device="cpu")
    s = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    s = s._replace(
        cursor_pos=s.cursor_pos.at[0].set(s.parts.pos[0]),
        selected=s.selected.at[0].set(0),
    )
    return jenv, tenv, s


def _jacobian_port_order(J, layout, n):
    """A JAX Jacobian [n, n+m] of the flat step, rows and the x columns
    put into the port's flat order."""
    J = np.asarray(J)
    A = ilqr_flat_from_jax(ilqr_flat_from_jax(J[:, :n], layout).T, layout).T
    B = ilqr_flat_from_jax(J[:, n:].T, layout).T
    return A, B


def _port_jacobian(f, x, u):
    """A, B of the port's f at one (x, u), through the batched pass of
    make_ilqr's linearization (one row per output)."""
    n, m = x.shape[0], u.shape[0]
    X = x[None].repeat(n, 1).requires_grad_(True)
    U = u[None].repeat(n, 1).requires_grad_(True)
    gx, gu = torch.autograd.grad(f.f_grad(X, U), (X, U), torch.eye(n))
    return gx.numpy(), gu.numpy()


def test_cursor_dynamics_match_jax(cursor_pair):
    """f within 1e-4; A and B within 1e-3 of max |J| of JAX's jacrev (the
    surrogate gradient); max |B| > 1e-3; the flat-state maps round-trip."""
    jenv, tenv, s = cursor_pair
    jf, jx0, _ = jflatten(jenv, s, substeps=2)
    tstate = cursor_state_from_numpy(_state_dict(s), "cpu")
    f, x0, unravel = flatten_env_dynamics(tenv, tstate, substeps=2)
    layout = unravel.layout
    n = x0.shape[0]
    assert n == 41 and tuple(name for name, _ in layout) == ("pos", "quat", "cursor_pos")
    np.testing.assert_array_equal(ilqr_flat_from_jax(np.asarray(jx0), layout), x0.numpy())
    np.testing.assert_array_equal(ilqr_flat_to_jax(x0.numpy(), layout), np.asarray(jx0))

    rng = np.random.default_rng(0)
    u = (0.5 * rng.uniform(-1, 1, 15)).astype(np.float32)
    u[6] = 1.0                                   # cursor 0 keeps its part
    jy = jax.jit(jf)(jx0, jnp.asarray(u))
    y = f(x0[None], torch.from_numpy(u)[None])[0]
    assert np.abs(y.numpy() - ilqr_flat_from_jax(np.asarray(jy), layout)).max() < 1e-4

    J = jax.jit(lambda x, u: jax.jacrev(lambda z: jf(z[:n], z[n:]))(jnp.concatenate([x, u])))(
        jx0, jnp.asarray(u))
    jA, jB = _jacobian_port_order(J, layout, n)
    A, B = _port_jacobian(f, x0, torch.from_numpy(u))
    scale = max(np.abs(jA).max(), np.abs(jB).max())
    assert np.abs(A - jA).max() < 1e-3 * scale
    assert np.abs(B - jB).max() < 1e-3 * scale
    assert np.abs(B).max() > 1e-3, "controls do not affect dynamics"
    # f's own gradient (the Function's backward) is the twin's
    x = x0[None].clone().requires_grad_(True)
    g = torch.autograd.grad((f(x, torch.zeros(1, 15)) ** 2).sum(), x)[0]
    assert torch.isfinite(g).all() and g.abs().max().item() > 0.0


def test_cursor_full_gradient_form(cursor_pair):
    """smooth_grads=False: the same forward, the gradient of the full plain
    physics (no f_smooth), finite."""
    _, tenv, s = cursor_pair
    tstate = cursor_state_from_numpy(_state_dict(s), "cpu")
    f_s, x0, _ = flatten_env_dynamics(tenv, tstate, substeps=2)
    f_f, x1, _ = flatten_env_dynamics(tenv, tstate, substeps=2, smooth_grads=False)
    assert not hasattr(f_f, "f_smooth") and hasattr(f_s, "f_smooth")
    u = torch.zeros(1, 15)
    torch.testing.assert_close(f_f(x1[None], u), f_s(x0[None], u), rtol=0, atol=0)
    x = x1[None].clone().requires_grad_(True)
    g = torch.autograd.grad((f_f(x, u) ** 2).sum(), x)[0]
    assert torch.isfinite(g).all() and g.abs().max().item() > 0.0


def test_ilqr_moves_held_part_to_target():
    """The port's iLQR on the cursor manipulation problem of
    ``tests/test_ilqr.py``: beats the zero-control rollout (cost < 0.6 x
    cost0) and brings the held part to half its initial distance."""
    env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, solver_iters=8)), device="cpu")
    s = env.reset(torch.Generator().manual_seed(1))
    cursor = s.cursor_pos.clone()
    cursor[0] = s.parts.pos[0]
    s = s._replace(cursor_pos=cursor, selected=torch.tensor([0, -1], dtype=torch.int32))
    f, x0, unravel = flatten_env_dynamics(env, s, substeps=3)
    target = unravel(x0)["pos"][0] + torch.tensor([0.1, 0.08, 0.05])

    def rc(x, u, t):
        c = unravel(x)
        return 10.0 * torch.sum((c["pos"][:, 0] - target) ** 2, -1) + 0.05 * torch.sum(u**2, -1)

    def tc(x):
        return 100.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1)

    cfg = ILQRConfig(horizon=12, iterations=6)
    us, info = make_ilqr(f, rc, tc, cfg)(x0, torch.zeros(cfg.horizon, env.dof))
    cost, cost0 = info["cost"].item(), info["cost0"].item()
    assert cost < 0.6 * cost0, (cost, cost0)
    x = x0[None]
    with torch.no_grad():
        for u in us:
            x = f(x, u[None])
    d_final = torch.linalg.norm(unravel(x)["pos"][0, 0] - target).item()
    d_init = torch.linalg.norm(unravel(x0)["pos"][0] - target).item()
    assert d_final < 0.5 * d_init, (d_final, d_init)


# -- the arm dynamics ------------------------------------------------------------


def test_sawyer_dynamics_match_jax():
    """Sawyer impedance, substeps=2, from a port reset with part 0 at the
    grip site (robot lanes, squeeze servo and joint coupling all at work)
    and the parts in motion, carried to JAX: f within 5e-4 and its Jacobian within 1e-3 of max |J|
    of JAX's jacrev (both differentiate the full coupled step)."""
    from furniture_tpu.envs.arm import ArmState as JArmState
    from furniture_tpu.physics.state import PartState as JPartState
    from furniture_tpu_torch.convert import arm_state_to_numpy
    from furniture_tpu_torch.robots import kinematics as K

    sim = dict(control_freq=100)
    jenv = JArmEnv(JEnvConfig(agent_type="Sawyer", control_type="impedance", sim=JSimConfig(**sim)))
    tenv = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance", sim=SimConfig(**sim)),
                  device="cpu")
    ts = tenv.reset_batch(1, torch.Generator().manual_seed(0))
    gp, _ = K.site_world(tenv.robot, K.fk(tenv.robot, ts.qpos), "right")
    pos = ts.parts.pos.clone()
    pos[:, 0] = gp
    d = arm_state_to_numpy(ts._replace(parts=ts.parts._replace(pos=pos)))
    # parts in motion: at zero angular velocity the integrator's axis
    # w/|w| has a 1e9 derivative, which would swamp every other entry
    rng = np.random.default_rng(1)
    d["lin_vel"] = (0.1 * rng.standard_normal(d["lin_vel"].shape)).astype(np.float32)
    d["ang_vel"] = (0.5 * rng.standard_normal(d["ang_vel"].shape)).astype(np.float32)
    js = JArmState(
        parts=JPartState(*(jnp.asarray(d[k][0]) for k in JPartState._fields)),
        **{k: jnp.asarray(d[k][0]) for k in JArmState._fields if k != "parts"},
    )
    jf, jx0, _ = jflatten(jenv, js, substeps=2)
    f, x0, unravel = flatten_env_dynamics(tenv, arm_state_from_numpy(d, "cpu"), substeps=2)
    layout = unravel.layout
    n = x0.shape[0]
    np.testing.assert_array_equal(ilqr_flat_from_jax(np.asarray(jx0), layout), x0.numpy())
    u = (0.5 * rng.uniform(-1, 1, tenv.dof)).astype(np.float32)
    u[-1] = 1.0                                  # the gripper closes
    jy = jax.jit(jf)(jx0, jnp.asarray(u))
    y = f(x0[None], torch.from_numpy(u)[None])[0]
    assert np.abs(y.numpy() - ilqr_flat_from_jax(np.asarray(jy), layout)).max() < 5e-4
    J = jax.jit(lambda x, u: jax.jacrev(lambda z: jf(z[:n], z[n:]))(jnp.concatenate([x, u])))(
        jx0, jnp.asarray(u))
    jA, jB = _jacobian_port_order(J, layout, n)
    A, B = _port_jacobian(f, x0, torch.from_numpy(u))
    scale = max(np.abs(jA).max(), np.abs(jB).max())
    assert np.abs(A - jA).max() < 1e-3 * scale
    assert np.abs(B - jB).max() < 1e-3 * scale
