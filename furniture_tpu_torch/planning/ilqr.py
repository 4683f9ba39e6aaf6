"""iLQR / DDP trajectory optimization over the batched dynamics.

The port's counterpart of ``furniture_tpu.planning.ilqr``: linearize the
step, run the Riccati backward pass over the horizon (sequential, or the
parallel-in-time form of Särkkä & García-Fernández, IEEE TAC 2023, as a
log-depth suffix scan written out by hand), and forward-roll every step
size of the line search at once.

**Batched convention.** The port's physics takes a batch natively, so the
dynamics and the costs take a leading batch axis whose rows are
independent: ``f(x [B,n], u [B,m]) -> x' [B,n]``, ``running_cost(x [B,n],
u [B,m], t [B]) -> [B]`` and ``terminal_cost(x [B,n]) -> [B]``. The line
search sends its ``len(alphas)`` candidates through ``f`` as one batch, so
on the card each step of the search is one launch of the physics kernel.
The linearization takes the Jacobians of all ``H`` steps from one batched
pass: each of the ``H`` rows is repeated ``n`` times, the dynamics run once
under autograd, and one ``torch.autograd.grad`` pulls one-hot cotangents.
(The plain physics writes into clones in place, which autograd takes and
``torch.func.vmap`` does not always; this way the physics never meets a
function transform.) The cost expansions do use ``torch.func`` (``grad``
and ``hessian`` under ``vmap``), so the costs must be pure functions of
their arguments; the ``unravel`` of :func:`flatten_env_dynamics` is views
and reshapes only.

A plan makes no host synchronisation: a step is accepted or rejected and
the regularisation updated with ``torch.where`` and ``clamp``, and the
factorisations are ``cholesky_ex``/``solve_ex``, which report failure in a
tensor instead of on the host. The Riccati matrix products run in full
float32 (TF32 off) whatever the caller's setting.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import transforms as T
from ..physics.engine import make_substep, substeps as engine_substeps
from ..physics.state import PartState


@dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 16
    iterations: int = 10
    reg_init: float = 1e-3
    reg_max: float = 1e3
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)
    u_min: float = -1.0
    u_max: float = 1.0
    # parallel-in-time Riccati backward pass (a suffix scan over the
    # horizon, O(log H) depth) instead of the sequential one
    parallel_riccati: bool = False


@contextlib.contextmanager
def _full_f32():
    """Float32 matrix products in full precision (TF32 off) inside."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _solve(a, b):
    """``a⁻¹ b`` without the host check of ``torch.linalg.solve``."""
    return torch.linalg.solve_ex(a, b)[0]


def riccati_elements(A, B, cx, cu, cxx, cuu, cux, vx, vxx, reg):
    """Per-step conditional-value elements for the parallel LQR scan.

    Element (A, b, C, η, J) represents the value function of a time
    interval as V(x) = ½ xᵀJx − ηᵀx after elimination of the interior; the
    cross terms c_ux are removed by the standard change of control
    variables first. Returns tensors of length H+1 (terminal element
    last)."""
    H, n, m = B.shape
    Im = torch.eye(m, dtype=B.dtype, device=B.device)
    U = cuu + reg * Im
    Ui = _solve(U, Im.expand(H, m, m))
    BUi = B @ Ui
    cuxT = cux.transpose(1, 2)
    F = A - BUi @ cux
    b = -(BUi @ cu[..., None])[..., 0]
    C = BUi @ B.transpose(1, 2)
    X = cxx - cuxT @ Ui @ cux
    cxb = cx - (cuxT @ Ui @ cu[..., None])[..., 0]
    zmat = torch.zeros((1, n, n), dtype=B.dtype, device=B.device)
    zvec = torch.zeros((1, n), dtype=B.dtype, device=B.device)
    return (
        torch.cat([F, zmat]),
        torch.cat([b, zvec]),
        torch.cat([C, zmat]),
        torch.cat([-cxb, -vx[None]]),
        torch.cat([X, vxx[None]]),
    )


def riccati_combine(e_earlier, e_later):
    """Associative combination of two conditional-value elements (the
    earlier-in-time interval first); batched over leading axes."""
    Ai, bi, Ci, etai, Ji = e_earlier
    Aj, bj, Cj, etaj, Jj = e_later
    n = Ai.shape[-1]
    I = torch.eye(n, dtype=Ai.dtype, device=Ai.device).expand(Ai.shape)
    M = _solve((I + Ci @ Jj).transpose(-1, -2), Aj.transpose(-1, -2))
    AjM = M.transpose(-1, -2)                            # A_j (I + C_i J_j)^{-1}
    A_out = AjM @ Ai
    bc = bi + (Ci @ etaj[..., None])[..., 0]
    b_out = (AjM @ bc[..., None])[..., 0] + bj
    C_out = AjM @ Ci @ Aj.transpose(-1, -2) + Cj
    JjM = Jj @ _solve(I + Ci @ Jj, I)                    # (I+J_jC_i)^{-1}J_j
    eta_out = (
        Ai.transpose(-1, -2) @ (etaj - (JjM @ bc[..., None])[..., 0])[..., None]
    )[..., 0] + etai
    J_out = Ai.transpose(-1, -2) @ JjM @ Ai + Ji
    return A_out, b_out, C_out, eta_out, J_out


def suffix_scan(elems):
    """``out[t] = e_t ⊗ e_{t+1} ⊗ … ⊗ e_{L-1}`` for ``⊗ = riccati_combine``
    (earlier interval first), over elements stacked on axis 0: the
    Hillis–Steele scan, ⌈log₂ L⌉ rounds of one batched combine each. It is
    what ``jax.lax.associative_scan(lambda a, b: riccati_combine(b, a),
    elems, reverse=True)`` computes, bracketed another way."""
    L = elems[0].shape[0]
    d = 1
    while d < L:
        head = riccati_combine(
            tuple(e[: L - d] for e in elems), tuple(e[d:] for e in elems)
        )
        elems = tuple(torch.cat([h, e[L - d:]]) for h, e in zip(head, elems))
        d *= 2
    return elems


def _gains(Quu, Qu, Qux, reg):
    """(k, K, dv) from the Q expansion of one or many steps: the Cholesky
    factor of the symmetrised, regularised Quu with a 1e-9·I jitter."""
    m = Quu.shape[-1]
    Im = torch.eye(m, dtype=Quu.dtype, device=Quu.device)
    Quu_reg = Quu + reg * Im
    L = torch.linalg.cholesky_ex(0.5 * (Quu_reg + Quu_reg.transpose(-1, -2)) + 1e-9 * Im)[0]
    k = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
    Kt = -torch.cholesky_solve(Qux, L)
    dv = (k * Qu).sum(-1) + 0.5 * (k * (Quu @ k[..., None])[..., 0]).sum(-1)
    return k, Kt, dv


def backward_sequential(A, B, cx, cu, cxx, cuu, cux, vx, vxx, reg):
    """Riccati backward pass, one step at a time from the end."""
    H = A.shape[0]
    Vx, Vxx = vx, vxx
    ks, Ks, dvs = [None] * H, [None] * H, []
    for t in reversed(range(H)):
        At, Bt = A[t], B[t]
        Qx = cx[t] + At.T @ Vx
        Qu = cu[t] + Bt.T @ Vx
        Qxx = cxx[t] + At.T @ Vxx @ At
        Quu = cuu[t] + Bt.T @ Vxx @ Bt
        Qux = cux[t] + Bt.T @ Vxx @ At
        k, Kt, dv = _gains(Quu, Qu, Qux, reg)
        Vx = Qx + Kt.T @ Quu @ k + Kt.T @ Qu + Qux.T @ k
        Vxx = Qxx + Kt.T @ Quu @ Kt + Kt.T @ Qux + Qux.T @ Kt
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks[t], Ks[t] = k, Kt
        dvs.append(dv)
    return torch.stack(ks), torch.stack(Ks), torch.stack(dvs).sum()


def backward_parallel(A, B, cx, cu, cxx, cuu, cux, vx, vxx, reg):
    """Parallel-in-time Riccati: suffix-combine the conditional-value
    elements (:func:`suffix_scan`), then recover all per-step gains in one
    batch."""
    elems = riccati_elements(A, B, cx, cu, cxx, cuu, cux, vx, vxx, reg)
    suffix = suffix_scan(elems)
    Vxx_next = suffix[4][1:]                             # [H,n,n] V at t+1
    vx_next = -suffix[3][1:]                             # [H,n]
    BT = B.transpose(1, 2)
    Quu = cuu + BT @ Vxx_next @ B
    Qu = cu + (BT @ vx_next[..., None])[..., 0]
    Qux = cux + BT @ Vxx_next @ A
    k, Kt, dv = _gains(Quu, Qu, Qux, reg)
    return k, Kt, dv.sum()


def make_ilqr(f, running_cost, terminal_cost, cfg: ILQRConfig, f_surrogate=None):
    """Build an iLQR solve over batched dynamics and costs (see the module
    docstring for the batched convention).

    f:             (x [B,n], u [B,m]) -> x' [B,n]
    running_cost:  (x [B,n], u [B,m], t [B]) -> [B]
    terminal_cost: (x [B,n]) -> [B]
    f_surrogate:   optional cheap dynamics twin (e.g. ``f.f_smooth`` of
                   :func:`flatten_env_dynamics`). When given, the line
                   search ranks its candidates on the surrogate and re-rolls
                   only the winning step size on ``f``, whose cost gates
                   acceptance.

    Where ``f`` carries ``f.f_grad`` (the dynamics of
    :func:`flatten_env_dynamics` do), the linearization takes its Jacobians
    through ``f.f_grad``: a function whose gradient is ``f``'s by
    construction, without ``f``'s full-dynamics forward.

    Returns ``plan(x0 [n], u_init [H,m]) -> (us [H,m], info)`` with
    ``info = {"cost", "cost0", "history" [iterations]}``, all tensors on
    ``x0``'s device. The steps of a solve are attributes of ``plan``, for
    timing them apart: ``initial_rollout(x0, u_init) -> (xs, cost0)``,
    ``linearize(xs, us)``, ``backward(*expansions, reg) -> (ks, Ks, dv)``
    and ``line_search(x0, xs, us, ks, Ks) -> (us, cost, xs)``.
    """
    H = cfg.horizon
    backward = backward_parallel if cfg.parallel_riccati else backward_sequential
    f_lin = getattr(f, "f_grad", f)

    def rc_z(n):
        return lambda z, t: running_cost(z[None, :n], z[None, n:], t[None])[0]

    def linearize(xs, us):
        """Per-step dynamics and cost expansions, batched over the horizon."""
        n, m = xs.shape[-1], us.shape[-1]
        x = xs[:-1].detach().repeat_interleave(n, 0).requires_grad_(True)   # [H*n,n]
        u = us.detach().repeat_interleave(n, 0).requires_grad_(True)        # [H*n,m]
        eye = torch.eye(n, dtype=xs.dtype, device=xs.device)
        with torch.enable_grad():
            y = f_lin(x, u)
            gx, gu = torch.autograd.grad(y, (x, u), eye.repeat(H, 1))
        A = gx.reshape(H, n, n)
        B = gu.reshape(H, n, m)

        ts = torch.arange(H, device=xs.device)
        z = torch.cat([xs[:-1], us], -1).detach()
        rc = rc_z(n)
        g = torch.func.vmap(torch.func.grad(rc))(z, ts)                     # [H,n+m]
        hz = torch.func.vmap(torch.func.hessian(rc))(z, ts)                 # [H,n+m,n+m]
        cx, cu = g[:, :n], g[:, n:]
        cxx, cuu, cux = hz[:, :n, :n], hz[:, n:, n:], hz[:, n:, :n]
        tc = lambda x: terminal_cost(x[None])[0]
        xH = xs[-1].detach()
        vx = torch.func.grad(tc)(xH)
        vxx = torch.func.hessian(tc)(xH)
        return A, B, cx, cu, cxx, cuu, cux, vx, vxx

    def forward(f_dyn, x0, xs_ref, us_ref, ks, Ks, alphas):
        """Closed-loop rollouts with the new gains, one row per step size in
        ``alphas`` [A]: (us [A,H,m], cost [A], xs [A,H+1,n])."""
        nA = alphas.shape[0]
        x = x0.expand(nA, -1)
        acc = torch.zeros(nA, dtype=x0.dtype, device=x0.device)
        us, xs = [], []
        for t in range(H):
            u = us_ref[t] + alphas[:, None] * ks[t] + (x - xs_ref[t]) @ Ks[t].T
            u = torch.clamp(u, cfg.u_min, cfg.u_max)
            acc = acc + running_cost(x, u, torch.full((nA,), t, device=x0.device))
            xs.append(x)
            us.append(u)
            x = f_dyn(x, u)
        xs.append(x)
        return torch.stack(us, 1), acc + terminal_cost(x), torch.stack(xs, 1)

    @torch.no_grad()
    def initial_rollout(x0, u_init):
        """One rollout gives the initial trajectory [H+1,n] and its cost."""
        x = x0[None]
        xs = [x]
        for t in range(H):
            x = f(x, u_init[t][None])
            xs.append(x)
        xs = torch.cat(xs)
        cost0 = running_cost(xs[:-1], u_init, torch.arange(H, device=x0.device)).sum() \
            + terminal_cost(xs[-1:])[0]
        return xs, cost0

    def gains(xs, us, reg):
        """Linearize around (xs, us), then the backward pass: (ks, Ks)."""
        with _full_f32():
            exp = linearize(xs, us)
            with torch.no_grad():
                ks, Ks, _ = backward(*exp, reg)
        return ks, Ks

    @torch.no_grad()
    def line_search(x0, xs, us, ks, Ks):
        """The best candidate over ``alphas``: (us, cost, xs)."""
        # constants as fills on the device: a tensor built from a Python
        # list would be a blocking host-to-device copy
        alphas = torch.cat([torch.full((1,), a, device=x0.device) for a in cfg.alphas])
        if f_surrogate is not None:
            _, sur_costs, _ = forward(f_surrogate, x0, xs, us, ks, Ks, alphas)
            alpha_b = torch.index_select(alphas, 0, torch.argmin(sur_costs).reshape(1))
            best_us, best_cost, best_xs = forward(f, x0, xs, us, ks, Ks, alpha_b)
            return best_us[0], best_cost[0], best_xs[0]
        cand_us, cand_costs, cand_xs = forward(f, x0, xs, us, ks, Ks, alphas)
        best = torch.argmin(cand_costs).reshape(1)
        return (torch.index_select(cand_us, 0, best)[0],
                torch.index_select(cand_costs, 0, best)[0],
                torch.index_select(cand_xs, 0, best)[0])

    def plan(x0, u_init):
        xs, cost0 = initial_rollout(x0, u_init)
        us, cost = u_init, cost0
        reg = torch.full((), cfg.reg_init, device=x0.device)
        hist = []
        for _ in range(cfg.iterations):
            ks, Ks = gains(xs, us, reg)
            best_us, best_cost, best_xs = line_search(x0, xs, us, ks, Ks)
            improved = best_cost < cost
            us = torch.where(improved, best_us, us)
            xs = torch.where(improved, best_xs, xs)
            cost = torch.minimum(best_cost, cost)
            reg = torch.clamp(
                torch.where(improved, reg * 0.5, reg * 10.0), cfg.reg_init, cfg.reg_max
            )
            hist.append(cost)
        history = torch.stack(hist) if hist else cost0.new_zeros(0)
        return us, {"cost": cost, "cost0": cost0, "history": history}

    # the steps of a solve, for timing them apart
    plan.initial_rollout = initial_rollout
    plan.linearize = linearize
    plan.backward = backward
    plan.line_search = line_search
    return plan


class _TwinGrad(torch.autograd.Function):
    """``full(x, u)`` forward, the VJP of ``twin(x, u)`` backward: the
    counterpart of the reference's ``custom_vjp``. The backward replays
    ``twin`` under autograd on the saved inputs."""

    @staticmethod
    def forward(ctx, full, twin, x, u):
        ctx.twin = twin
        ctx.save_for_backward(x, u)
        return full(x, u)

    @staticmethod
    def backward(ctx, g):
        x, u = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            u_ = u.detach().requires_grad_(True)
            gx, gu = torch.autograd.grad(ctx.twin(x_, u_), (x_, u_), g)
        return None, None, gx, gu


def twin_grad(full, twin):
    """``f(x, u)``: forward by ``full``, gradient by ``twin`` (``f.f_grad``
    is ``twin``)."""

    def f(x, u):
        return _TwinGrad.apply(full, twin, x, u)

    f.f_grad = twin
    return f


def _flat_layout(fields):
    """(ravel, unravel) for named fields of given shapes: ``ravel(dict of
    [B,*shape]) -> [B,n]`` in the given order, and ``unravel(x [...,n])``
    a dict of views of ``x`` (slices and reshapes only).
    ``unravel.layout`` is the ``(name, shape)`` order."""
    offs, o = [], 0
    for name, shape in fields:
        size = int(np.prod(shape))
        offs.append((name, shape, o, size))
        o += size

    def unravel(x):
        lead = x.shape[:-1]
        return {name: x[..., a : a + s].reshape(*lead, *shape) for name, shape, a, s in offs}

    def ravel(d):
        B = next(iter(d.values())).shape[0]
        return torch.cat([d[name].reshape(B, -1) for name, *_ in offs], -1)

    unravel.layout = tuple(fields)
    return ravel, unravel


def _one_env(state):
    """The first env of a batched state, keeping a batch axis of 1 (a state
    without a batch axis gets one)."""
    batched = state.group.dim() == 2

    def walk(x):
        if isinstance(x, tuple):
            return type(x)(*map(walk, x))
        return x[:1] if batched else x[None]

    return walk(state)


def flatten_env_dynamics(env, template_state, substeps: int | None = None,
                         smooth_grads: bool = True):
    """Adapt an env to flat-vector dynamics for iLQR.

    Differentiates the *continuous* physics only: the returned ``f`` maps
    the flattened continuous fields (part poses, plus part velocities and
    joint state for an arm env, plus the cursor positions for the cursor
    env) through ``substeps`` physics substeps, with the discrete
    bookkeeping (rigid groups, selections, weld masks, counters) frozen at
    ``template_state``'s first env. ``f`` follows the batched convention of
    :func:`make_ilqr`.

    Cursor env: part velocities are zeroed every control step, so they are
    not part of the flat state. The holding pattern is frozen on the host
    at build time: each cursor that holds a part moves and rotates that
    part's group, the held groups are gravity-compensated, and the
    non-smooth boundary reverts of the real step are left out. ``f``'s
    forward runs the env's full physics (the free-part kernel on the card,
    its plain version on the CPU, or the lane backend under
    ``use_pallas="lane"``), inside a ``torch.autograd.Function`` whose
    backward is the VJP of a plain twin: with ``smooth_grads=True`` the
    same step with the contact solver disabled (``solver_iters=0``; also
    ``f.f_smooth``), with ``False`` the plain warm-started physics itself.

    Arm env: ``f``'s forward is the coupled arm step (the arm kernel on the
    card), its backward replays the plain version under autograd,
    ``joint_dyn_matrices`` included; there is no surrogate.

    Returns ``(f, x0 [n], unravel)``. The flat order is the port's own
    (``unravel.layout``): ``pos``, ``quat``, then ``lin_vel``, ``ang_vel``,
    ``qpos``, ``qvel`` for an arm env, or ``cursor_pos`` for the cursor
    env; ``convert.ilqr_flat_from_jax`` maps the reference's flat order
    onto it."""
    from ..envs.cursor import CursorEnv

    tmpl = _one_env(template_state)
    P = tmpl.parts.pos.shape[1]
    is_cursor = isinstance(env, CursorEnv)
    fields = [("pos", (P, 3)), ("quat", (P, 4))]
    if not is_cursor:
        nj = tmpl.qpos.shape[1]
        fields += [("lin_vel", (P, 3)), ("ang_vel", (P, 3)), ("qpos", (nj,)), ("qvel", (nj,))]
    else:
        fields += [("cursor_pos", (2, 3))]
    ravel, unravel = _flat_layout(fields)
    cont = {"pos": tmpl.parts.pos, "quat": tmpl.parts.quat}
    if is_cursor:
        cont["cursor_pos"] = tmpl.cursor_pos
    else:
        cont.update(lin_vel=tmpl.parts.lin_vel, ang_vel=tmpl.parts.ang_vel,
                    qpos=tmpl.qpos, qvel=tmpl.qvel)
    x0 = ravel(cont)[0].detach().clone()
    n_sub = substeps or env.config.n_substeps
    if is_cursor:
        f = _cursor_dynamics(env, tmpl, ravel, unravel, n_sub, smooth_grads)
    else:
        f = _arm_dynamics(env, tmpl, ravel, unravel, n_sub)
    return f, x0, unravel


def _cursor_dynamics(env, tmpl, ravel, unravel, n_sub, smooth_grads):
    cfg = env.config
    dev = env.device
    group0 = tmpl.group.contiguous()                                 # [1,P]
    sel = [int(s) for s in tmpl.selected[0].tolist()]                # host, once
    held0 = torch.zeros_like(group0, dtype=torch.bool)
    for s in sel:
        if s >= 0:
            held0 = held0 | (group0 == group0[:, s : s + 1])
    gscale0 = torch.where(held0, 0.0, 1.0)
    one_hot = torch.eye(2, device=dev)[:, :, None]                   # [2(i),2,1]

    def make_f(physics):
        def f(x, u):
            B = x.shape[0]
            c = unravel(x)
            parts = PartState(
                pos=c["pos"], quat=c["quat"],
                lin_vel=torch.zeros_like(c["pos"]), ang_vel=torch.zeros_like(c["pos"]),
            )
            group = group0.expand(B, -1)
            cursor = c["cursor_pos"]
            for i in range(2):
                act = u[:, 7 * i : 7 * i + 7]
                move = act[:, :3] * cfg.move_speed
                cursor = cursor + one_hot[i] * move[:, None]
                if sel[i] < 0:
                    continue
                base = torch.full((B,), sel[i], dtype=torch.long, device=dev)
                target_quat = T.euler_to_quat(act[:, 3:6] * cfg.rotate_speed, parts.quat[:, sel[i]])
                parts = env.ops.move_group(parts, group, base, move, target_quat)
            cursor = torch.clamp(cursor, -cfg.cursor_boundary, cfg.cursor_boundary)
            parts = physics(parts, group, gscale0.expand(B, -1), n_sub)
            return ravel({"pos": parts.pos, "quat": parts.quat, "cursor_pos": cursor})

        return f

    def full_physics(parts, group, gscale, n):
        return env._physics(parts, group, gscale, n)

    f_full = make_f(full_physics)
    if smooth_grads:
        # the contact-free twin: the same substep with the solver disabled.
        # Always the warm-started solve of engine.py (at 0 iterations it
        # applies no impulse, as the lane solver's 0 sweeps would), which
        # is plain PyTorch on every device and so has a gradient
        smooth = make_substep(
            env.tables, dataclasses.replace(cfg.sim, solver_iters=0, use_pallas="off"), dev
        )
        f_smooth = make_f(lambda p, g, s, n: engine_substeps(smooth, p, g, s, n))
        f = twin_grad(f_full, f_smooth)
        f.f_smooth = f_smooth
        return f
    if cfg.sim.use_pallas == "lane":
        raise ValueError(
            "smooth_grads=False differentiates the full physics, and the lane "
            "solver's kernel has no gradient: use smooth_grads=True"
        )
    return twin_grad(f_full, make_f(env.physics.plain_substeps))


def _arm_dynamics(env, tmpl, ravel, unravel, n_sub):
    from ..robots import kinematics as K

    dev = env.device
    r = env.robot
    dt = env.config.sim.timestep
    group0 = tmpl.group.contiguous()
    ik = env.control_type in ("ik", "ik_quaternion")

    def make_f(control_step):
        def f(x, u):
            B = x.shape[0]
            c = unravel(x)
            arm_ctrl = {
                arm: u[:, : len(r.arm_actuators[arm])] if ik
                else u[:, 6 * i : 6 * i + len(r.arm_actuators[arm])]
                for i, arm in enumerate(env.arms)
            }
            ctrl = env._format_ctrl(arm_ctrl, {arm: u[:, -1] for arm in env.arms})
            qpos, qvel = c["qpos"].contiguous(), c["qvel"].contiguous()
            G1, G2 = K.joint_dyn_matrices(r, qpos, dt)
            parts = PartState(*(c[k].contiguous() for k in ("pos", "quat", "lin_vel", "ang_vel")))
            parts, qpos, qvel, _ = control_step(
                parts, group0.expand(B, -1).contiguous(),
                torch.ones((B, group0.shape[1]), device=dev), qpos, qvel, ctrl.contiguous(),
                torch.zeros((B, r.nj), device=dev), G1.contiguous(), G2.contiguous(), n_sub,
            )
            return ravel({"pos": parts.pos, "quat": parts.quat, "lin_vel": parts.lin_vel,
                          "ang_vel": parts.ang_vel, "qpos": qpos, "qvel": qvel})

        return f

    return twin_grad(make_f(env.physics.control_step), make_f(env.physics.plain_control_step))
