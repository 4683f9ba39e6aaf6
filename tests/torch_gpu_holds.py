"""Holds of the port's CUDA kernels against their plain versions, for the
card-only test files (``tests/test_torch_*_gpu.py``).

A path's own kernel inputs are recorded (``recording``) on one step of it
and held there (``assert_held``): kernel 1 by ``hold_free``, kernel 2 by
``hold_arm``. A rollout's late state may pin a part against the fingers,
or hold parts at the velocity clamp in contact, where the plain version
itself jumps by far more than the bound in a few envs: so a recorded call
is held by the rule for such a state, the median over the envs within the
bound, at most a tenth of them over it, and every env within 10x the plain
version's own spread. ``staged_connects`` stages the connect attempts that
the connect kernel is held on (the cells' random actions rarely connect).
Imports neither JAX nor the JAX package.
"""

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.physics import engine, lane_solver
from furniture_tpu_torch.physics.state import PartState
from furniture_tpu_torch.robots import kinematics as K

NOISE_DRAWS = 20    # per noise size, for the plain version's own spread in an env
ARM_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "qpos", "qvel")


def card(monkeypatch=None):
    """The card, with TF32 off (through ``monkeypatch``, where given, so
    that the flag is restored after the test); skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    if monkeypatch is None:
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def float64_twin(robot):
    """A twin of ``robot`` whose cached constant tables are float64, for the
    plain versions' float64 truth on the CPU."""
    twin = dataclasses.replace(robot)
    t = K.robot_tables(twin, "cpu")
    for k, v in list(t.items()):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            t[k] = v.double()
        elif isinstance(v, dict):
            t[k] = {a: x.double() for a, x in v.items()}
    return twin


def p90_gap(x, truth) -> float:
    """The rows' 90th percentile of their largest gap to the truth."""
    d = (x.cpu().double() - truth).abs().reshape(x.shape[0], -1).amax(1)
    return torch.quantile(d, 0.9).item()


def record_calls(owner, name: str, keep: int):
    """Replace the method ``owner.name`` by one that also keeps copies of
    the inputs of its last ``keep`` calls, in the deque returned."""
    calls = collections.deque(maxlen=keep)
    inner = getattr(owner, name)

    def own(a):
        if isinstance(a, PartState):
            return PartState(*map(own, a))
        return a.clone(memory_format=torch.contiguous_format) if torch.is_tensor(a) else a

    def record(*args):
        calls.append(tuple(map(own, args)))
        return inner(*args)

    setattr(owner, name, record)
    return calls


class recording:
    """``with recording(env, keep) as calls:`` keeps the inputs of the last
    ``keep`` physics calls ``env`` makes in the block: a cursor env's
    ``_physics(parts, group, gscale, n)``, an arm env's
    ``physics.control_step(parts, group, gscale, qpos, qvel, ctrl,
    tau_extra, G1, G2, n)``."""

    def __init__(self, env, keep: int):
        arm = hasattr(env.physics, "control_step")
        self.owner, self.name = (env.physics, "control_step") if arm else (env, "_physics")
        self.keep = keep

    def __enter__(self):
        return record_calls(self.owner, self.name, self.keep)

    def __exit__(self, *exc):
        delattr(self.owner, self.name)
        return False


def env_max(x, y):
    """max |x - y| in each env over the tensors of two sequences: [B]."""
    B = x[0].shape[0]
    return torch.stack([(u - v.to(u.device)).abs().reshape(B, -1).amax(-1) for u, v in zip(x, y)]).amax(0)


def pose_noise(parts, mag: float, seed: int):
    """``parts`` with uniform noise of ``mag`` on the positions and the
    quaternions (renormalised), drawn from ``seed``."""
    dev = parts.pos.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    eps = (torch.rand(parts.pos.shape, generator=g, device=dev) - 0.5) * 2 * mag
    q = parts.quat + (torch.rand(parts.quat.shape, generator=g, device=dev) - 0.5) * 2 * mag
    return parts._replace(pos=parts.pos + eps, quat=q / torch.linalg.norm(q, dim=-1, keepdim=True))


def contact_ties(phys, parts, group, gscale, n: int):
    """[B] bool: the envs where, in some substep of the plain run, a lane's
    depth lies within 4 float32 ulp (of the largest coordinate of the env's
    parts) of the contact threshold ``-slop``, over the floor lanes and every
    lane whose geometric mask is set. Whether such a lane acts is decided by
    rounding, which no noise on the poses moves when the floor projection
    pins the lane there (a plate whose half thickness equals the slop,
    lifted onto its deepest corner each substep)."""
    sub, slop = phys._plain, phys.cfg.contact_slop
    B, dev = parts.pos.shape[0], parts.pos.device
    lam = torch.zeros((B, sub.n_base_lanes, 3), device=dev)
    margin = torch.full((B,), float("inf"), device=dev)
    st = parts
    for _ in range(n):
        c = sub.solver_args(st, group, gscale)[1][0]
        held = c.mask | (torch.arange(c.depth.shape[1], device=dev) < phys.Kf)
        gap = torch.where(held, (c.depth + slop).abs(), torch.full_like(c.depth, float("inf")))
        margin = torch.minimum(margin, gap.amin(-1))
        st, lam = sub(st, group, gscale, lam)
    return margin < 4 * torch.finfo(torch.float32).eps * parts.pos.abs().reshape(B, -1).amax(-1)


def hold_free(phys, parts, group, gscale, n: int, tol: float, chaotic: bool = False) -> dict:
    """Kernel 1 against its plain version after ``n`` substeps, env by env.
    Each env is held to ``tol`` or to 10x the plain version's own spread in
    that env, the larger: the largest change of the plain result under
    ``NOISE_DRAWS`` draws each of 1e-7 and 1e-6 of pose noise and, in an env
    with a lane on the contact threshold (``contact_ties``), under the
    threshold moved by 8 ulp either way. The median over the envs is held to
    ``tol``, and at most a tenth of them may exceed it; with ``chaotic``
    these two limits count only the envs whose own spread is within ``tol``
    (in the others the plain version itself is chaotic at that bound). The
    spread is measured only where an env exceeds ``tol``. The outputs must be
    finite and two launches bit-identical. Returns the numbers and
    ``problem``, the first limit broken, or None."""
    parts = PartState(*(t.contiguous() for t in parts))
    group, gscale = group.contiguous(), gscale.contiguous()
    B = parts.pos.shape[0]
    ref = phys.plain_substeps(parts, group, gscale, n)
    out = phys.kernel_substeps(parts, group, gscale, n)
    again = phys.kernel_substeps(parts, group, gscale, n)
    torch.cuda.synchronize()
    env_err = env_max(ref, out)
    spread, ties = None, torch.zeros_like(env_err, dtype=torch.bool)
    bound = torch.full_like(env_err, tol)
    if bool((env_err > tol).any()):
        spread = torch.zeros_like(env_err)
        for mag in (1e-7, 1e-6):
            for seed in range(NOISE_DRAWS):
                spread = torch.maximum(spread, env_max(ref, phys.plain_substeps(
                    pose_noise(parts, mag, 100 + seed), group, gscale, n)))
        ties = contact_ties(phys, parts, group, gscale, n)
        if bool(ties.any()):
            slop = phys.cfg.contact_slop
            d = 8 * torch.finfo(torch.float32).eps * parts.pos.abs().max().item()
            for s in (slop - d, slop + d):
                moved = engine.make_substep(phys.model_np, dataclasses.replace(
                    phys.cfg, contact_slop=s, use_pallas="off"), phys.device)
                spread = torch.where(ties, torch.maximum(spread, env_max(
                    ref, engine.substeps(moved, parts, group, gscale, n))), spread)
        bound = torch.clamp(10 * spread, min=tol)
    counted = spread <= tol if chaotic and spread is not None else torch.ones_like(ties)
    med = env_err[counted].median().item() if bool(counted.any()) else 0.0
    over = int((env_err[counted] > tol).sum())
    i = int(torch.argmax(env_err / bound))
    h = {"n": n, "tol": tol, "err": env_err.max().item(), "median": med, "envs_over": over,
         "env": i, "env_err": env_err[i].item(), "bound": bound[i].item(),
         "spread": None if spread is None else spread.max().item(), "problem": None}
    if not all(bool(torch.isfinite(t).all()) for t in out):
        h["problem"] = "kernel output not finite"
    elif not all(torch.equal(a, b) for a, b in zip(out, again)):
        h["problem"] = "two launches on one input differ"
    elif not med <= tol:
        h["problem"] = f"median error {med} > {tol}"
    elif over > B // 10:
        h["problem"] = f"{over} envs over {tol}"
    elif not bool((env_err <= bound).all()):
        h["problem"] = f"env {i} over {tol} and over 10x the plain version's own spread there"
    return h


def arm_per_env(a, b):
    """max |a - b| per env and field of two arm results: {field: [B]}."""
    B = a[1].shape[0]
    pairs = list(zip(a[0], b[0])) + [(a[1], b[1]), (a[2], b[2])]
    return {f: (x - y).abs().reshape(B, -1).amax(-1) for f, (x, y) in zip(ARM_FIELDS, pairs)}


def hold_arm(ph, args, n: int, tol: float, pinched: bool) -> dict:
    """Kernel 2 against its plain version after ``n`` substeps from
    ``args``, the inputs of one ``control_step`` call but its ``n``. The
    outputs must be finite, two launches bit-identical and the touch flags
    equal. Plain, the maximum is held to ``tol``. A ``pinched`` case (a part
    between kinematic pads) is ill-conditioned in a few envs: its median
    over the envs is held to ``tol``, at most a tenth of the envs may exceed
    it, and its maximum is held to 10x the plain version's own spread under
    three draws each of 1e-7 and 1e-6 of position noise, measured only where
    an env exceeds ``tol``. Returns the numbers and ``problem``, the first
    limit broken, or None."""
    args = tuple(args) + (n,)
    B = args[3].shape[0]
    ref = ph.plain_control_step(*args)
    out = ph.kernel_control_step(*args)
    again = ph.kernel_control_step(*args)
    torch.cuda.synchronize()
    errs = arm_per_env(ref, out)
    env_err = torch.stack(list(errs.values())).amax(0)
    err = env_err.max().item()
    med = max(v.median().item() for v in errs.values())
    h = {"n": n, "tol": tol, "err": err, "median": med, "envs_over": int((env_err > tol).sum()),
         "bound": tol, "n_touch": int(out[3].sum()), "problem": None}
    if pinched and err > tol:
        # one substep of summing ~1000 lanes in another order already moves
        # the velocities by up to 7e-5, which 1e-7 of position noise does not
        # always reproduce: hence also 1e-6
        worst = 0.0
        for mag in (1e-7, 1e-6):
            for seed in (7, 8, 9):
                g = torch.Generator(device=args[0].pos.device)
                g.manual_seed(seed)
                eps = (torch.rand(args[0].pos.shape, generator=g, device=g.device) - 0.5) * 2 * mag
                ref2 = ph.plain_control_step(args[0]._replace(pos=args[0].pos + eps), *args[1:])
                worst = max(worst, max(v.max().item() for v in arm_per_env(ref, ref2).values()))
        h["bound"] = max(tol, 10 * worst)
    if not all(bool(torch.isfinite(t).all()) for t in list(out[0]) + [out[1], out[2]]):
        h["problem"] = "arm kernel output not finite"
    elif not all(torch.equal(b, c) for b, c in zip(list(out[0]) + list(out[1:]),
                                                   list(again[0]) + list(again[1:]))):
        h["problem"] = "two launches of the arm kernel on one input differ"
    elif not torch.equal(ref[3], out[3]):
        h["problem"] = "touch flags differ between arm kernel and plain version"
    elif pinched and not med <= tol:
        h["problem"] = f"median error {med} > {tol}"
    elif pinched and h["envs_over"] > B // 10:
        h["problem"] = f"{h['envs_over']} envs over {tol}"
    elif not err <= h["bound"]:
        h["problem"] = f"arm kernel disagrees with its plain version ({err} > {h['bound']})"
    return h


def kernel1_gap(phys, parts, group, gscale, n: int) -> float:
    """max |kernel 1 - plain| after ``n`` substeps over every field; the
    kernel's outputs must be finite and two launches bit-identical (the
    sums are taken in a fixed order, no float atomics)."""
    parts = PartState(*(t.contiguous() for t in parts))
    group, gscale = group.contiguous(), gscale.contiguous()
    ref = phys.plain_substeps(parts, group, gscale, n)
    out = phys.kernel_substeps(parts, group, gscale, n)
    again = phys.kernel_substeps(parts, group, gscale, n)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    return max((a - b).abs().max().item() for a, b in zip(ref, out))


def arm_args(env, state, ctrl):
    """The inputs of one ``control_step`` call of ``env`` but its ``n``,
    from ``state`` under ``ctrl``."""
    B = ctrl.shape[0]
    G1, G2 = K.joint_dyn_matrices(env.robot, state.qpos, env.config.sim.timestep)
    return (PartState(*(t.contiguous() for t in state.parts)), state.group,
            torch.ones((B, env._P), device=ctrl.device), state.qpos, state.qvel, ctrl,
            torch.zeros((B, env.robot.nj), device=ctrl.device), G1.contiguous(), G2.contiguous())


def hold_lane(tables, args, sweeps=(12, 24), exact=False):
    """Kernel 3 (one launch on ``tables``) against its plain version at each
    of ``sweeps`` within 1e-4 on both velocities, two launches bit-identical,
    and against the cold ``engine._solve_contacts`` within 2e-3 (linear) and
    5e-3 (angular) plus 1e-3 relative. ``exact``: no lane has a contact, so
    the velocities come back as they went in; otherwise the solve moves them
    by over 1e-3."""
    c = args[0]
    lam = torch.zeros(c.depth.shape + (3,), device=c.depth.device)
    for iters in sweeps:
        a = args[:8] + (iters,) + args[9:]
        lv, av, _ = lane_solver.launch(tables, *a)
        lv2, av2, _ = lane_solver.launch(tables, *a)
        rl, ra = lane_solver.plain_solve_contacts_lane(*a)
        wl, wa, _, _ = engine._solve_contacts(*a, lam)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(lv).all() and torch.isfinite(av).all()), iters
        assert torch.equal(lv, lv2) and torch.equal(av, av2), iters
        assert (lv - rl).abs().max().item() < 1e-4, iters
        assert (av - ra).abs().max().item() < 1e-4, iters
        assert bool(((lv - wl).abs() <= 2e-3 + 1e-3 * wl.abs()).all()), iters
        assert bool(((av - wa).abs() <= 5e-3 + 1e-3 * wa.abs()).all()), iters
        if exact:
            assert torch.equal(lv, a[5]) and torch.equal(av, a[6]), iters
        else:
            assert (lv - a[5]).abs().max().item() > 1e-3, iters


def hold_call(phys, call) -> list:
    """The kernel of one recorded call against its plain version after 5
    substeps (5e-4 for kernel 2, 1e-4 for kernel 1; n where n <= 5) and after
    the call's own n (1e-3): kernel 2 for an arm call (``hold_arm``,
    pinched), kernel 1 for a free-part call (``hold_free``)."""
    n, arm = call[-1], len(call) == 10
    short = 5e-4 if arm else 1e-4
    checks = ((n, short),) if n <= 5 else ((5, short), (n, 1e-3))
    if arm:
        return [hold_arm(phys, call[:-1], m, tol, True) for m, tol in checks]
    return [hold_free(phys, *call[:3], m, tol) for m, tol in checks]


def assert_held(phys, calls, what=""):
    """Every recorded call of ``calls`` held by ``hold_call``."""
    assert calls, f"{what}: no physics call recorded"
    for k, call in enumerate(calls):
        for h in hold_call(phys, call):
            assert h["problem"] is None, (what, k, h)


# -- staged connects, for the connect kernel (envs/assembly.py, csrc/assembly.cu) --


class ConnectState(NamedTuple):
    """The assembly fields of an env state: what a connect attempt reads and
    writes (``AssemblyOps.attempt`` takes any state that has them)."""

    parts: PartState
    group: torch.Tensor
    conn_connected: torch.Tensor
    weld_active: torch.Tensor
    num_connected: torch.Tensor
    subtask: torch.Tensor
    connect_step: torch.Tensor
    connected_body1: torch.Tensor
    connected_body1_pos: torch.Tensor
    connected_body1_quat: torch.Tensor


def _axis_quat(axis, deg):
    return T.quat_from_axis_angle(axis, torch.deg2rad(deg))


def _unit_rows(rng, n: int):
    v = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    return v / v.norm(dim=-1, keepdim=True)


def _pick(rng, pairs, conn_part, state, active):
    """Per env a random site pair of ``pairs`` [n,2], both sites free and
    their parts in two groups, where ``active``: ``(i [B], j [B], found
    [B])``."""
    g, used = state.group.numpy(), state.conn_connected.numpy()
    gi, gj = g[:, conn_part[pairs[:, 0]]], g[:, conn_part[pairs[:, 1]]]
    valid = (gi != gj) & ~used[:, pairs[:, 0]] & ~used[:, pairs[:, 1]] & active[:, None]
    k = np.argmax(np.where(valid, rng.random(valid.shape), -1.0), 1)
    ok = valid.any(1)
    return (torch.as_tensor(pairs[k, 0]), torch.as_tensor(pairs[k, 1]),
            torch.as_tensor(ok))


def staged_connects(name: str, B: int, seed: int, arms: int = 0):
    """``B`` envs of furniture ``name`` on the CPU, staged for a connect
    attempt as ``preassemble`` places sites: ``(ops, state, connect,
    held, touch, staged)``, ``held`` the cursors' parts [B,2] where
    ``arms`` is 0, else ``touch`` = (touch_l, touch_r) [B,arms,P].

    Every env: the parts as a reset places them, turned about the world z
    axis by a random yaw and tilted 5-40 degrees about a horizontal axis (so
    that no target frame lies at a tie of ``mat_to_quat``'s four cases,
    where the quaternion's sign follows the rounding: the axis-aligned
    sites of ``bookcase_besta_0170`` level two of its scores), a fifth of
    the envs lowered 0.1-0.3 m (a snap there lifts); random velocities; 0, 1, 2 or W - 1 welds made first by
    ``snap_connect`` (so a group that is already welded merges with
    another, and a snap may close the last weld). Then a random
    complementary site pair in two groups, site j's group moved onto site i
    at one of i's table angles (a free-angle site: 5-175 degrees either
    way): in the window (twist and tilt under 12 degrees; the sites at most
    4 cm apart, or 6-9 cm along site i's up) or out of it by one threshold
    (12-30 cm apart; 6-9 cm across site i's up; twist 35-55 degrees off a
    table angle; tilt 35-60 degrees). ``connect_step`` is the snap's count
    in half the envs, below it elsewhere; the press is negative in 15% of
    the envs; a cursor lets go in 10%; the fingers of some arm both touch
    site i's part first in 70%, none touch with both in 15%; a tenth of
    the envs carry a snap-back (``connected_body1 >= 0``) in. ``staged``
    [B] is True where a pair was placed."""
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.assembly import AssemblyOps, sample_placement, tree_where
    from furniture_tpu_torch.models import compile_model

    f32 = torch.float32
    m = compile_model(name)
    cfg = EnvConfig(furniture_name=name)
    ops = AssemblyOps(m, cfg, "cpu")
    rng = np.random.default_rng(seed)
    P, C, W = m.n_parts, m.n_conn, m.n_welds
    pos, quat = sample_placement(m, cfg, B, torch.Generator().manual_seed(seed), "cpu")
    zq = _axis_quat(torch.tensor([0.0, 0.0, 1.0]).expand(B, 3),
                    torch.as_tensor(rng.uniform(0, 360, B), dtype=f32))
    flat = torch.as_tensor(np.concatenate([rng.normal(size=(B, 2)), np.zeros((B, 1))], 1), dtype=f32)
    zq = T.quat_mul(_axis_quat(flat / flat.norm(dim=-1, keepdim=True),
                               torch.as_tensor(rng.uniform(5, 40, B), dtype=f32)), zq)
    pos = T.quat_rotate(zq[:, None], pos)
    quat = T.quat_mul(zq[:, None], quat)
    low = np.where(rng.random(B) < 0.2, rng.uniform(0.1, 0.3, B), 0.0)
    pos[..., 2] -= torch.as_tensor(low, dtype=f32)[:, None]
    vel = lambda: torch.as_tensor(rng.normal(0, 0.1, (B, P, 3)), dtype=f32)
    i32 = lambda v, shape: torch.full(shape, v, dtype=torch.int32)
    state = ConnectState(
        parts=PartState(pos, quat, vel(), vel()),
        group=torch.arange(P, dtype=torch.int32)[None].repeat(B, 1),
        conn_connected=torch.zeros((B, C), dtype=torch.bool),
        weld_active=torch.zeros((B, W), dtype=torch.bool),
        num_connected=i32(0, (B,)), subtask=ops.initial_subtask(B), connect_step=i32(0, (B,)),
        connected_body1=i32(-1, (B,)), connected_body1_pos=torch.zeros((B, 3)),
        connected_body1_quat=torch.tensor([1.0, 0, 0, 0]).repeat(B, 1),
    )
    cp = np.asarray(m.conn_part)
    pa, pb = np.asarray(m.conn_pair_a), np.asarray(m.conn_pair_b)
    pairs = np.argwhere((pa[:, None] == pb[None]) & (pb[:, None] == pa[None]))
    lookup = np.asarray(m.weld_lookup)
    weldable = pairs[lookup[cp[pairs[:, 0]], cp[pairs[:, 1]]] >= 0]

    # welds made first
    n_pre = rng.choice([0, 1, 2, max(W - 1, 0)], B, p=[0.4, 0.25, 0.15, 0.2])
    for r in range(int(n_pre.max()) if len(weldable) else 0):
        i, j, ok = _pick(rng, weldable, cp, state, n_pre > r)
        _, cquat = ops.conn_world(state.parts)
        snapped = ops.snap_connect(state, i, j, cquat[torch.arange(B), i])
        state = tree_where(ok, snapped, state)
    state = state._replace(connected_body1=i32(-1, (B,)), connect_step=i32(0, (B,)))

    # the staged pair
    i, j, staged = _pick(rng, pairs, cp, state, np.ones(B, bool))
    cpos, cquat = ops.conn_world(state.parts)
    ar = torch.arange(B)
    pos_i, q_i = cpos[ar, i], cquat[ar, i]
    up_i = T.up_vector_from_quat(q_i)
    has = torch.as_tensor(np.asarray(m.conn_has_angles))[i]
    amask = np.asarray(m.conn_angle_mask)[i.numpy()]
    a_idx = np.argmax(np.where(amask, rng.random(amask.shape), -1.0), 1)
    table = torch.as_tensor(np.asarray(m.conn_angles, np.float32)[i.numpy(), a_idx])
    sign = torch.as_tensor(rng.choice([-1.0, 1.0], B), dtype=f32)
    free = sign * torch.as_tensor(rng.uniform(5, 175, B), dtype=f32)
    kind = rng.choice(["near", "along", "far", "across", "twist", "tilt"], B,
                      p=[0.35, 0.25, 0.1, 0.1, 0.1, 0.1])
    twist = sign * torch.as_tensor(np.where(kind == "twist", rng.uniform(35, 55, B),
                                            rng.uniform(0, 12, B)), dtype=f32)
    angle = torch.where(has, table + twist, free)
    tilt = torch.as_tensor(np.where(kind == "tilt", rng.uniform(35, 60, B), rng.uniform(0, 12, B)),
                           dtype=f32)
    # the reference's up and forward vectors are rows of the frame: turning
    # the frame by r on the right turns them by r's inverse
    q_new = T.quat_mul(T.quat_mul(q_i, _axis_quat(up_i, -angle)),
                       _axis_quat(_unit_rows(rng, B), tilt))
    across = T.cross(up_i, _unit_rows(rng, B))
    across = across / across.norm(dim=-1, keepdim=True)
    mag = {"near": (0.0, 0.04), "along": (0.06, 0.09), "far": (0.12, 0.3), "across": (0.06, 0.09),
           "twist": (0.0, 0.04), "tilt": (0.0, 0.04)}
    lo, hi = (np.array([mag[k][e] for k in kind]) for e in (0, 1))
    size = torch.as_tensor(rng.uniform(lo, hi) * rng.choice([-1.0, 1.0], B), dtype=f32)[:, None]
    direction = torch.where(torch.as_tensor(kind == "far")[:, None], _unit_rows(rng, B),
                            torch.where(torch.as_tensor(kind == "across")[:, None], across, up_i))
    p2 = torch.as_tensor(cp)[j]
    site_j = state.parts.pos[ar, p2] + T.quat_rotate(q_new, torch.as_tensor(
        np.asarray(m.conn_pos, np.float32))[j])
    offset = pos_i + size * direction - site_j
    moved = ops.move_group(state.parts, state.group, p2, offset, q_new)
    state = state._replace(parts=tree_where(staged, moved, state.parts))

    n_conn = cfg.num_connect_steps
    step = np.where(rng.random(B) < 0.5, n_conn, rng.integers(0, max(n_conn, 1), B))
    back = rng.random(B) < 0.1
    b1 = torch.as_tensor(np.where(back, rng.integers(0, P, B), -1), dtype=torch.int32)
    b1c = b1.clamp(min=0).long()
    state = state._replace(
        connect_step=torch.as_tensor(step, dtype=torch.int32), connected_body1=b1,
        connected_body1_pos=state.parts.pos[ar, b1c] + torch.as_tensor(
            rng.uniform(-0.02, 0.02, (B, 3)), dtype=f32),
        connected_body1_quat=T.quat_normalize(state.parts.quat[ar, b1c] + torch.as_tensor(
            rng.normal(0, 0.05, (B, 4)), dtype=f32)),
    )
    connect = torch.as_tensor(np.where(rng.random(B) < 0.85, rng.uniform(0.1, 1, B),
                                       rng.uniform(-1, 0, B)), dtype=f32)
    held = touch = None
    pi = torch.as_tensor(cp)[i]
    if arms == 0:
        held = torch.stack([pi, p2], 1).to(torch.int32)
        let_go = torch.as_tensor(rng.random((B, 2)) < 0.05)
        held = torch.where(let_go, torch.full_like(held, -1), held)
    else:
        tl = torch.as_tensor(rng.random((B, arms, P)) < 0.15)
        tr = torch.as_tensor(rng.random((B, arms, P)) < 0.15)
        u = rng.random(B)
        first = torch.as_tensor(u < 0.7)
        none = torch.as_tensor((u >= 0.7) & (u < 0.85))
        lower = torch.arange(P)[None, None] < pi[:, None, None]
        tr = tr & ~(first[:, None, None] & lower) & ~none[:, None, None]
        arm = torch.as_tensor(rng.integers(0, arms, B))
        on = first[:, None, None] & (torch.arange(arms)[None, :, None] == arm[:, None, None]) & (
            torch.arange(P)[None, None] == pi[:, None, None])
        touch = (tl | on, tr | on)
    return ops, state, connect, held, touch, staged
