"""Receding-horizon MPC on one env: the MPC engine's loop.

Mix parameters: ``horizon``, ``n_samples``, ``sigma``, ``temperature``,
``gamma`` (``MPPIConfig``), ``planner_sim`` (the ``SimConfig`` fields the
planner's internal model changes: a coarser, cheaper model than the one
executed), ``warmup_plans`` (part of set-up), ``compare_plans`` (plans
kept for the comparison, drawn from the seed over the window, with the
window's last plan besides), ``trace_plans`` (the traced window),
``control_dtype`` and ``checks`` (the limits).

Each plan is ``make_mppi(planner_env, cfg)``'s ``plan`` from the executed
env's state, with the noise drawn by the benchmark on the device from the
seed and passed as ``noise=``. A plan is complete when its first action has
been read to the host, as a controller sends it to the robot; that action
is then applied by one ``step_batch`` at B = 1 on the configuration's own
env, and the mean is shifted by one step. ``plans_per_s`` is the plans
completed in the window over the window's length (which ends with the plan
under way when ``--seconds`` have passed).
"""

from __future__ import annotations

import random
import time

import torch

from .. import checks, measure, program
from ..reference.planning.mppi import assembly_cost as ref_assembly_cost


def _cfg(mix, cls):
    return cls(horizon=int(mix["horizon"]), n_samples=int(mix["n_samples"]),
               temperature=float(mix["temperature"]), sigma=float(mix["sigma"]),
               gamma=float(mix["gamma"]))


def run(ctx) -> dict:
    from furniture_tpu_torch.planning import MPPIConfig, make_mppi

    mix = ctx.mix
    env = program.make_env(ctx)
    planner_env = program.make_env(ctx, mix["planner_sim"])
    cfg = _cfg(mix, MPPIConfig)
    plan = make_mppi(planner_env, cfg)
    # every step of the plan's rollout, as the planner's env returns it: the
    # comparison follows the rollout step by step (references only, no copy)
    rollout = []
    inner_step = planner_env.step_batch

    def recorded_step(states, actions):
        out = inner_step(states, actions)
        rollout.append(out)
        return out

    planner_env.step_batch = recorded_step
    g_noise = program.generator(ctx, ctx.seed_for("noise"))
    shape = (cfg.n_samples, cfg.horizon, env.dof)
    state = env.reset_batch(1, program.generator(ctx, ctx.seed_for("reset")))
    mean = torch.zeros((cfg.horizon, env.dof), device=ctx.device)
    zero = torch.zeros((1, env.dof), device=ctx.device)

    def one_plan(span):
        nonlocal state, mean
        noise = torch.randn(shape, generator=g_noise, device=ctx.device) * cfg.sigma
        rollout.clear()
        with span:
            new_mean, info = plan(state, mean, None, noise=noise)
        first = new_mean[0].cpu()            # the plan is complete: its action on the host
        pre, mean_in = state, mean
        state, obs, rew, done, inf = env.step_batch(state, first.to(ctx.device)[None])
        mean = torch.cat([new_mean[1:], zero])
        return {"state": pre, "mean": mean_in, "noise": noise, "new_mean": new_mean,
                "costs": info["costs"], "action": first, "rollout": list(rollout),
                "out": (state, obs, rew, done, inf)}

    start = state
    for _ in range(int(mix["warmup_plans"])):
        one_plan(ctx.tracer.span("bench.plan"))
    if ctx.trace:
        program.watch_launches(ctx, env)
        program.watch_launches(ctx, planner_env, mix["planner_sim"])
    launches0 = {**{f"planner.{k}": v for k, v in program.launch_counts(ctx, planner_env).items()},
                 **{f"executed.{k}": v for k, v in program.launch_counts(ctx, env).items()}}

    rng = random.Random(ctx.seed_for("rows"))
    k = int(mix["compare_plans"])
    kept = []
    unstable = 0
    n = 0
    last = None
    ctx.setup_done()
    t0 = time.perf_counter()

    def step():
        nonlocal n, last, unstable
        row = one_plan(ctx.tracer.span("bench.plan"))
        unstable += row["out"][4]["unstable"]
        if n < k:
            kept.append(row)
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = row
        last = row
        n += 1

    if ctx.trace:
        with ctx.tracer.window(ctx.device):
            for _ in range(int(mix["trace_plans"])):
                step()
    else:
        deadline = t0 + ctx.seconds
        while True:
            step()
            if time.perf_counter() >= deadline:
                break
    ctx.window_closed()
    elapsed = time.perf_counter() - t0
    if all(r is not last for r in kept):
        kept.append(last)
    launches = {**{f"planner.{k}": v for k, v in program.launch_counts(ctx, planner_env).items()},
                **{f"executed.{k}": v for k, v in program.launch_counts(ctx, env).items()}}
    return {
        "e2e": {"plans_per_s": measure.rate(n, elapsed)},
        "attempted": n,
        "failed": int(torch.as_tensor(unstable).sum().item()),
        "traced_units": n,
        "counters": {"plans": n, "window_s": elapsed,
                     "launches": {k: v - launches0[k] for k, v in launches.items()}},
        "kept": {"start": start, "rows": kept},
    }


class _Side:
    """The reference's executed env, planner env and cost (or, with
    ``state_dtype``, the control's)."""

    def __init__(self, ctx, state_dtype=None):
        self.env = program.make_reference(ctx, state_dtype=state_dtype)
        self.planner = program.make_reference(ctx, ctx.mix["planner_sim"], state_dtype=state_dtype)
        self.cost = ref_assembly_cost(self.planner)


def _gaps(got, want, B: int):
    """Row gaps, or every row ``NONFINITE`` where ``got`` does not have the
    reference's ``B`` rows (a rollout that left samples out)."""
    try:
        if checks.leaves(got)[0].shape[0] != B:
            raise ValueError
        return checks.row_gaps(got, want, B)
    except (ValueError, RuntimeError):
        return torch.full((B,), checks.NONFINITE, dtype=torch.float64)


def _follow(ctx, side, row, template):
    """One kept plan on ``side``, step by step from the program's rollout:
    each step from the program's state before it (the plan's state,
    broadcast, at the first) with the action the plan's mean and noise give;
    the costs and the new mean from those steps; the executed step.
    Returns ``(step outputs, costs, mean, executed step)``."""
    mix = ctx.mix
    samples = torch.clamp(row["mean"][None] + row["noise"], -1.0, 1.0)      # [S,H,dof]
    S, H = samples.shape[:2]
    state = checks.rebuild(row["state"], template)
    prev = _broadcast(state, S)
    total = torch.zeros(S, dtype=torch.float32, device=samples.device)
    disc = 1.0
    outs = []
    for h in range(H):
        want = side.planner.step_batch(prev, samples[:, h])
        outs.append(want)
        total = total + disc * (side.cost(want[0]) - want[2])
        disc = disc * float(mix["gamma"])
        if h < len(row["rollout"]) and checks.leaves(row["rollout"][h])[0].shape[0] == S:
            prev = checks.rebuild(row["rollout"][h][0], template)
        else:
            prev = want[0]
    w = torch.softmax(-total / float(mix["temperature"]), dim=0)
    mean = torch.einsum("s,shd->hd", w, samples)
    executed = side.env.step_batch(state, row["action"].to(samples.device)[None])
    return outs, total, mean, executed


def _broadcast(state, S: int):
    if isinstance(state, tuple):
        return type(state)(*(_broadcast(x, S) for x in state))
    return state.repeat((S,) + (1,) * (state.dim() - 1))


def check(ctx, kept, control: bool = False) -> dict:
    """Follows each kept plan step by step from the program's own rollout
    (the rollout of 64 steps amplifies any rounding into gaps that no limit
    separates from a lower precision's): ``roll_err``, each rollout step
    (rows: samples x steps) against the reference's step from the
    program's state before it; ``cost_err``, the plan's sample costs
    against the reference's sums over those steps; ``mean_err``, the new
    mean (rows: entries) against the reference's softmax-weighted mean of
    those costs; ``exec_err``, the executed step; ``start_err``, the
    executed env's reset against the reference's own from the same draws."""
    t = time.perf_counter()
    sides = {"": _Side(ctx)}
    if control:
        sides["control."] = _Side(ctx, getattr(torch, ctx.mix["control_dtype"]))
    ref = sides[""]
    start = ref.env.reset_batch(1, program.generator(ctx, ctx.seed_for("reset")))
    rows = {name: {"start_err": [], "roll_err": [], "cost_err": [], "mean_err": [],
                   "exec_err": []} for name in sides}
    for name, side in sides.items():
        got = kept["start"] if not name else side.env.reset_batch(
            1, program.generator(ctx, ctx.seed_for("reset")))
        rows[name]["start_err"].append(checks.row_gaps(got, start, 1))
    for row in kept["rows"]:
        want = _follow(ctx, ref, row, start)
        S, n = want[1].shape[0], want[2].numel()
        for name, side in sides.items():
            if name:
                got = _follow(ctx, side, row, start)
            else:
                got = (row["rollout"], row["costs"], row["new_mean"], row["out"])
            r = rows[name]
            r["roll_err"] += [_gaps(g, w, S) for g, w in zip(got[0], want[0])]
            r["roll_err"] += [torch.full((S,), checks.NONFINITE, dtype=torch.float64)] * (
                len(want[0]) - len(got[0]))
            r["cost_err"].append(_gaps(got[1][:, None], want[1][:, None], S))
            r["mean_err"].append(_gaps(got[2].reshape(-1, 1), want[2].reshape(-1, 1), n))
            r["exec_err"].append(checks.step_rows(got[3], want[3]))
    numbers = {}
    for name, r in rows.items():
        for q, v in r.items():
            numbers.update({name + k: x for k, x in checks.stats(q, v).items()})
    ctx.log(f"reference: {len(kept['rows'])} plans followed in {time.perf_counter() - t:.2f} s")
    return numbers
