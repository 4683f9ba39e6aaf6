"""Closed-loop batched stepping: the RL collector's loop of ``VecEnv.step``.

Mix parameters: ``batch`` (envs), ``control_type`` (arm envs),
``action_low``/``action_high`` (uniform actions, drawn on the device from
the seed each step), ``warmup_steps`` (after the reset, part of set-up),
``compare_steps`` (rows kept for the comparison, drawn from the seed over
the window, with the window's last step besides), ``trace_steps`` (the
traced window) and ``checks`` (the limits).

The window runs ``VecEnv.step`` until ``--seconds`` have passed, finishes
the step under way and ends in a synchronisation. ``env_steps_per_s`` is
every env step of the window over the window's length; ``step_ms_p95`` the
95th percentile of the host time of every ``VecEnv.step`` call (which syncs
once, on ``done.any()``).
"""

from __future__ import annotations

import random
import time

import torch

from .. import checks, measure, program


def run(ctx) -> dict:
    mix = ctx.mix
    B = int(mix["batch"])
    vec = program.make_vec_env(ctx, B, ctx.seed_for("reset"))
    env = vec.env
    gen = program.generator(ctx, ctx.seed_for("actions"))
    lo, hi = float(mix["action_low"]), float(mix["action_high"])

    def draw():
        return torch.rand((B, env.dof), generator=gen, device=ctx.device) * (hi - lo) + lo

    vec.reset()
    warm = []
    for _ in range(int(mix["warmup_steps"])):
        warm.append(draw())
        vec.step(warm[-1])
    start = {"actions": warm, "state": vec.state}
    if ctx.trace:
        program.watch_launches(ctx, env)
        ctx.tracer.wrap(env, "step_batch", "bench.step_batch")
    launches0 = program.launch_counts(ctx, env)

    rng = random.Random(ctx.seed_for("rows"))
    k = int(mix["compare_steps"])
    kept, times = [], []
    unstable = torch.zeros((), dtype=torch.int64, device=ctx.device)
    n = 0
    last = None

    def one_step():
        nonlocal n, last, unstable
        a = draw()
        pre = vec.state
        t = time.perf_counter()
        obs, rew, done, info = vec.step(a)
        times.append(time.perf_counter() - t)
        unstable = unstable + info["unstable"].sum()
        row = (pre, a, obs, rew, done, info, vec.state)
        if n < k:
            kept.append(row)
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = row
        last = row
        n += 1

    ctx.setup_done()
    t0 = time.perf_counter()
    if ctx.trace:
        with ctx.tracer.window(ctx.device):
            for _ in range(int(mix["trace_steps"])):
                one_step()
    else:
        deadline = t0 + ctx.seconds
        while True:
            one_step()
            if time.perf_counter() >= deadline:
                break
    ctx.window_closed()
    elapsed = time.perf_counter() - t0
    if all(r is not last for r in kept):
        kept.append(last)
    launches = {o: c - launches0[o] for o, c in program.launch_counts(ctx, env).items()}
    return {
        "e2e": {
            "env_steps_per_s": measure.rate(n * B, elapsed),
            "step_ms_p95": measure.percentile(times, 95) * 1e3,
        },
        "attempted": n * B,
        "failed": int(unstable.item()),
        "traced_units": n,
        "counters": {"steps": n, "batch": B, "window_s": elapsed,
                     "step_ms": {f"p{q}": measure.percentile(times, q) * 1e3
                                 for q in (10, 50, 90, 99, 100)},
                     "launches": launches},
        "kept": {"start": start, "rows": kept},
    }


def _replay(ctx, ref, kept):
    """The reference's own reset and warm-up steps, then its step from each
    kept row's state: ``(start state, [step outputs])``."""
    B = int(ctx.mix["batch"])
    g = program.generator(ctx, ctx.seed_for("reset"))
    s = ref.reset_batch(B, g)
    for a in kept["start"]["actions"]:
        s = program.reference_vec_step(ref, s, a, g)[0]
    outs = [ref.step_batch(checks.rebuild(row[0], s), row[1]) for row in kept["rows"]]
    return s, outs


def check(ctx, kept, control: bool = False) -> dict:
    """``start_err``: the program's state after reset and warm-up against
    the reference's own from the same draws; ``step_err``: each kept step
    against the reference's step from the program's state before it. Rows
    are envs; each reads its widest gap."""
    t = time.perf_counter()
    B = int(ctx.mix["batch"])
    s, outs = _replay(ctx, program.make_reference(ctx), kept)

    def numbers_of(start, got):
        return {
            **checks.stats("start_err", [checks.row_gaps(start, s, B)]),
            **checks.stats("step_err", [checks.step_rows(g, w) for g, w in zip(got, outs)]),
        }

    numbers = numbers_of(kept["start"]["state"],
                         [(row[6], row[2], row[3], row[4], row[5]) for row in kept["rows"]])
    ctx.log(f"reference: {len(outs)} steps compared in {time.perf_counter() - t:.2f} s")
    if control:
        low = program.make_reference(ctx, state_dtype=getattr(torch, ctx.mix["control_dtype"]))
        numbers.update({f"control.{k}": v for k, v in numbers_of(*_replay(ctx, low, kept)).items()})
    return numbers
