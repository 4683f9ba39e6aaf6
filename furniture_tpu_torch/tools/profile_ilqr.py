#!/usr/bin/env python
"""Where an iLQR solve's time goes, on the card.

The port's counterpart of ``tools/profile_ilqr.py``, with its output keys.
At ``bench.py``'s iLQR configuration (the cursor on table_lack_0825 with
``SimConfig(solver_iters=8)``, 10 substeps a planner step, cursor 0
holding part 0 driven to a target 18 cm away; horizon 64, 5 iterations,
5 step sizes, parallel Riccati) it times, as medians after a warm-up (CUDA
events on the card), the pieces of ``planning.ilqr.make_ilqr``:

* one full solve (``plan``);
* one 5-alpha line-search sweep (``plan.line_search``);
* one linearization (``plan.linearize``: the Jacobians of the
  contact-free twin under autograd and the cost expansions);
* one Riccati backward pass (``plan.backward``) on that linearization;
* one 64-step open-loop rollout (``plan.initial_rollout``).

Usage:
  python furniture_tpu_torch/tools/profile_ilqr.py

``--platform cpu`` runs the kernel's plain version on the CPU (host clock).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

HORIZON, ITERATIONS, SUBSTEPS = 64, 5, 10


def profile(horizon=HORIZON, iterations=ITERATIONS, substeps=SUBSTEPS, device=None,
            reps=5, **sim) -> dict:
    """The five timings in seconds; ``sim`` holds further ``SimConfig``
    fields."""
    import torch

    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.planning import ILQRConfig, flatten_env_dynamics, make_ilqr
    from furniture_tpu_torch.tools import median_ms

    env = CursorEnv(EnvConfig(furniture_name="table_lack_0825",
                              sim=SimConfig(**{"solver_iters": 8, **sim})), device=device)
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = env.reset_batch(1, gen)
    cursor = s.cursor_pos.clone()
    cursor[:, 0] = s.parts.pos[:, 0]
    s = s._replace(cursor_pos=cursor,
                   selected=torch.tensor([[0, -1]], dtype=torch.int32, device=dev))
    f, x0, unravel = flatten_env_dynamics(env, s, substeps=substeps)
    target = unravel(x0)["pos"][0] + torch.tensor([0.12, 0.1, 0.08], device=dev)

    def running_cost(x, u, t):
        return (10.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1)
                + 0.05 * torch.sum(u**2, -1))

    def terminal_cost(x):
        return 100.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1)

    cfg = ILQRConfig(horizon=horizon, iterations=iterations, parallel_riccati=True)
    plan = make_ilqr(f, running_cost, terminal_cost, cfg)
    H, m, n = cfg.horizon, env.dof, x0.shape[0]
    u0 = torch.zeros((H, m), device=dev)
    out = {"horizon": H, "iterations": cfg.iterations, "n_alphas": len(cfg.alphas),
           "n_state": int(n), "n_ctrl": int(m)}

    # each timed call starts from x0 nudged by 1e-4 (i + 1), as the JAX tool evolves it
    def nudged(fn):
        count = [0]

        def call():
            count[0] += 1
            return fn(x0 + 1e-4 * count[0])
        return call

    out["full_solve_s"] = median_ms(nudged(lambda x: plan(x, u0)), dev, 3) / 1e3
    out["rollout64_s"] = median_ms(nudged(lambda x: plan.initial_rollout(x, u0)), dev, reps) / 1e3
    xs, _ = plan.initial_rollout(x0, u0)
    ks = torch.zeros((H, m), device=dev)
    Ks = torch.zeros((H, m, n), device=dev)
    out["linesearch5_s"] = median_ms(
        nudged(lambda x: plan.line_search(x, xs, u0, ks, Ks)), dev, reps) / 1e3
    out["linearize_s"] = median_ms(lambda: plan.linearize(xs, u0), dev, reps) / 1e3
    exp = plan.linearize(xs, u0)
    reg = torch.full((), cfg.reg_init, device=dev)
    with torch.no_grad():
        out["backward_s"] = median_ms(lambda: plan.backward(*exp, reg), dev, reps) / 1e3
    # accounting: iterations x (linearize + backward + line search) + the rollout
    out["accounted_s"] = cfg.iterations * (
        out["linearize_s"] + out["backward_s"] + out["linesearch5_s"]
    ) + out["rollout64_s"]
    out["solves_per_s"] = 1.0 / out["full_solve_s"]
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="runs/torch_profile_ilqr.json")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain version)")
    args = p.parse_args(argv)
    out = profile(device=args.platform)
    print(json.dumps(out, indent=2))
    with open(args.out, "w") as fo:
        json.dump(out, fo, indent=2)
    return out


if __name__ == "__main__":
    main()
