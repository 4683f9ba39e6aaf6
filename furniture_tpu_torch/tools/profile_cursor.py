#!/usr/bin/env python
"""Where the cursor step's time goes, on the card.

The port's counterpart of ``tools/profile_cursor.py``, with its output keys.
At the bench configuration (batch 4096, 20-step rollouts of uniform random
actions on table_lack_0825, default ``SimConfig``) it times, as the median
of 5 rollouts after a warm-up (CUDA events on the card):

  full     ``CursorEnv.step_batch`` rollouts (the bench number)
  kernel   the free-part kernel's n-substep launches alone, one a step
  kernel1  its 1-substep launch alone (the snap-back settle)
  glue     ``step_batch`` with the physics replaced by identity (cursor
           moves, selection, connect machinery, guard, observations)

Usage:
  python furniture_tpu_torch/tools/profile_cursor.py

``--platform cpu`` runs the kernel's plain version on the CPU (host clock).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

B, H = 4096, 20


def profile(batch=B, horizon=H, device=None, reps=5, **config) -> dict:
    """The four rows at ``batch`` x ``horizon``; ``config`` holds further
    ``EnvConfig`` fields (``sim``, ...)."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.tools import median_ms

    env = CursorEnv(EnvConfig(furniture_name="table_lack_0825", **config), device=device)
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    states = env.reset_batch(batch, gen)
    n_sub = env.config.n_substeps
    cur = {"states": states, "parts": states.parts}

    def rollout():
        s = cur["states"]
        for _ in range(horizon):
            a = torch.rand((batch, env.dof), generator=gen, device=dev) * 2.0 - 1.0
            s = env.step_batch(s, a)[0]
        cur["states"] = s

    def kernel_roll(n):
        def roll():
            p = cur["parts"]
            for _ in range(horizon):
                p = env._physics(p, states.group, gscale, n)
            cur["parts"] = p
        return roll

    gscale = torch.ones(states.group.shape, device=dev)
    out = {}
    with torch.no_grad():
        ms = median_ms(rollout, dev, reps)
        out["full_steps_per_s"] = batch * horizon / ms * 1e3
        out["full_ms_per_batchstep"] = ms / horizon
        ms = median_ms(kernel_roll(n_sub), dev, reps)
        out["kernel_steps_per_s"] = batch * horizon / ms * 1e3
        out["kernel_ms_per_batchstep"] = ms / horizon
        cur["parts"] = states.parts
        out["kernel1_ms_per_batchstep"] = median_ms(kernel_roll(1), dev, reps) / horizon
        # glue: step_batch with the physics swapped for identity
        env._physics = lambda parts, group, gscale, n: parts
        try:
            cur["states"] = states
            ms = median_ms(rollout, dev, reps)
        finally:
            del env._physics
        out["glue_steps_per_s"] = batch * horizon / ms * 1e3
        out["glue_ms_per_batchstep"] = ms / horizon
    out.update(batch=batch, horizon=horizon, block=env.config.sim.mega_block,
               n_substeps=n_sub, solver_iters=env.config.sim.solver_iters,
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="runs/torch_profile_cursor.json")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain version)")
    args = p.parse_args(argv)
    results = profile(device=args.platform)
    print(json.dumps(results, indent=2))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
