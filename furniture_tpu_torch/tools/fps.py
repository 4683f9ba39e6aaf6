#!/usr/bin/env python
"""Env steps/s of random-action rollouts on the card.

The port's counterpart of ``tools/fps.py`` (reference ``furniture/fps.py:39-223``),
with the same flags and output lines: one (agent, control type, furniture)
combination, or with ``--all`` the reference's agent/control matrix, each a
batch of ``--batch`` envs stepped through ``step_batch`` with uniform random
actions in [-1, 1].

Usage:
  python furniture_tpu_torch/tools/fps.py --agent Sawyer --control ik --furniture table_lack_0825
  python furniture_tpu_torch/tools/fps.py --all

``--platform cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# the reference's fps.py test_all agent/control matrix (fps.py:133-223)
COMBOS = [
    ("Cursor", "ik"),
    ("Sawyer", "ik"),
    ("Sawyer", "impedance"),
    ("Baxter", "ik"),
    ("Baxter", "impedance"),
]


def measure(agent, control, furniture, batch, horizon=10, reps=3, device=None, **config):
    """Env steps/s of ``batch`` envs: a warm-up rollout of ``horizon``
    steps, then ``reps`` rollouts timed between two synchronisations of the
    device. Actions come from a generator on ``device`` (the card unless
    the caller asks for the CPU) seeded with 0, which also draws the reset.
    ``config`` holds further ``EnvConfig`` fields (``sim``, ...)."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.envs.cursor import CursorEnv, resolve_device

    dev = resolve_device(device)
    cfg = EnvConfig(agent_type=agent, control_type=control, furniture_name=furniture, **config)
    env = CursorEnv(cfg, device=dev) if agent == "Cursor" else ArmEnv(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def rollout(states):
        for _ in range(horizon):
            a = torch.rand((batch, env.dof), generator=gen, device=dev) * 2.0 - 1.0
            states = env.step_batch(states, a)[0]
        return states

    states = rollout(env.reset_batch(batch, gen))
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        states = rollout(states)
    sync()
    return batch * horizon * reps / (time.perf_counter() - t0)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", default="Cursor")
    p.add_argument("--control", default="ik")
    p.add_argument("--furniture", default="table_lack_0825")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--all", action="store_true")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    combos = COMBOS if args.all else [(args.agent, args.control)]
    rows = []
    for agent, control in combos:
        fps = measure(agent, control, args.furniture, args.batch, device=args.platform)
        rows.append({"agent": agent, "control": control, "furniture": args.furniture,
                     "batch": args.batch, "steps_per_s": round(fps, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
