#!/usr/bin/env python
"""Batched scripted demonstration generation on the card.

The port's counterpart of ``tools/generate_demos.py`` (reference
``python -m furniture.env.furniture_sawyer_gen``,
``furniture_sawyer_gen.py:734-748``), with the same flags: a batch of
scripted episodes stepped together through the arm kernel, the successful
ones saved as reference-schema demo pickles (``util/demo_recorder.py:33-87``)
and optionally as a native trajectory store, and a success-rate stats JSON.

Usage:
  python furniture_tpu_torch/tools/generate_demos.py --furniture table_lack_0825 \\
      --n_demos 4 --batch 128 --demo_dir demos/ --stats_out runs/gen_stats.json

``generate(..., device="cpu")`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def generate(furniture="table_lack_0825", n_demos=8, batch=32, seed=0, max_steps=None,
             out=None, demo_dir=None, record_obs=True, device=None, **config):
    """Build the Sawyer generator env (ik) and run ``generate_demos``;
    returns ``(demos, stats)`` with the furniture name and the number of
    saved demos added to ``stats``. ``config`` holds further ``EnvConfig``
    fields (``num_connects``, ``sim``, ...)."""
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.sawyer_gen import FurnitureSawyerGenEnv

    env = FurnitureSawyerGenEnv(
        EnvConfig(agent_type="Sawyer", control_type="ik", furniture_name=furniture, **config),
        device=device,
    )
    demos, stats = env.generate_demos(
        n_demos, seed=seed, batch=batch, store_path=out, demo_dir=demo_dir,
        max_steps=max_steps, record_obs=record_obs,
    )
    stats["furniture_name"] = furniture
    stats["n_demos_saved"] = len(demos)
    return demos, stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--furniture", default="table_lack_0825")
    p.add_argument("--n_demos", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--out", default=None, help="native .ftr store path")
    p.add_argument("--demo_dir", default=None,
                   help="directory for reference-schema demo pickles")
    p.add_argument("--stats_out", default=None,
                   help="write the success-rate stats JSON here")
    p.add_argument("--no_obs", action="store_true",
                   help="skip per-step observation recording (smaller demos)")
    args = p.parse_args(argv)

    _, stats = generate(
        args.furniture, args.n_demos, args.batch, args.seed, args.max_steps,
        args.out, args.demo_dir, not args.no_obs,
    )
    print(json.dumps(stats))
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump(stats, f, indent=2)


if __name__ == "__main__":
    main()
