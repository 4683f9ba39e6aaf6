#!/usr/bin/env python
"""Demo -> BC -> evaluation on the card.

The port's counterpart of ``tools/eval_bc.py``, with the same flags and
output keys: behavioral cloning (``rl.make_bc``) on reference-schema demo
pickles, then ``--episodes`` batched rollouts of the deterministic policy
on the dense-reward Sawyer env (ik) scoring the reference's success
criterion, in chunks of 200 steps whose success flags are read once a
chunk.

Usage:
  python furniture_tpu_torch/tools/eval_bc.py --demos 'demos/generated/*.pkl' \\
      --num_connects 1 --episodes 32 --steps 400 --out runs/torch_bc_eval.json

``--platform cpu`` runs the kernels' plain versions on the CPU. The default
``--demos`` is ``demos/generated/*.pkl``: ``demos/generated*/*.pkl`` (the
JAX tool's default) also matches the three-block demos, whose observations
are narrower, and the dataset cannot stack both.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

CHUNK = 200


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--demos", default="demos/generated/*.pkl")
    p.add_argument("--furniture", default="table_lack_0825")
    p.add_argument("--num_connects", type=int, default=1,
                   help="success bar for eval (1 = first subtask)")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--pool_offset", type=int, default=0,
        help="when >0, evaluate from an init-state pool harvested this many "
        "steps before each demo's success (the reference's "
        "--load_init_states curriculum loop, env/furniture.py:127-130) "
        "instead of from scratch resets",
    )
    p.add_argument("--out", default="runs/torch_bc_eval.json")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def load_dataset(pattern: str):
    """``(demos, X, Y)`` of the demo pickles matching ``pattern``."""
    from furniture_tpu_torch import rl
    from furniture_tpu_torch.utils.demo import load_demo

    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no demos match {pattern}")
    demos = [load_demo(f) for f in files]
    X, Y = rl.demos_to_dataset(demos)
    return demos, X, Y


def pool_snaps(demos, offset: int) -> list[dict]:
    """The state ``offset`` steps before each demo's last, as an init-pool
    snapshot (velocities zero), for the demos long enough."""
    snaps = []
    for d in demos:
        sts = d.get("states") or []
        if len(sts) > offset:
            s0 = sts[len(sts) - 1 - offset]
            snaps.append({
                "pos": np.asarray(s0["parts_pos"]),
                "quat": np.asarray(s0["parts_quat"]),
                "group": np.asarray(s0["group"]),
                "weld_active": np.asarray(s0["weld_active"]),
                "conn_connected": np.asarray(s0["conn_connected"]),
                "num_connected": np.asarray(s0["num_connected"]),
                "qpos": np.asarray(s0["qpos"]),
                "qvel": np.zeros_like(np.asarray(s0["qvel"])),
            })
    return snaps


def evaluate(args, **config) -> dict:
    """Fit and evaluate as ``args`` (from :func:`parse_args`) ask; the
    result dict. ``config`` holds further ``EnvConfig`` fields (``sim``,
    ...)."""
    import torch

    from furniture_tpu_torch import rl
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.cursor import resolve_device
    from furniture_tpu_torch.envs.sawyer_dense import FurnitureSawyerDenseRewardEnv
    from furniture_tpu_torch.rl import networks as N
    from furniture_tpu_torch.utils.init_pool import stack_pool

    dev = resolve_device(args.platform)
    demos, X, Y = load_dataset(args.demos)
    print(f"dataset: {X.shape[0]} transitions from {len(demos)} demos", file=sys.stderr)

    init, fit, _ = rl.make_bc(X.shape[-1], Y.shape[-1], device=dev)
    st = init(args.seed)
    Xt = torch.as_tensor(X, device=dev)
    Yt = torch.as_tensor(Y, device=dev)
    t_fit = time.perf_counter()
    for e in range(args.epochs):
        st, m = fit(st, Xt, Yt)
        if e % 50 == 0 or e == args.epochs - 1:
            print(f"epoch {e}: mse {float(m['mse']):.5f}", file=sys.stderr)
    fit_s = time.perf_counter() - t_fit
    print(f"bc: {args.epochs} epochs in {fit_s:.3f} s ({fit_s / max(args.epochs, 1):.4f} s/epoch) "
          f"on {dev}", file=sys.stderr)

    env = FurnitureSawyerDenseRewardEnv(
        EnvConfig(agent_type="Sawyer", control_type="ik", furniture_name=args.furniture,
                  num_connects=args.num_connects, **config),
        device=dev,
    )
    if args.pool_offset > 0:
        snaps = pool_snaps(demos, args.pool_offset)
        env.set_init_state_pool(stack_pool(snaps))
        print(f"init pool: {len(snaps)} near-success states", file=sys.stderr)

    B = args.episodes
    t_eval = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    states = env.reset_batch(B, gen)
    policy = st.params
    # with pool restores the state already carries connects and the dense
    # subtask bookkeeping restarts, so score an ADDITIONAL connect; a
    # from-scratch evaluation scores the env's own success
    nconn0 = states.num_connected
    succeeded = torch.zeros(B, dtype=torch.bool, device=dev)
    succ_t = torch.full((B,), args.steps, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for t0 in range(0, args.steps, CHUNK):
            n = min(CHUNK, args.steps - t0)
            for t in range(t0, t0 + n):
                action = policy.dist(N.flatten_obs(env.observe(states)))[0]
                states, _, rew, done, info = env.step_batch(states, action)
                if args.pool_offset > 0:
                    success = states.num_connected > nconn0
                else:
                    success = info["success"].to(torch.bool)
                succ_t = torch.where(success & ~succeeded, torch.full_like(succ_t, t + 1), succ_t)
                succeeded = succeeded | success
            print(f"  t={t0 + n}: successes {int(succeeded.sum())}/{B}", file=sys.stderr, flush=True)

    ok = succeeded.cpu().numpy()
    print(f"eval: reset + {args.steps} steps of {B} episodes in {time.perf_counter() - t_eval:.3f} s "
          f"on {dev}", file=sys.stderr)
    return {
        "n_demos": len(demos),
        "n_transitions": int(X.shape[0]),
        "bc_final_mse": float(m["mse"]),
        "episodes": B,
        "max_steps": args.steps,
        "num_connects": args.num_connects,
        "success_rate": float(ok.mean()),
        "n_success": int(ok.sum()),
        "success_steps": sorted(int(t) for t in succ_t.cpu().numpy()[ok]),
        "pool_offset": args.pool_offset,
        "criterion": "additional_connect" if args.pool_offset > 0 else "env_success",
        "furniture_name": args.furniture,
        "seed": args.seed,
    }


def main(argv=None):
    args = parse_args(argv)
    out = evaluate(args)
    print(json.dumps(out))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
