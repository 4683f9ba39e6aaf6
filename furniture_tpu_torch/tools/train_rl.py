#!/usr/bin/env python
"""RL training entry point on the card.

The port's counterpart of ``tools/train_rl.py`` (the reference's ``python
-m run --algo bc|ppo|sac|gail``), with the same flags. Metrics stream to
stdout as JSON lines and to ``<run_dir>/metrics.jsonl``; the final
evaluation lands in ``<run_dir>/result.json``.

Usage:
  python -m furniture_tpu_torch.tools.train_rl --algo ppo --num_envs 256 --iters 100

``--platform cpu`` runs the kernels' plain versions on the CPU.

``--mesh N`` trains PPO or GAIL data-parallel over N devices, one process a
device, under ``torchrun`` (which sets the process group's address, rank
and world size)::

  torchrun --nproc_per_node N -m furniture_tpu_torch.tools.train_rl --mesh N --algo ppo

``--num_envs`` is the global lane count; each rank steps its share. Rank 0
alone writes the metrics, the checkpoints and ``result.json`` and runs the
evaluation. On a resume every rank takes the networks, optimizer and step
from the checkpoint and keeps its own freshly reset lanes and its generator
(the checkpoint holds rank 0's, at the world size it was written at).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=["bc", "ppo", "sac", "gail"], default="ppo")
    p.add_argument("--env", default="IKEACursor-v0")
    p.add_argument("--furniture_name", default="table_lack_0825")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--rollout_len", type=int, default=64)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--epochs", type=int, default=100, help="bc epochs")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--demo_path", default=None, help="demo pickle glob (bc/gail)")
    p.add_argument("--run_dir", default="./runs/default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel devices, one process each under torchrun (0 = no mesh; "
                        "any N > 0, 1 included, raises without torchrun or a process group)")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain versions)")
    p.add_argument("--ckpt_every", type=int, default=50,
                   help="checkpoint interval in train iters (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in run_dir")
    p.add_argument("--eval_episodes", type=int, default=64,
                   help="final success-rate eval episodes (0 = skip)")
    p.add_argument("--eval_max_steps", type=int, default=200)
    return p.parse_args(argv)


def _load_demos(pattern):
    from furniture_tpu_torch.utils.demo import load_demo

    files = sorted(glob.glob(pattern or ""))
    if not files:
        raise FileNotFoundError(f"no demos match --demo_path {pattern!r}")
    return [load_demo(f) for f in files]


def train(args):
    """Run what ``args`` (from :func:`parse_args`) ask for: ``(result, env)``,
    the env the algorithm stepped (None for BC)."""
    if args.mesh and args.algo not in ("ppo", "gail"):
        raise ValueError(f"--mesh is data parallelism for ppo and gail, not {args.algo}")
    import torch

    from furniture_tpu_torch import rl
    from furniture_tpu_torch.api import make_vec_env
    from furniture_tpu_torch.envs.cursor import resolve_device
    from furniture_tpu_torch.utils.checkpoint import (
        checkpoint_step,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    device = resolve_device(args.platform)
    mesh = None
    if args.mesh:
        from furniture_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.mesh, device="cpu" if device.type == "cpu" else None)
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    os.makedirs(args.run_dir, exist_ok=True)

    with (open(os.path.join(args.run_dir, "metrics.jsonl"), "a") if lead
          else contextlib.nullcontext()) as metrics_f:

        def log(it, m):
            if not lead:
                return
            rec = {"iter": it, **{k: float(v) for k, v in m.items()}}
            print(json.dumps(rec), flush=True)
            metrics_f.write(json.dumps(rec) + "\n")

        def maybe_resume(st):
            """Restore the newest run_dir checkpoint into ``st`` (same
            structure): (state, start_iter)."""
            if not args.resume:
                return st, 0
            path = latest_checkpoint(args.run_dir)
            if path is None:
                return st, 0
            if lead:
                print(json.dumps({"resumed_from": path}), flush=True)
            return load_checkpoint(path, st), checkpoint_step(path) + 1

        def maybe_ckpt(st, it, last=False):
            if lead and args.ckpt_every and (last or (it + 1) % args.ckpt_every == 0):
                save_checkpoint(args.run_dir, st, it)

        t0 = time.time()
        eval_fn = st = env = None
        if args.algo == "bc":
            X, Y = rl.demos_to_dataset(_load_demos(args.demo_path))
            init, fit, _ = rl.make_bc(X.shape[-1], Y.shape[-1], rl.BCConfig(lr=args.lr),
                                      device=device)
            X, Y = torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device)
            st, start = maybe_resume(init(args.seed))
            m = None
            for ep in range(start, args.epochs):
                st, m = fit(st, X, Y)
                if ep % 10 == 0 or ep == args.epochs - 1:
                    log(ep, m)
                maybe_ckpt(st, ep, last=ep == args.epochs - 1)
            final = {"final_mse": float(m["mse"])} if m is not None else {}
        else:
            env = make_vec_env(args.env, args.num_envs, seed=args.seed, device=device,
                               furniture_name=args.furniture_name).env
            if args.algo in ("ppo", "gail"):
                cfg = rl.PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout_len,
                                   lr=args.lr)
                reward_fn = disc_state = disc_update = None
                seed = args.seed
                if args.algo == "gail":
                    X, Y = rl.demos_to_dataset(_load_demos(args.demo_path))
                    g_init, disc_reward, disc_update, _ = rl.make_gail(
                        env, cfg, rl.GAILConfig(), X, Y, mesh=mesh)
                    disc_state, seed = g_init(args.seed)
                    reward_fn = lambda o, a, r: disc_reward(disc_state.params)(o, a, r)
                init, train_iter = rl.make_ppo(env, cfg, reward_fn=reward_fn, mesh=mesh)
                st = init(seed)
                lanes, draws = st.env_states, st.generator.get_state()
                if args.algo == "gail":
                    # the discriminator is part of the run state: (policy,
                    # disc) checkpoint as one state
                    bundle, start = maybe_resume({"policy": st, "disc": disc_state})
                    st, disc_state = bundle["policy"], bundle["disc"]
                else:
                    st, start = maybe_resume(st)
                if mesh is not None:
                    # the checkpoint holds rank 0's lanes and draws (for the
                    # world size it was written at): every rank keeps its own
                    st.generator.set_state(draws)
                    st = st._replace(env_states=lanes)
                m = None
                for it in range(start, args.iters):
                    st, m = train_iter(st)
                    if disc_update is not None:
                        # the freshest on-policy batch for the discriminator
                        obs = rl.flatten_obs(env.observe(st.env_states))
                        acts = torch.zeros((obs.shape[0], env.dof), device=device)
                        disc_state, dm = disc_update(disc_state, obs, acts)
                        m = {**m, **dm}
                    log(it, m)
                    maybe_ckpt({"policy": st, "disc": disc_state} if args.algo == "gail" else st,
                               it, last=it == args.iters - 1)
                act_fn = rl.ppo_act
            else:  # sac
                init, train_iter = rl.make_sac(env, rl.SACConfig(num_envs=args.num_envs, lr=args.lr))
                st, start = maybe_resume(init(args.seed))
                m = None
                for it in range(start, args.iters):
                    st, m = train_iter(st)
                    if it % 10 == 0 or it == args.iters - 1:
                        log(it, m)
                    maybe_ckpt(st, it, last=it == args.iters - 1)
                act_fn = rl.sac_act
            final = {"reward_per_step": float(m["reward_per_step"])} if m is not None else {}
            if args.eval_episodes and lead:
                eval_fn = rl.make_evaluate(env, act_fn, args.eval_episodes, args.eval_max_steps)

        if eval_fn is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed + 1)
            em = eval_fn(st.params, gen)
            final.update({k: float(v) for k, v in em.items()})
            log("eval", em)

    result = {
        "algo": args.algo,
        "env": args.env,
        "furniture_name": args.furniture_name,
        "seed": args.seed,
        "device": str(device),
        "world_size": 1 if mesh is None else mesh.world_size,
        "wall_s": time.time() - t0,
        **final,
    }
    if lead:
        with open(os.path.join(args.run_dir, "result.json"), "w") as f:
            json.dump(result, f, indent=2)
        print(json.dumps({"result": result}), flush=True)
    return result, env


def main(argv=None) -> dict:
    import torch.distributed as dist

    try:
        return train(parse_args(argv))[0]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
