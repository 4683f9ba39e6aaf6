#!/usr/bin/env python
"""Failure attribution for the scripted demo generator, on the card.

The port's counterpart of ``tools/profile_gen.py``, with the same flags and
output schema: a batch of scripted episodes (``FurnitureSawyerGenEnv``,
Sawyer ik) records per env and step the generator phase, the grasp of the
current subtask's leg, the drop count, the leg's distance from the
workspace center and its speed, the connect action, the connect count and
the subtask; :func:`analyze` aggregates them on the host into the phase
occupancy, the grasp, align and connect funnels and the ejection events
per cohort of final connect count. The records stay on the device and go
to the host once a segment of 400 steps.

Usage:
  python furniture_tpu_torch/tools/profile_gen.py --batch 128 --max_steps 2400

``--platform cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SEGMENT = 400


def rollout_diag(env, batch: int, max_steps: int, seed: int):
    """The eight per-step records of ``batch`` scripted episodes, each a
    ``[max_steps, batch]`` numpy array: phase (int8), the leg held by both
    fingers, the drop count (int8), the leg's xy distance from the origin,
    the connect action, the leg's speed (the policy state after the
    decision, the env state before the step), then the connect count and
    the subtask after the step (int8)."""
    import torch

    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    env_s = env.reset_batch(batch, gen)
    gen_s = env.init_policy_state(env_s, gen)
    rows = torch.arange(batch, device=dev)
    legs = env._stt["leg"]
    chunks, pending = [], []
    n_seg = -(-max_steps // SEGMENT)
    with torch.no_grad():
        for t in range(max_steps):
            action, gen_s = env.scripted_action(gen_s, env_s)
            leg = legs[torch.clamp(gen_s.part.long(), max=env.n_subtasks - 1)]
            held = env_s.touch_l[rows, 0, leg] & env_s.touch_r[rows, 0, leg]
            rec = [
                gen_s.phase.to(torch.int8),
                held,
                gen_s.drop_count.to(torch.int8),
                torch.linalg.norm(env_s.parts.pos[rows, leg, :2], dim=-1),
                action[:, 7] > 0.0,
                torch.linalg.norm(env_s.parts.lin_vel[rows, leg], dim=-1),
            ]
            env_s = env.step_batch(env_s, action)[0]
            rec += [env_s.num_connected.to(torch.int8), env_s.subtask_step.to(torch.int8)]
            pending.append(rec)
            if len(pending) == SEGMENT or t == max_steps - 1:
                chunks.append([torch.stack(f).cpu().numpy() for f in zip(*pending)])
                pending = []
                print(f"  segment {len(chunks)}/{n_seg}", file=sys.stderr, flush=True)
    return tuple(np.concatenate(f) for f in zip(*chunks))


PHASES = [
    "INIT_GRIP", "XY_MOVE_G", "ALIGN_G", "Z_MOVE_G", "MOVE_WAYPOINTS",
    "ALIGN_CONN", "XY_MOVE_CONN", "Z_MOVE_CONN", "ALIGN_CONN_FINE",
    "Z_MOVE_CONN_FINE", "MOVE_NOGRIP_SAFEPOS", "PART_DONE",
]


def analyze(traj, n_subtasks: int):
    (phase, held, drop_count, leg_xy, conn_act, leg_speed,
     n_conn, subtask) = traj
    T_, B = phase.shape
    final_conn = n_conn[-1]

    out = {"batch": int(B), "max_steps": int(T_)}
    out["connect_histogram"] = np.bincount(
        final_conn, minlength=n_subtasks + 1
    ).tolist()
    out["success_rate"] = float((final_conn >= n_subtasks).mean())

    # phase transitions per lane
    prev = phase[:-1]
    cur = phase[1:]
    changed = prev != cur

    def entries(p):
        """Per-lane count of transitions into phase p."""
        return ((cur == p) & changed).sum(0)

    grasp_attempts = entries(3)          # Z_MOVE_G
    grasp_success = entries(4)           # MOVE_WAYPOINTS (only entered on grasp)
    align_entries = entries(5)           # ALIGN_CONN
    fine_entries = entries(9)            # Z_MOVE_CONN_FINE
    # regrasp resets: INIT_GRIP entries after step 0
    regrasps = entries(0)

    cohorts = {}
    for c in range(n_subtasks + 1):
        m = final_conn == c
        if not m.any():
            continue
        occ = np.stack(
            [(phase[:, m] == p).mean() for p in range(12)]
        )
        cohorts[f"connects_{c}"] = {
            "n_lanes": int(m.sum()),
            "phase_occupancy": {
                PHASES[p]: round(float(occ[p]), 4) for p in range(12)
                if occ[p] > 0.001
            },
            "mean_grasp_attempts": round(float(grasp_attempts[m].mean()), 2),
            "mean_grasp_successes": round(float(grasp_success[m].mean()), 2),
            "mean_regrasps": round(float(regrasps[m].mean()), 2),
            "mean_align_entries": round(float(align_entries[m].mean()), 2),
            "mean_fine_entries": round(float(fine_entries[m].mean()), 2),
            "ever_held_frac": round(float(held[:, m].any(0).mean()), 3),
            "held_frac_of_steps": round(float(held[:, m].mean()), 3),
            "mean_connect_act_steps": round(float(conn_act[:, m].sum(0).mean()), 1),
            "final_leg_xy_p50": round(float(np.median(leg_xy[-1, m])), 3),
            "final_leg_xy_p90": round(
                float(np.percentile(leg_xy[-1, m], 90)), 3
            ),
            "leg_off_workspace_frac": round(
                float((leg_xy[-1, m] > 0.6).mean()), 3
            ),
            "final_subtask_hist": np.bincount(
                subtask[-1, m], minlength=n_subtasks + 1
            ).tolist(),
        }
    out["cohorts"] = cohorts

    # ejection events: the phase at which each lane's leg hit its peak
    # speed (legs found meters off-workspace imply violent ejections)
    t_peak = leg_speed.argmax(0)                                  # [B]
    peak_v = leg_speed.max(0)
    peak_phase = phase[t_peak, np.arange(B)]
    out["ejection"] = {
        "peak_speed_p50": round(float(np.median(peak_v)), 2),
        "peak_speed_p90": round(float(np.percentile(peak_v, 90)), 2),
        "peak_phase_hist": {
            PHASES[p]: int((peak_phase == p).sum())
            for p in range(12)
            if (peak_phase == p).any()
        },
        "frac_steps_speed_gt_2": round(float((leg_speed > 2.0).mean()), 4),
    }

    # the funnel over ALL lanes: where does the pipeline leak?
    out["funnel"] = {
        "lanes": int(B),
        "ever_grasped": int(held.any(0).sum()),
        "ever_entered_align_conn": int((align_entries > 0).sum()),
        "ever_entered_fine": int((fine_entries > 0).sum()),
        "ever_pressed_connect": int(conn_act.any(0).sum()),
        "got_first_connect": int((final_conn >= 1).sum()),
        "got_all_connects": int((final_conn >= n_subtasks).sum()),
    }
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--furniture", default="table_lack_0825")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--max_steps", type=int, default=2400)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--solver_iters", type=int, default=None)
    p.add_argument("--out", default="runs/torch_profile_gen.json")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def profile(args, **sim) -> dict:
    """Roll and analyze as ``args`` (from :func:`parse_args`) ask; ``sim``
    holds further ``SimConfig`` fields (``control_freq``, ...)."""
    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.sawyer_gen import FurnitureSawyerGenEnv

    if args.solver_iters is not None:
        sim["solver_iters"] = args.solver_iters
    env = FurnitureSawyerGenEnv(
        EnvConfig(agent_type="Sawyer", control_type="ik", furniture_name=args.furniture,
                  sim=SimConfig(**sim)),
        device=args.platform,
    )
    out = analyze(rollout_diag(env, args.batch, args.max_steps, args.seed), env.n_subtasks)
    out["furniture_name"] = args.furniture
    out["seed"] = args.seed
    return out


def main(argv=None):
    args = parse_args(argv)
    out = profile(args)
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
