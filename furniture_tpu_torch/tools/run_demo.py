#!/usr/bin/env python
"""Demo playback on the card.

The port's counterpart of ``tools/run_demo.py`` (the reference's
``demo_demonstration.py`` + ``run_demo``/``run_demo_actions``,
``env/furniture.py:2183-2234,2581-2624``), with the same flags: replays a
recorded demo pickle through ``make_env`` open-loop (action replay) and
reports the summed reward, the connections and, where the demo carries
recorded observations, the final ``object_ob`` distance; or, with
``--state_replay``, drives the env through the recorded states stream.
``--video`` records the replay's frames through ``VideoRecorder``.

Usage:
  python furniture_tpu_torch/tools/run_demo.py demos/generated/Sawyer_table_lack_0825_0000.pkl \\
      --env IKEASawyer-v0 --state_replay

``--platform cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("demo")
    p.add_argument("--env", default="IKEACursor-v0")
    p.add_argument("--furniture_name", default="table_lack_0825")
    p.add_argument("--control_type", default="ik")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--video", default=None,
                   help="directory for the replay's video (VideoRecorder's record_dir)")
    p.add_argument("--screen_width", type=int, default=256)
    p.add_argument("--screen_height", type=int, default=256)
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain versions)")
    p.add_argument(
        "--state_replay", action="store_true",
        help="replay the recorded states stream (reference run_demo, "
        "env/furniture.py:2183) instead of stepping recorded actions",
    )
    return p.parse_args(argv)


def replay(args, **config) -> dict:
    """Replay ``args.demo`` as ``args`` (from :func:`parse_args`) ask; the
    result dict the tool prints. ``config`` holds further ``EnvConfig``
    fields (``sim``, ...)."""
    import numpy as np

    from furniture_tpu_torch.api import make_env
    from furniture_tpu_torch.envs.cursor import _squeeze, _unsqueeze
    from furniture_tpu_torch.utils.demo import load_demo
    from furniture_tpu_torch.utils.video_recorder import VideoRecorder

    demo = load_demo(args.demo)
    env = make_env(args.env, device=args.platform, furniture_name=args.furniture_name,
                   control_type=args.control_type, screen_width=args.screen_width,
                   screen_height=args.screen_height, **config)
    env.reset(seed=args.seed)
    vid = VideoRecorder(args.video) if args.video else None

    def frame():
        if vid is not None:
            vid.capture_frame((env.render("rgb_array") * 255).astype(np.uint8))

    def close_video():
        if vid is not None:
            print(f"video -> {vid.close()}")

    if args.state_replay:
        states_rec = demo.get("states") or []
        if not states_rec or "parts_pos" not in states_rec[0]:
            raise SystemExit("demo carries no replayable states stream")
        st = env.get_env_state()
        for snap in states_rec:
            st = _squeeze(env.env.restore_snapshot(_unsqueeze(st), snap))
            env.set_env_state(st)
            frame()
        close_video()
        return {
            "steps": len(states_rec),
            "num_connected": int(states_rec[-1]["num_connected"]),
            "mode": "state_replay",
        }

    frame()
    total_rew, n_conn = 0.0, 0
    for t, a in enumerate(demo["actions"]):
        ob, rew, done, info = env.step(np.asarray(a, np.float32))
        total_rew += rew
        n_conn = int(info.get("num_connected", n_conn))
        frame()
        if done:
            break
    close_video()

    result = {"steps": t + 1, "total_reward": total_rew, "num_connected": n_conn}
    # trajectory divergence against the recorded observations, when present
    obs_rec = demo.get("obs") or []
    if obs_rec and isinstance(obs_rec[-1], dict) and "object_ob" in obs_rec[-1]:
        ref = np.asarray(obs_rec[min(t + 1, len(obs_rec) - 1)]["object_ob"]).ravel()
        cur = np.asarray(ob["object_ob"]).ravel()
        if ref.shape == cur.shape:
            result["final_object_ob_l2"] = float(np.linalg.norm(ref - cur))
    return result


def main(argv=None):
    print(json.dumps(replay(parse_args(argv))))


if __name__ == "__main__":
    main()
