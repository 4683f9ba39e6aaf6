#!/usr/bin/env python
"""Manual keyboard control on the card.

The port's counterpart of ``tools/run_manual.py`` (the reference's
``demo_manual.py`` + ``FurnitureEnv.run_manual``,
``env/furniture.py:2410-2580``), with the same key bindings
(``key_callback``, ``env/furniture.py:2046-2098``) read from the terminal;
frames come from the port's renderer (``render.make_render_fn``).

Keys: w/s/a/d/q/e move, i/k/j/l/u/o rotate, SPACE select, ENTER deselect,
c connect, 1/2 switch cursor (Cursor/Baxter), t screenshot, y save demo,
r reset, x quit.

Non-interactive use: ``--script "w w e SPACE c"`` feeds a key sequence and
exits. ``--platform cpu`` runs the kernels' plain versions on the CPU.
The screenshot is a PNG where ``imageio`` is installed, else the frame as
``.npz``; the tool prints the path it wrote.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

KEY2TOKEN = {
    " ": "sel", "SPACE": "sel",
    "\r": "des", "\n": "des", "ENTER": "des",
    "w": "m_f", "s": "m_b", "e": "m_u", "q": "m_d", "a": "m_l", "d": "m_r",
    "i": "r_f", "k": "r_b", "o": "r_u", "u": "r_d", "j": "r_l", "l": "r_r",
    "c": "connect", "1": "switch1", "2": "switch2",
    "t": "screenshot", "y": "save", "r": "reset", "x": "quit",
}


def token_to_action(token, agent_type, control_type, dof, cursor_idx, flag):
    """Reference action synthesis (``env/furniture.py:2445-2531``)."""
    a8 = np.zeros(8, np.float32)
    if token == "connect":
        a8[7] = 1
    move = {"m_f": (1, 1), "m_b": (1, -1), "m_u": (2, 1), "m_d": (2, -1),
            "m_l": (0, -1), "m_r": (0, 1),
            "r_f": (4, 1), "r_b": (4, -1), "r_u": (5, 1), "r_d": (5, -1),
            "r_l": (3, -1), "r_r": (3, 1)}
    if token in move:
        i, v = move[token]
        a8[i] = v
    if agent_type == "Cursor":
        if cursor_idx:
            return np.hstack([np.zeros(6), [flag[0]], a8[:6], [flag[1], a8[7]]])
        return np.hstack([a8[:6], [flag[0]], np.zeros(6), [flag[1], a8[7]]])
    if agent_type == "Baxter":
        if cursor_idx:
            return np.hstack([np.zeros(6), a8[:6], [flag[0], flag[1], a8[7]]])
        return np.hstack([a8[:6], np.zeros(6), [flag[0], flag[1], a8[7]]])
    out = a8.copy()
    out[6] = flag[0]
    return out[:dof] if dof <= 8 else np.hstack([out, np.zeros(dof - 8)])


def read_keys_interactive():
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            yield sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def write_image(img: np.ndarray, base: str) -> str:
    """``img`` [H,W,3] uint8 as ``base.png`` through imageio where it is
    installed, else as ``base.npz`` (``frame``); the path written."""
    try:
        import imageio
    except ImportError:
        path = base + ".npz"
        np.savez_compressed(path, frame=img)
        return path
    path = base + ".png"
    imageio.imwrite(path, img)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="IKEACursor-v0")
    p.add_argument("--furniture_name", default="table_lack_0825")
    p.add_argument("--control_type", default="ik")
    p.add_argument("--screen_width", type=int, default=256)
    p.add_argument("--screen_height", type=int, default=256)
    p.add_argument("--script", default=None,
                   help="space-separated key sequence; run headless and exit")
    p.add_argument("--record_demo", action="store_true")
    p.add_argument("--demo_dir", default="./demos")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--platform", default=None,
                   help="device to run on (default: the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def run(args, **config) -> None:
    """The key loop of ``args`` (from :func:`parse_args`); ``config`` holds
    further ``EnvConfig`` fields (``sim``, ...)."""
    from furniture_tpu_torch.api import make_env
    from furniture_tpu_torch.utils.demo import DemoRecorder

    env = make_env(args.env, device=args.platform, furniture_name=args.furniture_name,
                   control_type=args.control_type, screen_width=args.screen_width,
                   screen_height=args.screen_height, **config)
    agent_type = env.config.agent_type
    ob = env.reset(seed=0)
    recorder = DemoRecorder(args.demo_dir) if args.record_demo else None
    if recorder:
        recorder.add(ob=ob)

    cursor_idx, flag = 0, [-1.0, -1.0]
    keys = iter(args.script.split()) if args.script else read_keys_interactive()
    if not args.script:
        print(__doc__)

    for key in keys:
        token = KEY2TOKEN.get(key)
        if token is None:
            continue
        if token == "quit":
            break
        if token == "reset":
            ob = env.reset()
            continue
        if token == "switch1":
            cursor_idx = 0
            continue
        if token == "switch2":
            cursor_idx = 1
            continue
        if token == "screenshot":
            img = (env.render("rgb_array") * 255).astype(np.uint8)
            path = write_image(img, os.path.join(args.out_dir, args.furniture_name))
            print(f"screenshot -> {path}")
            continue
        if token == "save":
            if recorder:
                print("demo ->", recorder.save(f"{agent_type}_manual_"))
            continue
        if token == "sel":
            flag[cursor_idx] = 1.0
            token = "noop"
        if token == "des":
            flag[cursor_idx] = -1.0
            token = "noop"

        action = token_to_action(token, agent_type, args.control_type,
                                 env.env.dof, cursor_idx, flag)
        ob, reward, done, info = env.step(action.astype(np.float32))
        if recorder:
            recorder.add(ob=ob, action=action, reward=reward)
        print(f"key={key!r} reward={reward:.3f} done={done} "
              f"connected={int(info.get('num_connected', 0))}")
        if done:
            if recorder:
                recorder.save(f"{agent_type}_manual_")
            ob = env.reset()
            flag = [-1.0, -1.0]


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
