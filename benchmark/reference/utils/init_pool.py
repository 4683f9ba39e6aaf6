"""Initial-state pools: save/load/sample sets of reset states.

The port's own copy of ``furniture_tpu.utils.init_pool`` (numpy only; the
same functions and the same pickle format, so a pool saved by one package
loads in the other). The reference's ``--load_init_states`` loads a list of
environment states and, at each reset, uses a random pool entry with
probability 0.8. Here a pool is a dict of stacked numpy arrays (one leading
pool dimension) holding the assembly fields that define a reset
configuration; an env keeps it as tensors on its device
(``set_init_state_pool``) and gathers one entry per env at reset
(``envs.assembly.apply_reset_variants``).

Pool fields (all optional except parts): ``pos [N,P,3]``, ``quat [N,P,4]``,
``group [N,P]``, ``weld_active [N,W]``, ``conn_connected [N,C]``,
``num_connected [N]``, and for arm envs ``qpos [N,NJ]`` / ``qvel [N,NJ]``.
A pool file is a pickle: load only files that this program wrote.
"""

from __future__ import annotations

import pickle

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


def snapshot(state) -> dict:
    """Extract the pool entry for one env state (host-side numpy). A
    batched state gives a stacked pool of its envs directly."""
    snap = {
        "pos": _host(state.parts.pos),
        "quat": _host(state.parts.quat),
        "group": _host(state.group),
        "weld_active": _host(state.weld_active),
        "conn_connected": _host(state.conn_connected),
        "num_connected": _host(state.num_connected),
    }
    if hasattr(state, "qpos"):
        snap["qpos"] = _host(state.qpos)
        snap["qvel"] = _host(state.qvel)
    return snap


def stack_pool(snaps: list[dict]) -> dict:
    """Stack per-state snapshots into one pool dict."""
    keys = snaps[0].keys()
    return {k: np.stack([s[k] for s in snaps]) for k in keys}


def save_pool(path: str, snaps_or_pool) -> None:
    pool = (
        stack_pool(snaps_or_pool)
        if isinstance(snaps_or_pool, list)
        else snaps_or_pool
    )
    with open(path, "wb") as f:
        pickle.dump(pool, f)


def pool_from_demo(demo, stride: int = 50) -> dict:
    """Harvest init-state pool entries from a demo's recorded ``states``
    stream (the reference harvests reset pools from recorded env states and
    successful terminals).

    Takes every ``stride``-th state plus the final one. Velocities are
    dropped: pool entries are reset configurations, which start at rest."""
    states = demo.get("states") or []
    if not states:
        raise ValueError("demo carries no states stream")
    picks = list(states[::stride])
    if states[-1] is not picks[-1]:
        picks.append(states[-1])
    snaps = []
    for st in picks:
        snap = {
            "pos": np.asarray(st["parts_pos"]),
            "quat": np.asarray(st["parts_quat"]),
            "group": np.asarray(st["group"]),
            "weld_active": np.asarray(st["weld_active"]),
            "conn_connected": np.asarray(st["conn_connected"]),
            "num_connected": np.asarray(st["num_connected"]),
        }
        if "qpos" in st:
            snap["qpos"] = np.asarray(st["qpos"])
            snap["qvel"] = np.zeros_like(np.asarray(st["qvel"]))
        snaps.append(snap)
    return stack_pool(snaps)


def load_pool(path: str) -> dict:
    with open(path, "rb") as f:
        pool = pickle.load(f)
    if isinstance(pool, list):  # list-of-snapshots form also accepted
        pool = stack_pool(pool)
    return {k: np.asarray(v) for k, v in pool.items()}
