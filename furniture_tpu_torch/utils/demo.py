"""Demonstration recording and loading, pickle-compatible with the reference.

The port's own copy of ``furniture_tpu.utils.demo`` (numpy and pickle only).
Two schemas exist in the reference:

* ``DemoRecorder.save`` (``util/demo_recorder.py:58-87``): a dict with keys
  ``states/obs/actions/rewards/low_level_obs/low_level_actions/
  connect_actions/metadata``; the generated demos under ``demos/generated``
  and ``demos/generated_blocks`` are of this kind;
* the reference's playback demos (``run_demo``/``run_demo_actions``,
  ``env/furniture.py:2183,2581``): a dict ``{"qpos": [per-step {body:
  qpos}], "actions": [np arrays]}``.

``load_demo`` reads both.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from .logger import logger


class DemoRecorder:
    """Buffers an episode and saves numbered pickles (reference
    ``util/demo_recorder.py:10-103``)."""

    def __init__(self, demo_dir: str = "./demos", metadata=None):
        self._demo_dir = demo_dir
        self._metadata = metadata
        os.makedirs(demo_dir, exist_ok=True)
        self.reset()

    def reset(self):
        self._obs = []
        self._actions = []
        self._states = []
        self._rewards = []
        self._low_level_obs = []
        self._low_level_actions = []
        self._connect_actions = []

    def add(
        self,
        ob=None,
        state=None,
        action=None,
        reward=None,
        low_level_ob=None,
        low_level_action=None,
        connect_action=None,
    ):
        if ob is not None:
            self._obs.append(ob)
        if action is not None:
            self._actions.append(np.asarray(action))
        if state is not None:
            self._states.append(state)
        if reward is not None:
            self._rewards.append(float(reward))
        if low_level_ob is not None:
            self._low_level_obs.append(low_level_ob)
        if low_level_action is not None:
            self._low_level_actions.append(np.asarray(low_level_action))
        if connect_action is not None:
            self._connect_actions.append(connect_action)

    def save(self, prefix: str, count: int | None = None) -> str:
        if count is None:
            count = min(
                9999, len(glob.glob(os.path.join(self._demo_dir, prefix) + "*"))
            )
        path = os.path.join(self._demo_dir, f"{prefix}{count:04d}.pkl")
        demo = {
            "states": self._states,
            "obs": self._obs,
            "actions": self._actions,
            "rewards": self._rewards,
            "low_level_obs": self._low_level_obs,
            "low_level_actions": self._low_level_actions,
            "connect_actions": self._connect_actions,
            "metadata": self._metadata,
        }
        if self._obs:
            assert len(self._obs) == len(self._actions) + 1
        with open(path, "wb") as f:
            pickle.dump(demo, f)
        logger.info("Saved demo of length %d to %s", len(self._obs), path)
        self.reset()
        return path


def load_demo(path: str) -> dict:
    """Load either demo schema; normalizes to a dict with at least
    ``actions`` (list of np arrays) and, when present, ``qpos`` / ``states``.
    """
    with open(path, "rb") as f:
        demo = pickle.load(f)
    if "actions" in demo:
        demo["actions"] = [np.asarray(a) for a in demo["actions"]]
    return demo
