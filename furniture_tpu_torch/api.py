"""Host-facing registry and vectorized env.

The port's counterpart of ``furniture_tpu.api``: the env registry
(``register_env``/``get_env``, gym-id parity) and ``make_vec_env`` returning
a :class:`VecEnv`, a batch of envs on one device with auto-reset. The
registry holds the cursor env and the five arm agents; the single-env gym
wrapper with rendering and the dense, generator and toy-table ids wait for
their envs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .config import EnvConfig
from .envs.arm import make_arm_env
from .envs.assembly import tree_where
from .envs.cursor import CursorEnv, resolve_device
from .models import furniture_names

REGISTERED_ENVS: dict[str, Callable] = {}


def register_env(name: str, factory: Callable) -> None:
    REGISTERED_ENVS[name] = factory


def get_env(name: str) -> Callable:
    if name not in REGISTERED_ENVS:
        raise ValueError(
            f"unknown env {name!r}; registered: {sorted(REGISTERED_ENVS)}"
        )
    return REGISTERED_ENVS[name]


class VecEnv:
    """A batch of ``num_envs`` envs on one device with auto-reset.

    ``step`` keeps everything on the device. Lanes that finished are
    replaced by freshly reset ones. Dones are rare (episodes run 2000 steps),
    so the reset runs only on steps where some lane finished; that test
    (``done.any()``) is the one host synchronisation per step."""

    def __init__(self, env_factory, config: EnvConfig, num_envs: int, seed: int = 0,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.env = env_factory(config, self.device)
        self.num_envs = num_envs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._state = None

    def reset(self) -> dict:
        self._state = self.env.reset_batch(self.num_envs, self.generator)
        return self.env.observe(self._state)

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() first")
        state, obs, rew, done, info = self.env.step_batch(self._state, actions)
        if bool(done.any()):
            fresh = self.env.reset_batch(self.num_envs, self.generator)
            state = tree_where(done, fresh, state)
        self._state = state
        return obs, rew, done, info

    @property
    def state(self):
        return self._state


def _resolve_config(kwargs) -> EnvConfig:
    config = kwargs.pop("config", None) or EnvConfig()
    if "furniture_id" in kwargs:
        kwargs["furniture_name"] = furniture_names[kwargs.pop("furniture_id")]
    valid = {f.name for f in dataclasses.fields(EnvConfig)}
    unknown = set(kwargs) - valid
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return config.replace(**kwargs)


def make_vec_env(name: str, num_envs: int, seed: int = 0, device=None, **kwargs) -> VecEnv:
    """``make_vec_env("IKEACursor-v0", 4096)`` or
    ``make_vec_env("IKEASawyer-v0", 512, control_type="impedance")``: config
    fields as keywords; ``device`` defaults to the card."""
    factory = get_env(name)
    config = _resolve_config(kwargs)
    return VecEnv(factory, config, num_envs, seed=seed, device=device)


def _cursor_factory(config: EnvConfig, device=None) -> CursorEnv:
    return CursorEnv(config.replace(agent_type="Cursor"), device=device)


register_env("FurnitureCursorEnv", _cursor_factory)
register_env("IKEACursor-v0", _cursor_factory)

for _agent in ("Sawyer", "Panda", "Jaco", "Fetch", "Baxter"):
    register_env(f"Furniture{_agent}Env", make_arm_env(_agent))
    register_env(f"IKEA{_agent}-v0", make_arm_env(_agent))
