"""Host-facing registry, single-env wrapper and vectorized env.

The port's counterpart of ``furniture_tpu.api``: the env registry
(``register_env``/``get_env``, gym-id parity); ``make_env`` returning a
:class:`FurnitureEnvWrapper`, one env with numpy in and out and camera
observations from the renderer; and ``make_vec_env`` returning a
:class:`VecEnv`, a batch of envs on one device with auto-reset. The
registry holds the cursor env, the five arm agents, and the task envs: the
dense-reward Sawyer env, the scripted demo generator and the Baxter
toy-table flip (``furniture_tpu.api:277-302``'s ids).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .config import EnvConfig
from .envs.arm import make_arm_env
from .envs.assembly import tree_where
from .envs.cursor import CursorEnv, _unsqueeze, resolve_device
from .models import furniture_names
from .utils.trace import span

REGISTERED_ENVS: dict[str, Callable] = {}


def register_env(name: str, factory: Callable) -> None:
    REGISTERED_ENVS[name] = factory


def get_env(name: str) -> Callable:
    if name not in REGISTERED_ENVS:
        raise ValueError(
            f"unknown env {name!r}; registered: {sorted(REGISTERED_ENVS)}"
        )
    return REGISTERED_ENVS[name]


class Space:
    """Minimal stand-in for ``gym.spaces.Box``/``Dict`` (no gym
    dependency)."""

    def __init__(self, shape=None, low=-np.inf, high=np.inf, spaces=None):
        self.shape = shape
        self.low = low
        self.high = high
        self.spaces = spaces

    def sample(self, rng: np.random.RandomState | None = None):
        rng = rng or np.random
        if self.spaces is not None:
            return {k: v.sample(rng) for k, v in self.spaces.items()}
        lo = -1.0 if not np.isfinite(self.low) else self.low
        hi = 1.0 if not np.isfinite(self.high) else self.high
        return rng.uniform(lo, hi, size=self.shape).astype(np.float32)


def _host(d: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


class FurnitureEnvWrapper:
    """One env with numpy in and out: ``reset()``/``step(action)``, like the
    reference's ``FurnitureEnv`` (``env/furniture.py:318,364``).

    The env runs on ``device`` (the card unless ``device="cpu"``) as a
    batch of one through its own single-env ``reset``/``step``; its draws
    come from a ``torch.Generator`` on that device seeded with ``seed``.
    Camera observations (``camera_ob``, ``depth_ob``, ``segmentation_ob``)
    and ``render`` come from ``render.make_render_fn`` at
    ``screen_width x screen_height``, built at first use."""

    def __init__(self, env_factory, config: EnvConfig, seed: int = 0, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.env = env_factory(config, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._state = None
        self._render_fn = None

    def _frames(self):
        """(rgb, depth, seg) of the current state, on the host."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        if self._render_fn is None:
            from .render import frontview, make_render_fn

            cam = frontview(self.config.screen_width, self.config.screen_height)
            self._render_fn = make_render_fn(self.env, cam)
        return tuple(x[0].cpu().numpy() for x in self._render_fn(_unsqueeze(self._state)))

    def _camera_obs(self, obs: dict) -> dict:
        cfg = self.config
        if cfg.camera_ob or cfg.depth_ob or cfg.segmentation_ob:
            rgb, depth, seg = self._frames()
            if cfg.camera_ob:
                obs["camera_ob"] = rgb
            if cfg.depth_ob:
                obs["depth_ob"] = depth
            if cfg.segmentation_ob:
                obs["segmentation_ob"] = seg
        return obs

    def render(self, mode: str = "rgb_array"):
        """The current state from the camera (``env/furniture.py:586-631``'s
        modes): ``rgb_array`` [H,W,3] in [0,1], ``depth_array`` [H,W] or
        ``segmentation`` [H,W] int32."""
        modes = {"rgb_array": 0, "rgbarray": 0, "human": 0, "depth_array": 1,
                 "segmentation": 2, "seg_array": 2}
        if mode not in modes:
            raise ValueError(f"unknown render mode {mode!r}")
        return self._frames()[modes[mode]]

    @property
    def action_space(self) -> Space:
        return Space(shape=(self.env.dof,), low=-1.0, high=1.0)

    @property
    def observation_space(self) -> Space:
        spaces = {}
        if self.config.object_ob:
            spaces["object_ob"] = Space(shape=(self.env.model.n_parts * 7,))
        if self.config.robot_ob:
            spaces["robot_ob"] = Space(shape=(8,))
        if self.config.subtask_ob:
            spaces["subtask_ob"] = Space(shape=(2,))
        h, w = self.config.screen_height, self.config.screen_width
        if self.config.camera_ob:
            spaces["camera_ob"] = Space(shape=(h, w, 3), low=0.0, high=1.0)
        if self.config.depth_ob:
            spaces["depth_ob"] = Space(shape=(h, w), low=0.0)
        if self.config.segmentation_ob:
            spaces["segmentation_ob"] = Space(shape=(h, w))
        return Space(spaces=spaces)

    def reset(self, seed: int | None = None) -> dict:
        if seed is not None:
            self.generator.manual_seed(seed)
        self._state = self.env.reset(self.generator)
        obs = {k: v[0] for k, v in self.env.observe(_unsqueeze(self._state)).items()}
        return self._camera_obs(_host(obs))

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() first")
        action = torch.as_tensor(np.asarray(action, np.float32), device=self.device)
        self._state, obs, rew, done, info = self.env.step(self._state, action)
        return self._camera_obs(_host(obs)), float(rew), bool(done), _host(info)

    # env-state checkpointing (the reference's get/set_env_state,
    # env/furniture.py:1781-1803): the state itself is the checkpoint
    def get_env_state(self):
        return self._state

    def set_env_state(self, state):
        self._state = state

    def close(self):
        pass


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
        with span("ft.vec.step"):
            state, obs, rew, done, info = self.env.step_batch(self._state, actions)
            with span("ft.vec.sync"):
                any_done = bool(done.any())
            if any_done:
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


def make_env(name: str, seed: int = 0, device=None, **kwargs) -> FurnitureEnvWrapper:
    """``make_env("IKEACursor-v0", camera_ob=True, screen_width=64, ...)``:
    one env, config fields as keywords; ``device`` defaults to the card."""
    factory = get_env(name)
    config = _resolve_config(kwargs)
    return FurnitureEnvWrapper(factory, config, seed=seed, device=device)


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


def _dense_factory(config: EnvConfig, device=None):
    from .envs.sawyer_dense import FurnitureSawyerDenseRewardEnv

    return FurnitureSawyerDenseRewardEnv(config.replace(agent_type="Sawyer"), device=device)


def _gen_factory(config: EnvConfig, device=None):
    from .envs.sawyer_gen import FurnitureSawyerGenEnv

    return FurnitureSawyerGenEnv(config.replace(agent_type="Sawyer"), device=device)


def _toytable_factory(config: EnvConfig, device=None):
    from .envs.baxter_toytable import FurnitureBaxterToyTableEnv

    return FurnitureBaxterToyTableEnv(config, device=device)


# gym-id parity: env/__init__.py:103-114 + furniture_sawyer_gen.py:738
register_env("IKEASawyerDense-v0", _dense_factory)
register_env("furniture-sawyer-densereward-v0", _dense_factory)
register_env("FurnitureSawyerDenseRewardEnv", _dense_factory)
register_env("IKEASawyerGen-v0", _gen_factory)
register_env("FurnitureSawyerGenEnv", _gen_factory)
register_env("FurnitureBaxterToyTableEnv", _toytable_factory)
