"""The system under test and its reference, built from a cell's data.

A configuration file gives the gym id (``env_id``), the ``EnvConfig``
fields (``env``), the ``SimConfig`` fields (``sim``) and the kernel launch
methods whose launches a traced run logs (``launches``); a traffic mix may
add a ``control_type``. The same data builds the port's env
(``furniture_tpu_torch``) and the reference's (``benchmark.reference``).
"""

from __future__ import annotations

import importlib
from operator import attrgetter

import torch

from .reference import make as make_reference_env
from .reference.config import EnvConfig as RefEnvConfig, SimConfig as RefSimConfig
from .reference.envs.assembly import tree_where


def env_fields(ctx, sim_override: dict | None = None):
    """``(EnvConfig fields without sim, SimConfig fields)`` of the cell."""
    kw = dict(ctx.config["env"])
    if ctx.mix.get("control_type"):
        kw["control_type"] = ctx.mix["control_type"]
    sim = {**ctx.config["sim"], **(sim_override or {})}
    return kw, sim


def make_vec_env(ctx, num_envs: int, seed: int):
    """The port's ``VecEnv`` of the cell on the run's device."""
    import furniture_tpu_torch as ft
    from furniture_tpu_torch.config import SimConfig

    kw, sim = env_fields(ctx)
    return ft.make_vec_env(ctx.config["env_id"], num_envs, seed=seed, device=ctx.device,
                           sim=SimConfig(**sim), **kw)


def make_env(ctx, sim_override: dict | None = None):
    """One of the port's batched envs (the registry's factory) of the cell,
    with ``sim_override`` applied to its ``SimConfig``."""
    from furniture_tpu_torch.api import get_env
    from furniture_tpu_torch.config import EnvConfig, SimConfig

    kw, sim = env_fields(ctx, sim_override)
    return get_env(ctx.config["env_id"])(EnvConfig(sim=SimConfig(**sim), **kw), ctx.device)


def make_reference(ctx, sim_override: dict | None = None, state_dtype=None, device=None):
    """The reference's env of the cell (``state_dtype``: the control)."""
    kw, sim = env_fields(ctx, sim_override)
    cfg = RefEnvConfig(sim=RefSimConfig(**sim), **kw)
    return make_reference_env(ctx.config["env_id"], cfg, device or ctx.device, state_dtype)


def watch_launches(ctx, env, sim_override: dict | None = None) -> None:
    """In a traced run, log the frozen work of every launch of the env's
    kernel wrappers (the configuration's ``launches``), counted from the
    reference's model of the same configuration."""
    if not ctx.trace:
        return
    ref = make_reference(ctx, sim_override, device="cpu")
    iters = env_fields(ctx, sim_override)[1]["solver_iters"]
    for spec in ctx.config["launches"]:
        mod = importlib.import_module(f"benchmark.roofline.{spec['kernel']}")
        ctx.tracer.watch(
            spec["kernel"], attrgetter(spec["object"])(env), spec["method"],
            lambda args, mod=mod: mod.call_work(ref, iters, args),
        )


def launch_counts(ctx, env) -> dict:
    """The wrappers' own ``launches`` counters, by wrapper."""
    return {s["object"]: attrgetter(s["object"])(env).launches for s in ctx.config["launches"]}


def reference_vec_step(ref, state, action, generator):
    """``VecEnv.step`` on the reference: a step, then envs that finished
    replaced by fresh resets drawn from ``generator``."""
    state, obs, rew, done, info = ref.step_batch(state, action)
    if bool(done.any()):
        fresh = ref.reset_batch(done.shape[0], generator)
        state = tree_where(done, fresh, state)
    return state, obs, rew, done, info


def generator(ctx, seed: int) -> torch.Generator:
    g = torch.Generator(device=ctx.device)
    g.manual_seed(seed)
    return g
