"""MPPI (model-predictive path integral) planning over the batched env.

The port's counterpart of ``furniture_tpu.planning.mppi``. A plan step
samples N action sequences around the current mean, rolls all of them out
through ``env.step_batch`` with the sample axis as the batch axis (so the
physics kernels carry the planner's inner loop), softmax-weights the
returns and updates the mean. Everything stays on the env's device; a plan
step has no host synchronisation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import transforms as T
from ..envs.assembly import rows
from ..envs.cursor import _unsqueeze


@dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 16
    n_samples: int = 256
    temperature: float = 1.0
    sigma: float = 0.3
    gamma: float = 1.0  # discount on per-step cost


def assembly_cost(env):
    """Dense guidance cost for furniture assembly, batched: for each env,
    distance plus misalignment (1 - cosine of the up vectors) of the first
    recipe connector pair that is still open, minus a progress bonus of 10
    per connect. Returns ``cost(state) -> [B]``."""
    m = env.model
    dev = env.device
    n_recipe = len(m.recipe_site1)
    rs1 = torch.as_tensor(np.asarray(m.recipe_site1, np.int64), device=dev)
    rs2 = torch.as_tensor(np.asarray(m.recipe_site2, np.int64), device=dev)

    def cost(state) -> torch.Tensor:
        progress = -10.0 * state.num_connected.to(torch.float32)
        if m.n_conn == 0 or n_recipe == 0:
            return torch.zeros_like(progress)
        cpos, cquat = env.ops.conn_world(state.parts)
        # first recipe entry whose sites are not yet connected
        open_mask = ~(state.conn_connected[:, rs1] | state.conn_connected[:, rs2])
        any_open = torch.any(open_mask, -1)
        i = torch.argmax(open_mask.to(torch.uint8), -1)
        s1, s2 = rs1[i], rs2[i]
        d = torch.linalg.norm(rows(cpos, s1) - rows(cpos, s2), dim=-1)
        u1 = T.up_vector_from_quat(rows(cquat, s1))
        u2 = T.up_vector_from_quat(rows(cquat, s2))
        misalign = 1.0 - torch.sum(u1 * u2, -1)
        return torch.where(any_open, d + 0.3 * misalign, torch.zeros_like(d)) + progress

    return cost


def _broadcast(state, S: int):
    """One env's state (with or without a batch dimension of 1) repeated to
    a batch of ``S``."""
    if isinstance(state, tuple):
        return type(state)(*(_broadcast(x, S) for x in state))
    return state.repeat((S,) + (1,) * (state.dim() - 1))


def rollout_costs(env, cost_fn, state, samples, gamma: float = 1.0):
    """Total cost [S] of each action sequence of ``samples`` [S,H,dof] from
    ``state`` (one env's state), rolled out through ``env.step_batch``:
    per step the cost of the reached state minus the step's reward,
    discounted by ``gamma``."""
    S, H = samples.shape[:2]
    first = state.group
    if first.dim() == 1:                       # no batch dimension
        state = _unsqueeze(state)
    elif first.shape[0] != 1:
        raise ValueError(f"the planner takes one env's state, got a batch of {first.shape[0]}")
    sts = _broadcast(state, S)
    total = torch.zeros(S, dtype=torch.float32, device=samples.device)
    disc = 1.0
    for h in range(H):
        sts, _, rew, _, _ = env.step_batch(sts, samples[:, h])
        total = total + disc * (cost_fn(sts) - rew)
        disc = disc * gamma
    return total


def _noise(cfg: MPPIConfig, dof: int, mean, generator, noise):
    """``noise`` [S,H,dof] checked, or ``sigma``-scaled normal noise drawn
    from ``generator``."""
    want = (cfg.n_samples, cfg.horizon, dof)
    if noise is None:
        return torch.randn(want, generator=generator, device=mean.device) * cfg.sigma
    if tuple(noise.shape) != want:
        raise ValueError(f"noise: want {want}, got {tuple(noise.shape)}")
    return noise


def make_mppi(env, cfg: MPPIConfig, cost_fn=None):
    """MPPI plan step ``plan(state, mean [H,dof], generator, noise=None) ->
    (new_mean, info)``. ``noise`` [S,H,dof], when given, replaces the draw
    of ``sigma``-scaled normal noise from ``generator``."""
    cost_fn = cost_fn or assembly_cost(env)

    def plan(state, mean, generator, noise=None):
        noise = _noise(cfg, env.dof, mean, generator, noise)
        samples = torch.clamp(mean[None] + noise, -1.0, 1.0)
        costs = rollout_costs(env, cost_fn, state, samples, cfg.gamma)   # [S]
        w = torch.softmax(-costs / cfg.temperature, dim=0)
        new_mean = torch.einsum("s,shd->hd", w, samples)
        info = {"best_cost": costs.min(), "mean_cost": costs.mean(), "costs": costs}
        return new_mean, info

    return plan
