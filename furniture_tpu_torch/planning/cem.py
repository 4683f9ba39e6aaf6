"""Cross-entropy-method planner: elite-refit counterpart to MPPI.

The port's counterpart of ``furniture_tpu.planning.cem``. The samples roll
out through ``env.step_batch`` (the JAX package maps its single-env step
over them, which computes the same per env).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .mppi import assembly_cost, rollout_costs


@dataclass(frozen=True)
class CEMConfig:
    horizon: int = 16
    n_samples: int = 256
    n_elite: int = 32
    sigma_init: float = 0.5
    sigma_min: float = 0.05
    alpha: float = 0.2  # mean/std smoothing


def make_cem(env, cfg: CEMConfig, cost_fn=None):
    """CEM plan step ``plan(state, mean [H,dof], sigma [H,dof], generator,
    noise=None) -> (mean, sigma, info)``. ``noise`` [S,H,dof], when given,
    replaces the draw of unit normal noise from ``generator``. The elite
    spread is the population standard deviation."""
    cost_fn = cost_fn or assembly_cost(env)
    H, S, dof = cfg.horizon, cfg.n_samples, env.dof

    def plan(state, mean, sigma, generator, noise=None):
        if noise is None:
            noise = torch.randn((S, H, dof), generator=generator, device=mean.device)
        elif tuple(noise.shape) != (S, H, dof):
            raise ValueError(f"noise: want {(S, H, dof)}, got {tuple(noise.shape)}")
        samples = torch.clamp(mean[None] + sigma[None] * noise, -1.0, 1.0)
        costs = rollout_costs(env, cost_fn, state, samples)
        _, elite_idx = torch.topk(-costs, cfg.n_elite)
        elite = samples[elite_idx]
        new_mean = cfg.alpha * mean + (1 - cfg.alpha) * elite.mean(0)
        new_sigma = cfg.alpha * sigma + (1 - cfg.alpha) * elite.std(0, correction=0)
        new_sigma = torch.clamp(new_sigma, min=cfg.sigma_min)
        info = {"best_cost": costs[elite_idx[0]], "costs": costs}
        return new_mean, new_sigma, info

    return plan
