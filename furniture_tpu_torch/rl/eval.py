"""Policy evaluation: batched success-rate rollouts.

The port's counterpart of ``furniture_tpu.rl.eval``: ``n_episodes`` env
lanes roll the deterministic policy for ``max_steps`` through
``step_batch`` (no auto-reset: a lane that succeeds keeps its outcome) and
the success statistics reduce on the env's device.
"""

from __future__ import annotations

import torch

from . import networks as N


def ppo_act(params, obs_vec, generator=None):
    """Deterministic PPO policy action (the distribution mean)."""
    return params["pi"].dist(obs_vec)[0]


def sac_act(params, obs_vec, generator=None):
    """Deterministic SAC policy action (tanh of the pre-squash mean)."""
    return params["pi"].mode(obs_vec)


def make_evaluate(env, act_fn, n_episodes: int = 64, max_steps: int = 200):
    """Build ``evaluate(params, generator) -> metrics``: ``success_rate``,
    ``mean_reward`` (summed up to and including the success step) and
    ``mean_episode_len`` (steps to success, or ``max_steps`` for
    failures), 0-dim tensors on the env's device."""
    dev = env.device

    @torch.no_grad()
    def evaluate(params, generator):
        states = env.reset_batch(n_episodes, generator)
        succeeded = torch.zeros(n_episodes, dtype=torch.bool, device=dev)
        succ_t = torch.full((n_episodes,), max_steps, dtype=torch.int32, device=dev)
        total_rew = torch.zeros(n_episodes, device=dev)
        for t in range(max_steps):
            action = act_fn(params, N.flatten_obs(env.observe(states)), generator)
            states, _, rew, _, info = env.step_batch(states, action)
            success = info["success"].to(torch.bool)
            succ_t = torch.where(success & ~succeeded, torch.full_like(succ_t, t + 1), succ_t)
            total_rew = total_rew + torch.where(succeeded, torch.zeros_like(rew), rew)
            succeeded = succeeded | success
        return {
            "success_rate": succeeded.to(torch.float32).mean(),
            "mean_reward": total_rew.mean(),
            "mean_episode_len": succ_t.to(torch.float32).mean(),
        }

    return evaluate
