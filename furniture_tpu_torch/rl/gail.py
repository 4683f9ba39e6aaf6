"""GAIL: adversarial imitation on top of PPO.

The port's counterpart of ``furniture_tpu.rl.gail``: a relu-MLP
discriminator trained on expert-vs-policy batches with a BCE loss and a
gradient penalty on interpolates (``torch.autograd.grad`` with
``create_graph=True``), whose ``-log(1 - D)`` reward plugs into PPO's
``reward_fn`` hook.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch
from torch import nn

from ..parallel.mesh import broadcast_module, gather_batch
from . import networks as N
from .ppo import PPOConfig, make_ppo


@dataclass(frozen=True)
class GAILConfig:
    lr: float = 3e-4
    hidden: tuple = (256, 256)
    disc_updates: int = 2
    batch_size: int = 256
    grad_penalty: float = 10.0   # WGAN-GP-style stability term
    reward_scale: float = 1.0


class DiscState(NamedTuple):
    params: N.MLP                # updated in place
    opt_state: N.ClippedAdam
    generator: torch.Generator


def make_gail(env, ppo_cfg: PPOConfig, gail_cfg: GAILConfig, expert_obs, expert_act,
              mesh=None):
    """Returns ``(init, disc_reward, disc_update, make_ppo)``.

    ``init(seed) -> (DiscState, policy_seed)``: the discriminator drawn from
    a CPU generator seeded with ``seed``, a generator on the env's device
    for its batches, and a seed for the PPO state. ``disc_reward(params)``
    is a ``reward_fn`` for :func:`make_ppo`. ``disc_update(state,
    policy_obs, policy_act) -> (state, metrics)`` runs ``disc_updates``
    steps on random (expert, policy) batches; ``disc_update.loss(params,
    expert_x, policy_x, eps) -> (loss, aux)`` is the loss of one batch.

    With ``mesh`` (a ``parallel.Mesh``), the returned ``make_ppo`` has the
    mesh bound, ``init`` broadcasts rank 0's discriminator, and
    ``disc_update`` first gathers every rank's policy batch, so each rank
    runs the same steps on the same global batch (as the JAX package's
    ``disc_update`` sees the global arrays) and the discriminator stays
    identical on every rank (seed ``init`` alike on every rank)."""
    dev = env.device
    expert = torch.cat(
        [torch.as_tensor(expert_obs, dtype=torch.float32),
         torch.as_tensor(expert_act, dtype=torch.float32)], -1
    ).to(dev)
    in_d = expert.shape[-1]

    def disc_logits(params, x):
        return params(x)[..., 0]

    def disc_reward(params):
        @torch.no_grad()
        def reward_fn(obs_vec, action, env_rew):
            d = torch.sigmoid(disc_logits(params, torch.cat([obs_vec, action], -1)))
            # -log(1 - D): positive when the policy fools the discriminator
            return gail_cfg.reward_scale * (-torch.log(torch.clamp(1.0 - d, min=1e-6)))

        return reward_fn

    def init(seed: int):
        wg = torch.Generator().manual_seed(seed)
        params = N.MLP((in_d, *gail_cfg.hidden, 1), "relu", 1.0, wg, dev)
        if mesh is not None:
            broadcast_module(mesh, params)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        policy_seed = int(torch.randint(2**31 - 1, (1,), generator=wg))
        return DiscState(params, N.ClippedAdam(params.parameters(), gail_cfg.lr), gen), policy_seed

    def disc_loss(params, expert_x, policy_x, eps):
        """BCE plus the gradient penalty at the interpolates ``eps *
        expert_x + (1 - eps) * policy_x`` (``eps`` [batch, 1])."""
        le = disc_logits(params, expert_x)
        lp = disc_logits(params, policy_x)
        bce = torch.mean(nn.functional.softplus(-le)) + torch.mean(nn.functional.softplus(lp))
        # gradient penalty on interpolates: each row's logit depends on its
        # own row only, so the gradient of the sum is the per-row gradient
        mid = (eps * expert_x + (1 - eps) * policy_x).requires_grad_(True)
        g = torch.autograd.grad(disc_logits(params, mid).sum(), mid, create_graph=True)[0]
        gp = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
        return bce + gail_cfg.grad_penalty * gp, {
            "disc_bce": bce.detach(),
            "disc_acc": 0.5 * (torch.mean((le > 0).to(torch.float32))
                               + torch.mean((lp < 0).to(torch.float32))),
        }

    def disc_update(state: DiscState, policy_obs, policy_act):
        policy_x = torch.cat([policy_obs, policy_act], -1).to(dev)
        if mesh is not None:
            policy_x = gather_batch(mesh, policy_x)
        aux = []
        for _ in range(gail_cfg.disc_updates):
            bs = gail_cfg.batch_size
            ei = torch.randint(0, expert.shape[0], (bs,), generator=state.generator, device=dev)
            pi = torch.randint(0, policy_x.shape[0], (bs,), generator=state.generator, device=dev)
            eps = torch.rand((bs, 1), generator=state.generator, device=dev)
            loss, a = disc_loss(state.params, expert[ei], policy_x[pi], eps)
            state.opt_state.zero_grad(set_to_none=True)
            loss.backward()
            state.opt_state.step()
            aux.append(a)
        return state, {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]}

    disc_update.loss = disc_loss
    return init, disc_reward, disc_update, make_ppo if mesh is None else partial(make_ppo, mesh=mesh)
