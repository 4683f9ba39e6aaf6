"""PPO on the batched env: rollouts through ``step_batch``, GAE, clipped
policy and value losses, epochs of minibatch updates.

The port's counterpart of ``furniture_tpu.rl.ppo``. A rollout steps all
of a device's lanes at once through ``env.step_batch``, so on the card
every env step is one launch of the physics kernel; everything stays on the
env's device. With a ``parallel.Mesh`` each rank steps ``num_envs / n``
lanes, and the JAX package's ``shard_map`` reductions become
``all_reduce`` calls at the same points (below).

Auto-reset: the reference resets every lane on every step and selects the
fresh state where a lane finished. A reset here costs kernel launches (the
settle rounds), so it runs only on steps where some lane finished, as
``VecEnv.step`` does: one ``done.any()`` host synchronisation a step. The
fresh states are drawn from the training state's generator, so the draw
differs from the reference's, not its distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from ..envs.assembly import tree_where
from ..parallel.mesh import broadcast_module, fold_seed, mpi_average
from . import networks as N


@dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 256
    rollout_len: int = 64
    epochs: int = 3
    num_minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    max_grad_norm: float = 0.5
    hidden: tuple = (256, 256)
    normalize_adv: bool = True


class PPOState(NamedTuple):
    params: nn.ModuleDict    # {"pi": GaussianPolicy, "vf": ValueHead}, updated in place
    opt_state: N.ClippedAdam
    env_states: Any          # batched env state [B, ...]
    generator: torch.Generator
    step: int


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def probe_dims(env) -> tuple[int, int]:
    """(observation width, action width) of an env, from a one-env reset on
    the env's device."""
    g = torch.Generator(device=env.device)
    g.manual_seed(0)
    return N.obs_dim(env.observe(env.reset_batch(1, g))), env.dof


def auto_reset(env, states, done, generator):
    """Replace the finished lanes by fresh resets, on steps where some lane
    finished (one host synchronisation)."""
    if bool(done.any()):
        fresh = env.reset_batch(done.shape[0], generator)
        states = tree_where(done, fresh, states)
    return states


def gae(traj: Transition, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over ``[T, B]``: (advantages,
    returns)."""
    adv = torch.zeros_like(traj.reward)
    g = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(traj.reward.shape[0])):
        nonterm = 1.0 - traj.done[t].to(torch.float32)
        delta = traj.reward[t] + gamma * next_value * nonterm - traj.value[t]
        g = delta + gamma * lam * nonterm * g
        adv[t] = g
        next_value = traj.value[t]
    return adv, adv + traj.value


def average_grads(mesh, params: nn.Module) -> None:
    """Every parameter's gradient replaced by its mean over the ranks: one
    ``all_reduce`` of all of them, flattened."""
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    flat = mpi_average(mesh, torch.cat([g.reshape(-1) for g in grads]))
    for g, new in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(new.view_as(g))


def make_ppo(env, cfg: PPOConfig = PPOConfig(), reward_fn: Callable | None = None,
             mesh=None):
    """Build ``(init, train_iter)`` for PPO on a batched env (a
    ``CursorEnv``/``ArmEnv``-style object with ``reset_batch``,
    ``step_batch`` and ``observe``). ``reward_fn(obs_vec, action,
    env_reward)`` optionally overrides the env reward (GAIL plugs its
    discriminator in here).

    With ``mesh`` (a ``parallel.Mesh``; ``num_envs`` must divide over its
    ranks) each rank steps its ``num_envs / n`` lanes, and the ranks meet
    where the JAX package's ``shard_map`` does (``rl/ppo.py:173-174, 189,
    219-220``): the advantages' mean and variance, each minibatch's
    gradients (mean-reduced before the clip and the Adam step, so the
    networks and optimizer stay identical on every rank), and the
    ``reward_per_step`` and ``done_frac`` metrics; the loss metrics are the
    rank's own. ``init`` broadcasts rank 0's networks. Rank r's generator
    (rollout draws, resets, minibatch order) is seeded with
    ``parallel.fold_seed(seed, r)``. Without a mesh nothing of this runs.

    ``init(seed) -> PPOState``: networks drawn from a CPU generator seeded
    with ``seed`` (the same networks on every device), the env lanes reset
    and every later draw taken from a generator on the env's device seeded
    with ``seed``. ``train_iter(state) -> (state, metrics)`` updates the
    networks and optimizer in place and returns the state with the new
    env states and ``step + 1``; the metrics are 0-dim tensors. Its halves
    are attributes, for timing them apart: ``train_iter.rollout(params,
    env_states, generator) -> (env_states, traj, last_value)`` and
    ``train_iter.update(params, opt, traj, adv, ret, generator) ->
    metrics``; ``train_iter.loss(params, batch, adv, ret) -> (loss, aux)``
    is the clipped loss of one minibatch.
    """
    B, T = cfg.num_envs, cfg.rollout_len
    if mesh is not None:
        if B % mesh.world_size:
            raise ValueError(f"num_envs {B} must divide over {mesh.world_size} ranks")
        B //= mesh.world_size                    # this rank's lanes
    sync = (lambda x: x) if mesh is None else (lambda x: mpi_average(mesh, x))
    dev = env.device
    obs_d, act_d = probe_dims(env)

    def init(seed: int) -> PPOState:
        wg = torch.Generator().manual_seed(seed)
        params = nn.ModuleDict({
            "pi": N.GaussianPolicy(obs_d, act_d, cfg.hidden, wg, dev),
            "vf": N.ValueHead(obs_d, cfg.hidden, wg, dev),
        })
        if mesh is not None:
            broadcast_module(mesh, params)
        opt = N.ClippedAdam(params.parameters(), cfg.lr, cfg.max_grad_norm)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed if mesh is None else fold_seed(seed, mesh.rank))
        return PPOState(params, opt, env.reset_batch(B, gen), gen, 0)

    @torch.no_grad()
    def rollout(params, env_states, gen):
        steps = []
        for _ in range(T):
            obs_vec = N.flatten_obs(env.observe(env_states))
            action, logp = params["pi"].sample(obs_vec, gen)
            value = params["vf"](obs_vec)
            env_states, _, rew, done, _ = env.step_batch(env_states, action)
            if reward_fn is not None:
                rew = reward_fn(obs_vec, action, rew)
            env_states = auto_reset(env, env_states, done, gen)
            steps.append(Transition(obs_vec, action, logp, value, rew, done))
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        last_value = params["vf"](N.flatten_obs(env.observe(env_states)))
        return env_states, traj, last_value

    def loss_fn(params, batch: Transition, adv, ret):
        mean, log_std = params["pi"].dist(batch.obs)
        logp = N.gaussian_logp(batch.action, mean, log_std)
        ratio = torch.exp(logp - batch.logp)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        value = params["vf"](batch.obs)
        v_clip = batch.value + torch.clamp(value - batch.value, -cfg.clip_eps, cfg.clip_eps)
        vf_loss = 0.5 * torch.mean(torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2))
        ent = N.gaussian_entropy(log_std)
        loss = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * ent
        return loss, {
            "pg_loss": pg_loss.detach(),
            "vf_loss": vf_loss.detach(),
            "entropy": ent.detach(),
            "approx_kl": torch.mean(batch.logp - logp).detach(),
            "loss": loss.detach(),
        }

    def update(params, opt, traj: Transition, adv, ret, gen):
        n = adv.numel()
        flat = Transition(*(x.reshape((n,) + x.shape[2:]) for x in traj))
        adv, ret = adv.reshape(n), ret.reshape(n)
        if cfg.normalize_adv:
            m = sync(adv.mean())
            v = sync(torch.mean((adv - m) ** 2))
            adv = (adv - m) * torch.rsqrt(v + 1e-8)
        mb = n // cfg.num_minibatches
        aux = []
        for _ in range(cfg.epochs):
            perm = torch.randperm(n, generator=gen, device=adv.device)
            for idx in perm[: mb * cfg.num_minibatches].reshape(cfg.num_minibatches, mb):
                batch = Transition(*(x[idx] for x in flat))
                loss, a = loss_fn(params, batch, adv[idx], ret[idx])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                if mesh is not None:
                    average_grads(mesh, params)
                opt.step()
                aux.append(a)
        return {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]}

    def train_iter(state: PPOState):
        env_states, traj, last_value = rollout(state.params, state.env_states, state.generator)
        adv, ret = gae(traj, last_value, cfg.gamma, cfg.lam)
        metrics = update(state.params, state.opt_state, traj, adv, ret, state.generator)
        metrics["reward_per_step"] = sync(traj.reward.mean())
        metrics["done_frac"] = sync(traj.done.to(torch.float32).mean())
        return state._replace(env_states=env_states, step=state.step + 1), metrics

    # the two halves of an iteration, for timing them apart
    train_iter.rollout = rollout
    train_iter.update = update
    train_iter.loss = loss_fn
    return init, train_iter
