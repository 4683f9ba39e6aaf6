"""SAC with a replay buffer on the env's device.

The port's counterpart of ``furniture_tpu.rl.sac``: each ``train_iter``
steps every env lane once through ``step_batch``, inserts the transitions
into a fixed-size ring buffer of tensors and, after the warm-up, runs the
gradient updates. One Adam (optax's rule, :class:`networks.ClippedAdam`)
updates the policy, both critics and the temperature together, as in the
reference; the target critics follow by Polyak averaging.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch import nn

from . import networks as N
from .ppo import auto_reset, probe_dims


@dataclass(frozen=True)
class SACConfig:
    num_envs: int = 64
    buffer_size: int = 100_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    hidden: tuple = (256, 256)
    target_entropy_scale: float = 1.0   # target = -scale * act_d
    updates_per_step: int = 1
    warmup: int = 1000                  # env transitions before updates start


class Buffer(NamedTuple):
    obs: torch.Tensor        # [N, obs_d]
    action: torch.Tensor     # [N, act_d]
    reward: torch.Tensor     # [N]
    next_obs: torch.Tensor   # [N, obs_d]
    done: torch.Tensor       # [N]
    ptr: int
    size: int


class SACNets(nn.Module):
    """The policy, the two critics, their targets and ``log_alpha``;
    ``nets["pi"]`` reads an attribute, as the reference's parameter dict
    reads a key."""

    def __init__(self, obs_d, act_d, hidden, generator, device):
        super().__init__()
        self.pi = N.TanhGaussianPolicy(obs_d, act_d, hidden, generator, device)
        self.q1 = N.QHead(obs_d, act_d, hidden, generator, device)
        self.q2 = N.QHead(obs_d, act_d, hidden, generator, device)
        self.log_alpha = nn.Parameter(torch.zeros((), device=device))
        self.q1_t = N.QHead(obs_d, act_d, hidden, generator, device).requires_grad_(False)
        self.q2_t = N.QHead(obs_d, act_d, hidden, generator, device).requires_grad_(False)
        self.q1_t.load_state_dict(self.q1.state_dict())
        self.q2_t.load_state_dict(self.q2.state_dict())

    def __getitem__(self, name):
        return getattr(self, name)

    def trainable(self):
        """The parameters the optimizer updates: pi, q1, q2, log_alpha."""
        return [*self.pi.parameters(), *self.q1.parameters(), *self.q2.parameters(),
                self.log_alpha]


class SACState(NamedTuple):
    params: SACNets          # updated in place
    opt_state: N.ClippedAdam
    buffer: Buffer
    env_states: Any
    generator: torch.Generator
    step: int


def _q_detached(q: nn.Module, obs, action):
    """``q(obs, action)`` with the critic's parameters cut from the graph
    (the gradient still reaches ``action``)."""
    params = {k: v.detach() for k, v in q.named_parameters()}
    return torch.func.functional_call(q, params, (obs, action))


def make_sac(env, cfg: SACConfig = SACConfig()):
    """Returns ``(init, train_iter)``; ``init(seed)`` as in
    :func:`ppo.make_ppo`; each ``train_iter(state) -> (state, metrics)``
    steps every env lane once, inserts the transitions and runs the
    gradient updates."""
    B = cfg.num_envs
    dev = env.device
    obs_d, act_d = probe_dims(env)
    target_entropy = -cfg.target_entropy_scale * act_d

    def init(seed: int) -> SACState:
        wg = torch.Generator().manual_seed(seed)
        nets = SACNets(obs_d, act_d, cfg.hidden, wg, dev)
        opt = N.ClippedAdam(nets.trainable(), cfg.lr)
        z = lambda *shape: torch.zeros(shape, device=dev)
        buf = Buffer(
            obs=z(cfg.buffer_size, obs_d), action=z(cfg.buffer_size, act_d),
            reward=z(cfg.buffer_size), next_obs=z(cfg.buffer_size, obs_d),
            done=z(cfg.buffer_size), ptr=0, size=0,
        )
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return SACState(nets, opt, buf, env.reset_batch(B, gen), gen, 0)

    def insert(buf: Buffer, obs, action, reward, next_obs, done) -> Buffer:
        idx = (buf.ptr + torch.arange(B, device=dev)) % cfg.buffer_size
        for dst, src in ((buf.obs, obs), (buf.action, action), (buf.reward, reward),
                         (buf.next_obs, next_obs), (buf.done, done.to(torch.float32))):
            dst[idx] = src
        return buf._replace(ptr=(buf.ptr + B) % cfg.buffer_size,
                            size=min(buf.size + B, cfg.buffer_size))

    def losses(nets: SACNets, batch, eps):
        """The summed loss and its parts; ``eps`` [batch, act] is the noise
        of both policy samples, as one key serves both in the reference."""
        obs, action, reward, next_obs, done = batch
        alpha = torch.exp(nets.log_alpha)
        with torch.no_grad():
            next_a, next_logp, _ = nets.pi.sample(next_obs, noise=eps)
            q_next = torch.minimum(nets.q1_t(next_obs, next_a), nets.q2_t(next_obs, next_a))
            target = reward + cfg.gamma * (1.0 - done) * (q_next - alpha * next_logp)
        q1 = nets.q1(obs, action)
        q2 = nets.q2(obs, action)
        q_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

        new_a, logp, _ = nets.pi.sample(obs, noise=eps)
        q_pi = torch.minimum(_q_detached(nets.q1, obs, new_a), _q_detached(nets.q2, obs, new_a))
        pi_loss = torch.mean(alpha * logp - q_pi)
        alpha_loss = -torch.mean(nets.log_alpha * (logp + target_entropy).detach())
        return q_loss + pi_loss + alpha_loss, {
            "q_loss": q_loss.detach(),
            "pi_loss": pi_loss.detach(),
            "alpha": alpha.detach(),
            "entropy": -torch.mean(logp).detach(),
        }

    def update(nets: SACNets, opt, buf: Buffer, gen):
        idx = torch.randint(0, max(buf.size, 1), (cfg.batch_size,), generator=gen, device=dev)
        batch = (buf.obs[idx], buf.action[idx], buf.reward[idx], buf.next_obs[idx],
                 buf.done[idx])
        eps = torch.randn((cfg.batch_size, act_d), generator=gen, device=dev)
        loss, aux = losses(nets, batch, eps)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for tgt, src in ((nets.q1_t, nets.q1), (nets.q2_t, nets.q2)):
                for t, s in zip(tgt.parameters(), src.parameters()):
                    t.copy_((1 - cfg.tau) * t + cfg.tau * s)
        return aux

    def train_iter(state: SACState):
        nets, gen = state.params, state.generator
        warm = state.step * B < cfg.warmup
        with torch.no_grad():
            obs = N.flatten_obs(env.observe(state.env_states))
            if warm:
                action = torch.rand((B, act_d), generator=gen, device=dev) * 2.0 - 1.0
            else:
                action = nets.pi.sample(obs, gen)[0]
            env_states, _, rew, done, _ = env.step_batch(state.env_states, action)
            next_obs = N.flatten_obs(env.observe(env_states))
            buf = insert(state.buffer, obs, action, rew, next_obs, done)
            env_states = auto_reset(env, env_states, done, gen)
        if warm:
            zero = torch.zeros((), device=dev)
            metrics = {"q_loss": zero, "pi_loss": zero,
                       "alpha": torch.exp(nets.log_alpha).detach(), "entropy": zero}
        else:
            aux = [update(nets, state.opt_state, buf, gen) for _ in range(cfg.updates_per_step)]
            metrics = {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]}
        metrics["reward_per_step"] = rew.mean()
        return state._replace(buffer=buf, env_states=env_states, step=state.step + 1), metrics

    train_iter.losses = losses
    return init, train_iter
