"""Policy, value and critic networks of the RL stack, and its optimizer.

The port's counterpart of ``furniture_tpu.rl.networks``: the same
orthogonal-init MLPs, as ``nn.Module``s whose layers compute ``x @ w + b``
with ``w`` stored as ``nn.Linear``'s ``weight`` (``wᵀ``). The JAX package's
parameter pytrees carry across with ``convert.rl_params_to_state_dict``.
Observations are flat vectors produced by :func:`flatten_obs`.

Every sampling method takes an explicit ``torch.Generator`` or an explicit
``noise`` tensor (the standard-normal draw), so a test can hand both
packages the same noise.

:class:`ClippedAdam` is ``optax.chain(clip_by_global_norm, adam)``'s update
rule, which ``torch.nn.utils.clip_grad_norm_`` and ``torch.optim.Adam`` do
not reproduce (torch divides by ``norm + 1e-6`` and always rescales, and
places Adam's epsilon after another bias correction).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8     # optax.adam's defaults
_LOG_2PI = math.log(2 * math.pi)


def flatten_obs(obs: dict) -> torch.Tensor:
    """Deterministic dict→vector flattening (sorted keys, ravel + concat).
    Works batched: leading axes are preserved."""
    lead = _lead(obs)
    flat = [
        obs[k].reshape(obs[k].shape[:lead] + (-1,)).to(torch.float32) for k in sorted(obs)
    ]
    return torch.cat(flat, -1)


def _lead(obs: dict) -> int:
    """Number of leading batch axes, inferred from the smallest-rank leaf."""
    return min(v.dim() for v in obs.values()) - 1 if obs else 0


def obs_dim(obs: dict) -> int:
    return int(sum(int(np.prod(v.shape[_lead(obs):])) for v in obs.values()))


_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


class MLP(nn.Module):
    """Orthogonal-init MLP: gain √2 on the hidden layers, ``final_scale`` on
    the last, zero biases; ``activation`` between layers. The weights are
    drawn from ``generator`` (a CPU generator), on the CPU, and then moved
    to ``device``, so one seed gives the same network on every device."""

    def __init__(self, sizes: Sequence[int], activation: str = "tanh",
                 final_scale: float = 1.0, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.activation = activation
        layers = []
        for i in range(len(sizes) - 1):
            lin = nn.Linear(sizes[i], sizes[i + 1])
            gain = np.sqrt(2.0) if i < len(sizes) - 2 else final_scale
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, gain=float(gain), generator=generator)
                lin.bias.zero_()
            layers.append(lin)
        self.layers = nn.ModuleList(layers).to(device)

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        for i, layer in enumerate(self.layers):
            x = x @ layer.weight.T + layer.bias
            if i < len(self.layers) - 1:
                x = act(x)
        return x


def gaussian_logp(x, mean, log_std):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((x - mean) ** 2 / var + 2 * log_std + _LOG_2PI), -1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))


def _noise(mean, generator, noise):
    if noise is not None:
        if noise.shape != mean.shape:
            raise ValueError(f"noise: want {tuple(mean.shape)}, got {tuple(noise.shape)}")
        return noise
    return torch.randn(mean.shape, generator=generator, device=mean.device)


class GaussianPolicy(nn.Module):
    """Diagonal-Gaussian policy: a tanh MLP mean (last layer at gain 0.01)
    and a state-independent ``log_std`` (initially -0.5)."""

    def __init__(self, obs_d: int, act_d: int, hidden=(256, 256), generator=None, device=None):
        super().__init__()
        self.trunk = MLP((obs_d, *hidden, act_d), "tanh", 0.01, generator, device)
        self.log_std = nn.Parameter(torch.full((act_d,), -0.5, device=device))

    def dist(self, obs_vec):
        """(mean, clipped log_std)."""
        return self.trunk(obs_vec), torch.clamp(self.log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample(self, obs_vec, generator=None, noise=None):
        """(action, logp) with ``action = mean + exp(log_std) * noise``."""
        mean, log_std = self.dist(obs_vec)
        action = mean + torch.exp(log_std) * _noise(mean, generator, noise)
        return action, gaussian_logp(action, mean, log_std)


class TanhGaussianPolicy(nn.Module):
    """SAC's squashed Gaussian: a relu MLP giving mean and log_std."""

    def __init__(self, obs_d: int, act_d: int, hidden=(256, 256), generator=None, device=None):
        super().__init__()
        self.trunk = MLP((obs_d, *hidden, 2 * act_d), "relu", 0.01, generator, device)

    def mode(self, obs_vec):
        """The deterministic action: tanh of the mean."""
        return torch.tanh(torch.chunk(self.trunk(obs_vec), 2, -1)[0])

    def sample(self, obs_vec, generator=None, noise=None):
        """(tanh action, its logp, tanh of the mean)."""
        mean, log_std = torch.chunk(self.trunk(obs_vec), 2, -1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        pre = mean + torch.exp(log_std) * _noise(mean, generator, noise)
        action = torch.tanh(pre)
        logp = gaussian_logp(pre, mean, log_std) - torch.sum(
            2.0 * (math.log(2.0) - pre - nn.functional.softplus(-2.0 * pre)), -1
        )
        return action, logp, torch.tanh(mean)


class ValueHead(MLP):
    """State value: a tanh MLP to one output, squeezed."""

    def __init__(self, obs_d: int, hidden=(256, 256), generator=None, device=None):
        super().__init__((obs_d, *hidden, 1), "tanh", 1.0, generator, device)

    def forward(self, obs_vec):
        return super().forward(obs_vec)[..., 0]


class QHead(MLP):
    """State-action value: a relu MLP over ``[obs, action]``, squeezed."""

    def __init__(self, obs_d: int, act_d: int, hidden=(256, 256), generator=None, device=None):
        super().__init__((obs_d + act_d, *hidden, 1), "relu", 1.0, generator, device)

    def forward(self, obs_vec, action):
        return super().forward(torch.cat([obs_vec, action], -1))[..., 0]


class ClippedAdam(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` — or
    ``optax.adam(lr)`` alone with ``max_grad_norm=None`` — as a
    ``torch.optim.Optimizer``: the gradients of all parameters are scaled
    by ``max_norm / norm`` only where their global norm exceeds
    ``max_norm``; then ``mu, nu`` are updated, bias-corrected by
    ``1 - b**count``, and the step is ``-lr * mu_hat / (sqrt(nu_hat) +
    eps)``, with optax's ``b1, b2, eps`` (0.9, 0.999, 1e-8). Runs on the
    parameters' device without a host synchronisation (the count is a
    host integer)."""

    def __init__(self, params, lr: float, max_grad_norm: float | None = None):
        super().__init__(params, dict(lr=lr))
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        if self.max_grad_norm is not None and grads:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_grad_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.max_grad_norm) for g in grads]
        grad_of = dict(zip(map(id, params), grads))
        b1, b2 = ADAM_B1, ADAM_B2
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                if id(p) not in grad_of:
                    continue
                g = grad_of[id(p)]
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * g**2 + b2 * st["nu"]
                c = st["count"]
                mu_hat = st["mu"] / np.float32(1 - np.float32(b1) ** c)
                nu_hat = st["nu"] / np.float32(1 - np.float32(b2) ** c)
                p.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
