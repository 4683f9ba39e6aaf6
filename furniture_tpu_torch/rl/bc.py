"""Behavioral cloning from demonstration pickles.

The port's counterpart of ``furniture_tpu.rl.bc``: a minibatch NLL + MSE fit
of the Gaussian policy to (observation, action) pairs stacked from demos
in the ``DemoRecorder`` schema (``utils.demo``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..envs.cursor import resolve_device
from . import networks as N


@dataclass(frozen=True)
class BCConfig:
    lr: float = 1e-3
    batch_size: int = 256
    epochs: int = 100
    hidden: tuple = (256, 256)
    val_frac: float = 0.1


class BCState(NamedTuple):
    params: N.GaussianPolicy     # updated in place
    opt_state: N.ClippedAdam
    generator: torch.Generator


def demos_to_dataset(demos: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """Stack (obs, action) pairs from DemoRecorder-schema demos
    (``len(obs) == len(actions) + 1``). Dict observations are flattened
    with the sorted-key convention."""
    xs, ys = [], []
    for d in demos:
        obs, acts = d["obs"], d["actions"]
        for ob, ac in zip(obs[: len(acts)], acts):
            if isinstance(ob, dict):
                ob = np.concatenate([np.asarray(ob[k], np.float32).ravel() for k in sorted(ob)])
            xs.append(np.asarray(ob, np.float32).ravel())
            ys.append(np.asarray(ac, np.float32).ravel())
    return np.stack(xs), np.stack(ys)


def make_bc(obs_d: int, act_d: int, cfg: BCConfig = BCConfig(), device=None):
    """Returns ``(init, fit_epoch, predict)`` on ``device`` (the card unless
    the caller asks for the CPU). ``init(seed)`` draws the policy from a
    CPU generator seeded with ``seed`` and keeps a generator on ``device``
    for the permutations; ``fit_epoch(state, x, y) -> (state, metrics)``
    runs one epoch of minibatches over a random permutation (the remainder
    of ``n // batch_size`` batches is dropped); ``predict(params, x)`` is
    the policy mean."""
    dev = resolve_device(device)

    def init(seed: int) -> BCState:
        params = N.GaussianPolicy(obs_d, act_d, cfg.hidden, torch.Generator().manual_seed(seed), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return BCState(params, N.ClippedAdam(params.parameters(), cfg.lr), gen)

    def loss_fn(params, x, y):
        mean, log_std = params.dist(x)
        nll = -torch.mean(N.gaussian_logp(y, mean, log_std))
        mse = torch.mean((mean - y) ** 2)
        return nll + mse, mse

    def fit_epoch(state: BCState, x, y):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        n = x.shape[0]
        nb = max(n // cfg.batch_size, 1)
        perm = torch.randperm(n, generator=state.generator, device=dev)[: nb * cfg.batch_size]
        losses, mses = [], []
        for idx in perm.reshape(nb, -1):
            loss, mse = loss_fn(state.params, x[idx], y[idx])
            state.opt_state.zero_grad(set_to_none=True)
            loss.backward()
            state.opt_state.step()
            losses.append(loss.detach())
            mses.append(mse.detach())
        return state, {"loss": torch.stack(losses).mean(), "mse": torch.stack(mses).mean()}

    @torch.no_grad()
    def predict(params, x):
        return params.dist(torch.as_tensor(x, dtype=torch.float32, device=dev))[0]

    return init, fit_epoch, predict
