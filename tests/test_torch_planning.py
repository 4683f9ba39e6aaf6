"""PyTorch port: the sampling planners against the JAX package.

Both packages plan on ``CursorEnv`` at ``SimConfig(control_freq=100)`` (5
substeps per control step) from one staged state: cursor 0 holds leg 1 a
few centimetres above the floor, so that a sampled action with the select
bit set carries the leg and moves the cost.

* ``assembly_cost`` on a batch of states carried across with ``convert``
  (some with connectors marked as used, some with a connect counted):
  1e-5;
* MPPI: one plan iteration at ``horizon=3, n_samples=4``. The noise is
  drawn in JAX from the key, as its ``plan`` draws it, and handed to the
  port as ``noise``: rollout costs within 1e-3 (three steps of part floats
  held to 1e-3), the new mean within 1e-4;
* CEM likewise with ``n_elite=2``: mean and sigma within 1e-4 (the elite
  spread is the population standard deviation in both);
* without ``noise`` the port draws from its generator: the same seed gives
  the same plan, another seed another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
from furniture_tpu.planning import cem as jcem
from furniture_tpu.planning import mppi as jmppi
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import cursor_state_from_numpy, cursor_state_to_numpy
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.planning import (
    CEMConfig,
    MPPIConfig,
    assembly_cost,
    make_cem,
    make_mppi,
    rollout_costs,
)

torch.set_num_threads(1)

H, S = 3, 4
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")


@pytest.fixture(scope="module")
def envs():
    jenv = JCursorEnv(JEnvConfig(sim=JSimConfig(control_freq=100)))
    tenv = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
    return jenv, tenv


def _jax_state(jenv, d: dict, batched: bool):
    """The flat numpy dict of ``convert`` as a JAX CursorState."""
    like = jenv._initial_state(jenv._sample_parts(jax.random.PRNGKey(0)))
    parts = like.parts._replace(**{f: jnp.asarray(d[f], jnp.float32) for f in PART_FIELDS})
    rest = {
        f: jnp.asarray(d[f], getattr(like, f).dtype) for f in like._fields if f != "parts"
    }
    state = like._replace(parts=parts, **rest)
    return state if batched else jax.tree.map(lambda x: x[0], state)


@pytest.fixture(scope="module")
def staged(envs):
    """One env (batch 1) with cursor 0 holding leg 1 (the part of the first
    recipe entry) at z = 0.1."""
    _, tenv = envs
    d = cursor_state_to_numpy(tenv.reset_batch(1, torch.Generator().manual_seed(0)))
    d["pos"][0, 1, 2] = 0.1
    d["cursor_pos"][0, 0] = d["pos"][0, 1]
    d["selected"][0] = [1, -1]
    return d


def test_assembly_cost_matches_jax(envs):
    jenv, tenv = envs
    B = 4
    d = cursor_state_to_numpy(tenv.reset_batch(B, torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(0)
    d["pos"] += rng.uniform(-0.05, 0.05, d["pos"].shape).astype(np.float32)
    q = d["quat"] + rng.uniform(-0.2, 0.2, d["quat"].shape).astype(np.float32)
    d["quat"] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    m = tenv.model
    d["conn_connected"][1, [m.recipe_site1[0], m.recipe_site2[0]]] = True   # first entry used
    d["num_connected"][1] = 1
    d["conn_connected"][2] = True                                            # nothing open
    d["num_connected"][2] = 4
    ref = jax.vmap(jmppi.assembly_cost(jenv))(_jax_state(jenv, d, True))
    out = assembly_cost(tenv)(cursor_state_from_numpy(d, "cpu"))
    assert out.shape == (B,)
    assert np.abs(np.asarray(ref) - out.numpy()).max() < 1e-5
    assert out[2].item() == -40.0
    assert len(set(np.round(out.numpy(), 3))) == B      # four different costs


def test_mppi_plan_matches_jax(envs, staged):
    jenv, tenv = envs
    cfg = dict(horizon=H, n_samples=S, temperature=0.05, sigma=0.5, gamma=0.9)
    jcfg, tcfg = jmppi.MPPIConfig(**cfg), MPPIConfig(**cfg)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (S, H, jenv.dof)) * jcfg.sigma)
    noise[:, :, 6] = np.abs(noise[:, :, 6]) * np.array([1, 1, -1, 1])[:, None]   # 3 of 4 keep hold
    mean = np.random.default_rng(1).uniform(-0.3, 0.3, (H, jenv.dof)).astype(np.float32)
    mean[:, 6] = 0.0

    # the JAX plan draws its own noise from the key; to feed both the same
    # (edited) noise, its pieces are called as plan() calls them
    jstate = _jax_state(jenv, staged, False)
    samples = jnp.clip(jnp.asarray(mean)[None] + jnp.asarray(noise), -1.0, 1.0)
    jcosts = jax.jit(jmppi._make_rollout_costs(jenv, jcfg, jmppi.assembly_cost(jenv), S))(jstate, samples)
    jw = jax.nn.softmax(-jcosts / jcfg.temperature)
    jmean = jnp.einsum("s,shd->hd", jw, samples)

    plan = make_mppi(tenv, tcfg)
    tmean, info = plan(cursor_state_from_numpy(staged, "cpu"), torch.from_numpy(mean), None,
                       noise=torch.from_numpy(noise))
    assert np.abs(np.asarray(jcosts) - info["costs"].numpy()).max() < 1e-3
    assert np.abs(np.asarray(jmean) - tmean.numpy()).max() < 1e-4
    assert abs(float(jnp.min(jcosts)) - info["best_cost"].item()) < 1e-3
    assert abs(float(jnp.mean(jcosts)) - info["mean_cost"].item()) < 1e-3
    # the rollouts differ from one another: the held leg was carried
    assert info["costs"].max() - info["costs"].min() > 1e-3


def test_mppi_unedited_jax_plan_matches(envs, staged):
    """JAX ``make_mppi`` end to end with its own draw, handed to the port
    as ``noise``."""
    jenv, tenv = envs
    cfg = dict(horizon=H, n_samples=S, sigma=0.3)
    key = jax.random.PRNGKey(5)
    mean = np.zeros((H, jenv.dof), np.float32)
    mean[:, 6] = 0.5
    jmean, jinfo = jax.jit(jmppi.make_mppi(jenv, jmppi.MPPIConfig(**cfg)))(
        _jax_state(jenv, staged, False), jnp.asarray(mean), key
    )
    noise = np.array(jax.random.normal(key, (S, H, jenv.dof)) * 0.3)
    tmean, info = make_mppi(tenv, MPPIConfig(**cfg))(
        cursor_state_from_numpy(staged, "cpu"), torch.from_numpy(mean), None,
        noise=torch.from_numpy(noise),
    )
    assert np.abs(np.asarray(jmean) - tmean.numpy()).max() < 1e-4
    assert abs(float(jinfo["best_cost"]) - info["best_cost"].item()) < 1e-3


def test_cem_plan_matches_jax(envs, staged):
    jenv, tenv = envs
    cfg = dict(horizon=H, n_samples=S, n_elite=2)
    key = jax.random.PRNGKey(7)
    mean = np.zeros((H, jenv.dof), np.float32)
    mean[:, 6] = 0.5
    sigma = np.full((H, jenv.dof), 0.5, np.float32)
    jm, js, jinfo = jax.jit(jcem.make_cem(jenv, jcem.CEMConfig(**cfg)))(
        _jax_state(jenv, staged, False), jnp.asarray(mean), jnp.asarray(sigma), key
    )
    noise = np.array(jax.random.normal(key, (S, H, jenv.dof)))
    tm, ts, info = make_cem(tenv, CEMConfig(**cfg))(
        cursor_state_from_numpy(staged, "cpu"), torch.from_numpy(mean), torch.from_numpy(sigma),
        None, noise=torch.from_numpy(noise),
    )
    assert np.abs(np.asarray(jm) - tm.numpy()).max() < 1e-4
    assert np.abs(np.asarray(js) - ts.numpy()).max() < 1e-4
    assert abs(float(jinfo["best_cost"]) - info["best_cost"].item()) < 1e-3
    assert (ts >= 0.05).all()


def test_plans_draw_from_the_generator(envs, staged):
    _, tenv = envs
    state = cursor_state_from_numpy(staged, "cpu")
    plan = make_mppi(tenv, MPPIConfig(horizon=2, n_samples=3))
    mean = torch.zeros((2, tenv.dof))
    a, _ = plan(state, mean, torch.Generator().manual_seed(0))
    b, _ = plan(state, mean, torch.Generator().manual_seed(0))
    c, _ = plan(state, mean, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max() <= 1.0
    cem = make_cem(tenv, CEMConfig(horizon=2, n_samples=3, n_elite=2))
    sig = torch.full((2, tenv.dof), 0.5)
    m1, s1, _ = cem(state, mean, sig, torch.Generator().manual_seed(0))
    m2, s2, _ = cem(state, mean, sig, torch.Generator().manual_seed(0))
    assert torch.equal(m1, m2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="noise"):
        plan(state, mean, None, noise=torch.zeros((1, 2, tenv.dof)))


def test_rollout_takes_one_state_with_or_without_batch_dim(envs, staged):
    _, tenv = envs
    state = cursor_state_from_numpy(staged, "cpu")
    samples = torch.zeros((2, 1, tenv.dof))
    cost = assembly_cost(tenv)
    a = rollout_costs(tenv, cost, state, samples)
    single = type(state)(
        type(state.parts)(*(x[0] for x in state.parts)), *(x[0] for x in state[1:])
    )
    b = rollout_costs(tenv, cost, single, samples)
    assert torch.equal(a, b) and a.shape == (2,)
    two = cursor_state_from_numpy({k: np.concatenate([v, v]) for k, v in staged.items()}, "cpu")
    with pytest.raises(ValueError, match="one env"):
        rollout_costs(tenv, cost, two, samples)
