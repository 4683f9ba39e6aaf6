"""PyTorch port: the batched cursor env against the JAX package.

Both packages run table_lack at ``SimConfig(control_freq=100)`` (5
substeps per control step), B = 4, on the CPU. State crosses as numpy
(``furniture_tpu_torch.convert``).

* settle: a placement sampled by JAX, settled by the port, against JAX's
  ``reset_batch`` settle (its own batched substeps, 10 rounds of 10);
* step: ``step_batch`` against JAX ``vmap(env.step)`` from that JAX reset,
  three steps of seeded uniform actions;
* staged connect: the connect sequence of ``tests/test_cursor_env.py``
  through both packages, groups and counts exact at every step;
* chair_balser_0115 at B = 2: the settle and three steps, as above, on a
  model whose 4153 contact lanes kernel 1 keeps in its global scratch
  buffer on the card.

Discrete fields must match exactly and the reward within 1e-5. Part
floats get 1e-3: f32 sums taken in another order feed thresholded contact
logic. Each JAX function is compiled once for the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import cursor_state_from_numpy, cursor_state_to_numpy
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.physics.state import PartState

torch.set_num_threads(1)

B = 4
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
EXACT = (
    "group", "selected", "num_connected", "connect_step", "conn_connected",
    "weld_active", "t", "subtask", "connected_body1",
)


def _to_np(state) -> dict:
    """A JAX CursorState as the flat numpy dict of ``convert``."""
    d = {f: np.array(getattr(state.parts, f)) for f in PART_FIELDS}
    for f in state._fields:
        if f != "parts":
            d[f] = np.array(getattr(state, f))
    return d


def _from_np(d: dict, like):
    """The flat numpy dict as a JAX CursorState shaped like ``like``."""
    parts = like.parts._replace(
        **{f: jnp.asarray(d[f], like.parts.pos.dtype) for f in PART_FIELDS}
    )
    rest = {
        f: jnp.asarray(d[f], getattr(like, f).dtype)
        for f in like._fields if f != "parts"
    }
    return like._replace(parts=parts, **rest)


def _compare(jd: dict, td: dict, where: str, atol: float = 1e-3):
    for f in EXACT:
        np.testing.assert_array_equal(jd[f], td[f], err_msg=f"{where}: {f}")
    for f in PART_FIELDS + ("cursor_pos", "connected_body1_pos", "connected_body1_quat"):
        err = np.max(np.abs(jd[f].astype(np.float32) - td[f]))
        assert err < atol, (where, f, err)


@pytest.fixture(scope="module")
def envs():
    jenv = JCursorEnv(JEnvConfig(sim=JSimConfig(control_freq=100)))
    tenv = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
    return jenv, tenv


def _jax_reset(jenv, B):
    """JAX reset_batch on the CPU for ``B`` envs, its settle run one jitted
    round at a time (the same batched substeps, 10 rounds of 10): (sampled
    parts, reset state)."""
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    sampled = jax.jit(jax.vmap(jenv._sample_parts))(keys)
    P = jenv._P
    group = jnp.tile(jnp.arange(P, dtype=jnp.int32), (B, 1))
    gscale = jnp.zeros((B, P))
    clip = jenv.config.sim.slow_clip

    @jax.jit
    def settle_round(parts):
        parts = parts._replace(
            lin_vel=jnp.zeros_like(parts.lin_vel), ang_vel=jnp.zeros_like(parts.ang_vel)
        )
        parts = jenv._batched_substeps(parts, group, gscale, 10)
        return parts._replace(
            lin_vel=jnp.clip(parts.lin_vel, -clip, clip),
            ang_vel=jnp.clip(parts.ang_vel, -clip, clip),
        )

    parts = sampled
    for _ in range(10):
        parts = settle_round(parts)
    parts = parts._replace(
        lin_vel=jnp.zeros_like(parts.lin_vel), ang_vel=jnp.zeros_like(parts.ang_vel)
    )
    state = jax.vmap(jenv._apply_reset_variants)(
        jax.vmap(jenv._initial_state)(parts), keys
    )
    return sampled, state


@pytest.fixture(scope="module")
def jax_reset(envs):
    return _jax_reset(envs[0], B)


@pytest.fixture(scope="module")
def jax_step(envs):
    return jax.jit(jax.vmap(envs[0].step))


def test_settle_matches_jax(envs, jax_reset):
    _, tenv = envs
    sampled, jstate = jax_reset
    parts = PartState(*(torch.as_tensor(np.array(getattr(sampled, f))) for f in PART_FIELDS))
    tstate = tenv.reset_from_parts(parts)
    assert tenv.physics.launches == 0  # CPU: the plain version
    _compare(_to_np(jstate), cursor_state_to_numpy(tstate), "settle")


def test_step_batch_matches_jax(envs, jax_reset, jax_step):
    _, tenv = envs
    jstate = jax_reset[1]
    tstate = cursor_state_from_numpy(_to_np(jstate), "cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.uniform(-1.0, 1.0, (B, 15)).astype(np.float32)
        jstate, _, jr, jd, _ = jax_step(jstate, jnp.asarray(a))
        tstate, _, tr, td, _ = tenv.step_batch(tstate, torch.as_tensor(a))
        _compare(_to_np(jstate), cursor_state_to_numpy(tstate), f"step {i}")
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_staged_connect_matches_jax(envs, jax_reset, jax_step):
    """Leg 0 posed with its conn site on the tabletop's, both held; 11
    connect actions weld them (env 0). Env 1 has the leg 1 m away (never
    connects), env 2 repeats env 0, env 3 holds without the connect action."""
    jenv, tenv = envs
    m = tenv.model
    d = _to_np(jax_reset[1])
    table_site = list(m.conn_names).index("table-leg,0,90,180,270,conn_site1")
    for b in range(B):
        pos = d["pos"][b]
        pos[4] = [0.0, 0.0, 0.5]
        pos[0] = pos[4] + m.conn_pos[table_site] - m.conn_pos[0] + [0.0, 0.0, -0.01]
        if b == 1:
            pos[0, 0] += 1.0
        d["quat"][b] = np.tile([1.0, 0, 0, 0], (5, 1))
        d["selected"][b] = [0, 4]
        d["cursor_pos"][b] = np.stack([pos[0], pos[4]])
    a = np.zeros((B, 15), np.float32)
    a[:, 6] = a[:, 13] = a[:, 14] = 1.0
    a[3, 14] = 0.0
    jstate = _from_np(d, jax_reset[1])
    tstate = cursor_state_from_numpy(d, "cpu")
    for k in range(tenv.config.num_connect_steps + 1):
        jstate, _, jr, _, _ = jax_step(jstate, jnp.asarray(a))
        tstate, _, tr, _, _ = tenv.step_batch(tstate, torch.as_tensor(a))
        jd, td = _to_np(jstate), cursor_state_to_numpy(tstate)
        for f in ("num_connected", "group", "connect_step", "selected"):
            np.testing.assert_array_equal(jd[f], td[f], err_msg=f"step {k}: {f}")
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-5, rtol=0)
    _compare(jd, td, "connected")
    assert td["num_connected"].tolist() == [1, 0, 1, 0]
    assert td["group"][0, 0] == td["group"][0, 4]


def test_chair_balser_matches_jax():
    """chair_balser_0115 (8 parts, 233 geom pairs, 4153 contact lanes, 24
    connection sites) at B = 2: the settle from JAX's sampled placement,
    then three steps of seeded uniform actions from JAX's reset, as on
    table_lack."""
    name, b = "chair_balser_0115", 2
    jenv = JCursorEnv(JEnvConfig(furniture_name=name, sim=JSimConfig(control_freq=100)))
    tenv = CursorEnv(EnvConfig(furniture_name=name, sim=SimConfig(control_freq=100)), device="cpu")
    sampled, jstate = _jax_reset(jenv, b)
    parts = PartState(*(torch.as_tensor(np.array(getattr(sampled, f))) for f in PART_FIELDS))
    _compare(_to_np(jstate), cursor_state_to_numpy(tenv.reset_from_parts(parts)), "settle")
    jax_step = jax.jit(jax.vmap(jenv.step))
    tstate = cursor_state_from_numpy(_to_np(jstate), "cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.uniform(-1.0, 1.0, (b, 15)).astype(np.float32)
        jstate, _, jr, jd, _ = jax_step(jstate, jnp.asarray(a))
        tstate, _, tr, td, _ = tenv.step_batch(tstate, torch.as_tensor(a))
        _compare(_to_np(jstate), cursor_state_to_numpy(tstate), f"step {i}")
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
