"""PyTorch port: the Baxter toy-table flip task against the JAX package.

The JAX package gives the task's fixed placement and flip reward to its
single-env ``reset`` and ``step``; the port's batched ``reset_batch`` and
``step_batch`` follow that path. Both packages run toy_table_flip with
Baxter (ik, the default control type) at ``SimConfig(control_freq=100)``,
B = 2, on the CPU; the port runs the arm kernel's plain version.

* reset: the port's ``reset_batch`` given the placement noise that JAX
  ``vmap(env.reset)`` drew from its keys (the two packages' random streams
  differ): parts 1e-3 (the placement is exact but for rounding), robot
  state and discrete state exact;
* step: from that state, random actions, ``step_batch`` against JAX
  ``vmap(env.step)``: parts and qpos 1e-3, the flip reward and each of its
  terms 1e-3, discrete state exact;
* the port's own noise draw lies in ±furn_xyz_rand about the fixed poses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.arm import ArmState as JArmState
from furniture_tpu.envs.baxter_toytable import FurnitureBaxterToyTableEnv as JToyTable
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu_torch.api import make_vec_env
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import arm_state_from_numpy, arm_state_to_numpy
from furniture_tpu_torch.envs.baxter_toytable import FurnitureBaxterToyTableEnv, _POS_INIT

torch.set_num_threads(1)

B = 2
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
EXACT = ("group", "num_connected", "connect_step", "conn_connected", "weld_active", "t",
         "subtask", "connected_body1", "touched", "picked", "touch_l", "touch_r")


def to_np(js) -> dict:
    d = {f: np.array(getattr(js.parts, f)) for f in PART_FIELDS}
    d.update({f: np.array(getattr(js, f)) for f in js._fields if f != "parts"})
    return d


def jax_arm_state(d: dict) -> JArmState:
    parts = JPartState(*(jnp.asarray(d[f]) for f in PART_FIELDS))
    return JArmState(parts=parts, **{f: jnp.asarray(d[f]) for f in JArmState._fields if f != "parts"})


@pytest.fixture(scope="module")
def envs():
    jenv = JToyTable(JEnvConfig(sim=JSimConfig(control_freq=100)))
    tenv = FurnitureBaxterToyTableEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def reset_pair(envs):
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    # the noise the JAX reset drew from each key (baxter_toytable.py:54)
    noise = np.stack([
        np.asarray(jenv.config.furn_xyz_rand * jax.random.uniform(
            k, (len(_POS_INIT) * 3,), minval=-1.0, maxval=1.0))
        for k in keys
    ])
    ts = tenv.reset_batch(B, torch.Generator().manual_seed(0), noise=torch.as_tensor(noise))
    return to_np(js), arm_state_to_numpy(ts)


def test_reset_matches_jax(envs, reset_pair):
    jenv, tenv = envs
    assert tenv.config.furniture_name == "toy_table_flip" and tenv.config.agent_type == "Baxter"
    assert tenv.control_type == jenv.control_type == "ik"
    jd, td = reset_pair
    for f in PART_FIELDS:
        np.testing.assert_allclose(td[f], jd[f], atol=1e-3, rtol=0, err_msg=f)
    np.testing.assert_allclose(td["pos"], jd["pos"], atol=1e-6, rtol=0)
    for f in ("qpos", "qvel", "ik_target_pos", "hand_quat_init"):
        np.testing.assert_allclose(td[f], jd[f], atol=1e-5, rtol=0, err_msg=f)
    for f in EXACT:
        np.testing.assert_array_equal(td[f], jd[f], err_msg=f)


def test_step_flip_reward_matches_jax(envs, reset_pair):
    jenv, tenv = envs
    _, td = reset_pair
    act = np.random.default_rng(1).uniform(-1, 1, (B, tenv.dof)).astype(np.float32)
    js, jobs, jrew, jdone, jinfo = jax.jit(jax.vmap(jenv.step))(jax_arm_state(td), jnp.asarray(act))
    ts, tobs, trew, tdone, tinfo = tenv.step_batch(arm_state_from_numpy(td, "cpu"), torch.as_tensor(act))
    jd, out = to_np(js), arm_state_to_numpy(ts)
    for f in ("pos", "quat", "qpos"):
        assert np.max(np.abs(out[f] - jd[f])) < 1e-3, f
    for f in EXACT:
        np.testing.assert_array_equal(out[f], jd[f], err_msg=f)
    assert np.max(np.abs(trew.numpy() - np.asarray(jrew))) < 1e-3
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert set(tinfo) == set(jinfo)
    for k, v in jinfo.items():
        if np.asarray(v).dtype.kind == "f":
            assert np.max(np.abs(tinfo[k].numpy() - np.asarray(v))) < 1e-3, k
        else:
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(v), err_msg=k)
    assert set(tobs) == set(jobs)
    # the table top starts upside down: the grip-hand terms are on
    assert (tinfo["r_gh_dist"] > 0).all() and (tinfo["table_rot_rew"] < 0).all()


def test_own_noise_draw_bounds():
    vec = make_vec_env("FurnitureBaxterToyTableEnv", B, seed=3, device="cpu",
                       sim=SimConfig(control_freq=100))
    vec.reset()
    env = vec.env
    off = vec.state.parts.pos - env._pos_init
    assert (off.abs() <= env.config.furn_xyz_rand).all() and (off.abs() > 0).any()
    assert (vec.state.parts.lin_vel == 0).all()
