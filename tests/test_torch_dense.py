"""PyTorch port: the dense-reward Sawyer env against the JAX package.

Both packages run the scripted generator env (a dense env) on table_lack at
``SimConfig(control_freq=100)`` (5 substeps per control step), ik control,
on the CPU; the port runs the arm kernel's plain version. States are made by
the port and cross as numpy (``furniture_tpu_torch.convert``).

* subtask tables: integers exact, floats 1e-6;
* ``_subtask_vars`` from one settled reset, at subtasks 0 and 2 (with and
  without a grip-init waypoint): dense fields 1e-5, ``phase_i`` and
  ``subtask_step`` exact;
* ``_finish_step`` on one post-physics state staged into each of the eight
  phases, with a table moved, a wrong connect, a correct connect that
  advances the subtask and one that ends the recipe, against JAX
  ``vmap(env._finish_step)``; no physics runs. Reward within 1e-5 of its
  size (its terms scale distances by up to 1e4), every ``prev`` tracker and
  the dense floats 1e-5; the machine's discrete fields exact;
* one dense ik ``step_batch`` against JAX ``vmap(env.step)``: parts and qpos
  1e-3, reward 1e-3, discrete state exact (the arm test's bars);
* replay of a committed demo: its pre-connect state restored with the port's
  ``restore_snapshot`` and its recorded action stepped in both packages, at
  the dense-step bars. This is parity, not a reproduced connect: the demos
  were recorded at 50 substeps, these envs take 5.

Each JAX function is compiled once for the file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.sawyer_dense import DenseState as JDenseState, Prev as JPrev
from furniture_tpu.envs.sawyer_gen import FurnitureSawyerGenEnv as JGenEnv
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import dense_state_from_numpy, dense_state_to_numpy
from furniture_tpu_torch.envs.assembly import tree_where
from furniture_tpu_torch.envs.sawyer_dense import MOVE_EEF_ABOVE_LEG, N_PHASES, Prev
from furniture_tpu_torch.envs.sawyer_gen import FurnitureSawyerGenEnv
from furniture_tpu_torch.robots import kinematics as K
from furniture_tpu_torch.utils.demo import load_demo

torch.set_num_threads(1)

B = 2
DEMO = os.path.join(os.path.dirname(__file__), "..", "demos", "generated",
                    "Sawyer_table_lack_0825_0000.pkl")
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
PREV = tuple(f"prev_{f}" for f in Prev._fields)
MACHINE_EXACT = ("phase_i", "subtask_step", "leg_dropped", "table_moved", "leg_lift",
                 "leg_fine_aligned")
EXACT = MACHINE_EXACT + (
    "group", "num_connected", "connect_step", "conn_connected", "weld_active", "t",
    "subtask", "connected_body1", "touched", "picked", "touch_l", "touch_r",
)
DENSE_FLOATS = ("init_eef_pos", "init_table_site_pos", "init_lift_leg_z", "lift_leg_pos")


def jax_dense(d: dict) -> JDenseState:
    """The flat numpy dict of ``convert`` as a JAX DenseState."""
    parts = JPartState(*(jnp.asarray(d[f]) for f in PART_FIELDS))
    prev = JPrev(*(jnp.asarray(d[f"prev_{f}"]) for f in JPrev._fields))
    rest = {f: jnp.asarray(d[f]) for f in JDenseState._fields if f not in ("parts", "prev")}
    return JDenseState(parts=parts, prev=prev, **rest)


def dense_np(js: JDenseState) -> dict:
    d = {f: np.array(getattr(js.parts, f)) for f in PART_FIELDS}
    d.update({f"prev_{f}": np.array(getattr(js.prev, f)) for f in JPrev._fields})
    d.update({f: np.array(getattr(js, f)) for f in JDenseState._fields if f not in ("parts", "prev")})
    return d


@pytest.fixture(scope="module")
def envs():
    jenv = JGenEnv(JEnvConfig(agent_type="Sawyer", control_type="ik",
                              sim=JSimConfig(control_freq=100)))
    tenv = FurnitureSawyerGenEnv(EnvConfig(agent_type="Sawyer", control_type="ik",
                                           sim=SimConfig(control_freq=100)), device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def jax_step(envs):
    return jax.jit(jax.vmap(envs[0].step))


@pytest.fixture(scope="module")
def reset_state(envs):
    return envs[1].reset_batch(B, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def gripped(envs, reset_state):
    """The reset with subtask 0's leg (part 1) teleported to the grip site,
    so that the fingers close on it."""
    tenv = envs[1]
    s = reset_state
    gp, _ = K.site_world(tenv.robot, K.fk(tenv.robot, s.qpos), "right")
    leg = int(tenv._st["leg"][0])
    pos = s.parts.pos.clone()
    pos[:, leg] = gp + torch.tensor([0.002, -0.001, 0.0])
    return s._replace(parts=s.parts._replace(pos=pos))


def closing_actions(dof, seed):
    a = np.random.default_rng(seed).uniform(-1, 1, (B, dof)).astype(np.float32)
    a[:, -2] = 1.0     # ik layout: +1 closes the gripper
    a[:, -1] = -1.0    # no connect
    return a


def test_subtask_tables_match_jax(envs):
    jenv, tenv = envs
    assert tenv.n_subtasks == jenv.n_subtasks == 4
    assert tenv._z_finedist == jenv._z_finedist
    assert set(tenv._st) == set(jenv._st)
    for k, v in jenv._st.items():
        mine = tenv._st[k]
        assert mine.dtype == np.asarray(v).dtype, k
        if np.issubdtype(mine.dtype, np.floating):
            np.testing.assert_allclose(mine, v, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(mine, v, err_msg=k)
        # the device copies index the same tables
        np.testing.assert_array_equal(tenv._stt[k].numpy(), mine.astype(tenv._stt[k].numpy().dtype))


def test_subtask_vars_match_jax(envs, reset_state):
    """Subtask 0 starts at move_eef_above_leg (no grip-init waypoint),
    subtask 2 at init_eef (a grip-init height)."""
    jenv, tenv = envs
    s = reset_state._replace(subtask_step=torch.tensor([0, 2], dtype=torch.int32))
    fk_out = K.fk(tenv.robot, s.qpos)
    out = dense_state_to_numpy(tenv._subtask_vars(s, fk_out))
    # both take the port's FK (held against the JAX package's in
    # tests/test_torch_arm_kinematics.py), which spares a JAX compile here
    jfk = {k: jnp.asarray(v.numpy()) for k, v in fk_out.items()}
    ref = dense_np(jax.vmap(jenv._subtask_vars)(jax_dense(dense_state_to_numpy(s)), jfk))
    assert out["phase_i"][0] == MOVE_EEF_ABOVE_LEG and out["phase_i"][1] == 0
    for f in MACHINE_EXACT:
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    for f in DENSE_FLOATS + PREV:
        np.testing.assert_allclose(out[f], ref[f], atol=1e-5, rtol=0, err_msg=f)
    # the settled reset itself is the subtask-0 initialization
    np.testing.assert_allclose(dense_state_to_numpy(reset_state)["init_table_site_pos"][0],
                               out["init_table_site_pos"][0], atol=1e-6)


def test_finish_step_every_phase_matches_jax(envs, gripped):
    """Envs 0-7: phases 0-7 with random trackers and flags; 8: a correct
    connect in move_leg_fine (the table top snapped onto the leg's
    connector) that advances to subtask 1; 9: a wrong connect; 10: the table
    moved away; 11: a correct connect of the last subtask (success)."""
    jenv, tenv = envs
    n = 12
    act = closing_actions(tenv.dof, 5)
    post = tenv._step_physics_batch(gripped, torch.as_tensor(act))
    d = {k: np.repeat(v[:1], n, 0) for k, v in dense_state_to_numpy(post).items()}
    rng = np.random.default_rng(7)
    d["phase_i"] = np.array([0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 5, 7], np.int32)
    d["subtask_step"] = np.array([0] * 11 + [3], np.int32)
    for f in PREV:   # distances in [0, 0.6]; cosines and the grip action in [-1, 1]
        lo = -1.0 if f in ("prev_grasp_dist", "prev_move_up_ang_dist",
                           "prev_move_forward_ang_dist", "prev_proj_t", "prev_proj_l") else 0.0
        d[f] = rng.uniform(lo, 0.6 if lo == 0.0 else 1.0, n).astype(np.float32)
    d["leg_lift"] = rng.random(n) < 0.5
    d["leg_dropped"] = rng.random(n) < 0.3
    d["leg_fine_aligned"] = rng.integers(0, 5, n).astype(np.int32)
    d["init_table_site_pos"][10] += np.float32([0.2, 0.0, 0.0])
    state = dense_state_from_numpy(d, "cpu")
    # envs 8 and 11: snap the table top's group onto the subtask's leg
    # connector at the recipe angle (groups left unmerged)
    st = tenv._st
    sub = state.subtask_step.long()
    lsite, tsite = torch.as_tensor(st["leg_site"])[sub], torch.as_tensor(st["table_site"])[sub]
    _, cquat = tenv.ops.conn_world(state.parts)
    cq = cquat[torch.arange(n), lsite]
    up = T.up_vector_from_quat(cq)
    fwd = T.rotate_vector(T.forward_vector_from_quat(cq), up, torch.as_tensor(st["angle"])[sub])
    snapped = tenv.ops.snap_connect(state, lsite.long(), tsite.long(), T.lookat_to_quat(up, fwd))
    snap = torch.zeros(n, dtype=torch.bool)
    snap[[8, 11]] = True
    state = state._replace(parts=tree_where(snap, snapped.parts, state.parts))
    d = dense_state_to_numpy(state)
    prev_connected = d["num_connected"].copy()
    prev_connected[[8, 9, 11]] -= 1
    actions = np.random.default_rng(8).uniform(-1, 1, (n, tenv.dof)).astype(np.float32)

    ts, tobs, trew, tdone, tinfo = tenv._finish_step(
        state, torch.as_tensor(actions), torch.as_tensor(prev_connected))
    js, jobs, jrew, jdone, jinfo = jax.jit(jax.vmap(jenv._finish_step))(
        jax_dense(d), jnp.asarray(actions), jnp.asarray(prev_connected))
    out, ref = dense_state_to_numpy(ts), dense_np(js)
    # the staged cases took the branches they stage
    assert out["subtask_step"][8] == 1 and out["phase_i"][8] == 0
    assert bool(tdone[9]) and not bool(tinfo["success"][9])
    assert out["table_moved"][10] and bool(tinfo["success"][11])
    assert set(out["phase_i"][:8]) != {0}
    for f in EXACT:
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    for f in PREV + DENSE_FLOATS:
        np.testing.assert_allclose(out[f], ref[f], atol=1e-5, rtol=0, err_msg=f)
    # the reward's terms carry coefficients up to 1e4 on distances and a
    # 5000 phase bonus: 1e-5 of its size (one float32 ulp of a distance is
    # ~1e-5 of reward)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    for k, v in jinfo.items():
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(v), atol=1e-5, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(v), err_msg=k)
    for k in jobs:
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), atol=1e-4, rtol=0, err_msg=k)


def compare_step(jout, tout, where):
    js, jobs, jrew, jdone, jinfo = jout
    ts, tobs, trew, tdone, tinfo = tout
    jd, td = dense_np(js), dense_state_to_numpy(ts)
    for f in EXACT:
        np.testing.assert_array_equal(jd[f], td[f], err_msg=f"{where}: {f}")
    for f in ("pos", "quat", "qpos", "ik_target_pos", "hand_quat_init"):
        err = np.max(np.abs(jd[f] - td[f]))
        assert err < 1e-3, (where, f, err)
    assert np.max(np.abs(np.asarray(jrew) - trew.numpy())) < 1e-3, where
    np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
    for k in ("success", "unstable", "phase_i", "touch", "num_connected"):
        np.testing.assert_array_equal(np.asarray(jinfo[k]), tinfo[k].numpy(), err_msg=k)
    assert set(jobs) == set(tobs)


def test_dense_ik_step_matches_jax(envs, gripped, jax_step):
    jenv, tenv = envs
    act = closing_actions(tenv.dof, 4)
    d = dense_state_to_numpy(gripped)
    tout = tenv.step_batch(dense_state_from_numpy(d, "cpu"), torch.as_tensor(act))
    compare_step(jax_step(jax_dense(d), jnp.asarray(act)), tout, "dense ik step")
    assert tout[4]["touch"].any(), "expected the leg between the fingers"
    assert np.all(np.isfinite(tout[2].numpy()))
    assert (tout[4]["phase_i"] < N_PHASES * tenv.n_subtasks).all()


def test_committed_demo_replay_matches_jax(envs, reset_state, jax_step):
    """The state before the recorded first connect, restored, and the
    recorded action stepped in both packages."""
    jenv, tenv = envs
    demo = load_demo(DEMO)
    nconn = np.array([int(s["num_connected"]) for s in demo["states"]])
    t_conn = int(np.argmax(nconn >= 1)) - 1
    assert t_conn >= 0 and demo["connect_actions"][t_conn]
    state = tenv.restore_snapshot(reset_state, demo["states"][t_conn])
    d = dense_state_to_numpy(state)
    np.testing.assert_array_equal(d["qpos"][1], np.asarray(demo["states"][t_conn]["qpos"], np.float32))
    act = np.repeat(np.asarray(demo["actions"][t_conn], np.float32)[None], B, 0)
    tout = tenv.step_batch(dense_state_from_numpy(d, "cpu"), torch.as_tensor(act))
    compare_step(jax_step(jax_dense(d), jnp.asarray(act)), tout, "demo replay")
