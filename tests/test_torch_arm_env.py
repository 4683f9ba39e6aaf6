"""PyTorch port: the batched Sawyer arm env against the JAX package.

Both packages run table_lack at ``SimConfig(control_freq=100)`` (5 substeps
per control step), B = 2, on the CPU; the port runs the arm kernel's plain
version. States are made by the port (a reset, then part 0 teleported
between the fingers, as ``tests/test_arm_megakernel.py`` does) and cross as
numpy (``furniture_tpu_torch.convert``).

* substeps: the plain arm substeps against JAX ``vmap(env._sim_substeps)``,
  gripper closing, n = 5: parts, qpos, qvel within 5e-4, touch flags exact
  with at least one set;
* the same for Baxter (two arms, K = 1610), n = 3, at the default config;
* step: ``step_batch`` against JAX ``vmap(env.step)`` for ``impedance`` and
  for ``ik`` (which runs the ×3 action repeat): parts and qpos 1e-3, reward
  1e-3, discrete state exact;
* forced connect: leg 0 held between the fingers with the table top staged
  at its connector, connect action: both packages merge the same groups.

Each JAX function is compiled once for the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.arm import ArmEnv as JArmEnv, ArmState as JArmState
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import arm_state_from_numpy, arm_state_to_numpy
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

B = 2
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
EXACT = (
    "group", "num_connected", "connect_step", "conn_connected", "weld_active", "t",
    "subtask", "connected_body1", "touched", "picked", "touch_l", "touch_r",
)


def jax_arm_state(d: dict) -> JArmState:
    """The flat numpy dict of ``convert`` as a JAX ArmState."""
    parts = JPartState(*(jnp.asarray(d[f]) for f in PART_FIELDS))
    rest = {f: jnp.asarray(d[f]) for f in JArmState._fields if f != "parts"}
    return JArmState(parts=parts, **rest)


def to_np(jstate) -> dict:
    d = {f: np.array(getattr(jstate.parts, f)) for f in PART_FIELDS}
    for f in jstate._fields:
        if f != "parts":
            d[f] = np.array(getattr(jstate, f))
    return d


def make_envs(control_type):
    jenv = JArmEnv(JEnvConfig(agent_type="Sawyer", control_type=control_type,
                              sim=JSimConfig(control_freq=100)))
    tenv = ArmEnv(EnvConfig(agent_type="Sawyer", control_type=control_type,
                            sim=SimConfig(control_freq=100)), device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def imp_envs():
    return make_envs("impedance")


@pytest.fixture(scope="module")
def gripped(imp_envs):
    """A port reset with part 0 teleported to the grip site, so that the
    robot lanes, the squeeze servo and the joint coupling all see work."""
    _, tenv = imp_envs
    s = tenv.reset_batch(B, torch.Generator().manual_seed(0))
    gp, _ = K.site_world(tenv.robot, K.fk(tenv.robot, s.qpos), "right")
    pos = s.parts.pos.clone()
    pos[:, 0] = gp
    return arm_state_to_numpy(s._replace(parts=s.parts._replace(pos=pos)))


@pytest.fixture(scope="module")
def jax_imp_step(imp_envs):
    return jax.jit(jax.vmap(imp_envs[0].step))


def closing_actions(dof, seed):
    a = np.random.default_rng(seed).uniform(-1, 1, (B, dof)).astype(np.float32)
    a[:, -2] = -1.0    # close the gripper hard
    a[:, -1] = -1.0    # no connect
    return a


def compare_step(jout, tout, where):
    js, jobs, jrew, jdone, jinfo = jout
    ts, tobs, trew, tdone, tinfo = tout
    jd, td = to_np(js), arm_state_to_numpy(ts)
    for f in EXACT:
        np.testing.assert_array_equal(jd[f], td[f], err_msg=f"{where}: {f}")
    for f in ("pos", "quat", "qpos", "ik_target_pos", "hand_quat_init"):
        err = np.max(np.abs(jd[f] - td[f]))
        assert err < 1e-3, (where, f, err)
    assert np.max(np.abs(np.asarray(jrew) - trew.numpy())) < 1e-3, where
    np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
    np.testing.assert_array_equal(np.asarray(jinfo["unstable"]), tinfo["unstable"].numpy())
    for k in jobs:
        err = np.max(np.abs(np.asarray(jobs[k]) - tobs[k].numpy()))
        # robot_ob carries velocities, which move faster than positions
        assert err < (1e-2 if k == "robot_ob" else 1e-3), (where, k, err)


def test_plain_arm_substeps_match_jax(imp_envs, gripped):
    jenv, tenv = imp_envs
    act = closing_actions(tenv.dof, 1)
    tctrl = tenv._direct_ctrl(torch.as_tensor(act[:, :-1]))
    jctrl = jax.vmap(jenv._direct_ctrl)(jnp.asarray(act[:, :-1]))
    assert np.max(np.abs(np.asarray(jctrl) - tctrl.numpy())) < 1e-6
    ref = jax.jit(jax.vmap(lambda st, c: jenv._sim_substeps(st, c, None, 5)))(
        jax_arm_state(gripped), jctrl
    )
    out = tenv._substeps(arm_state_from_numpy(gripped, "cpu"), tctrl, None, 5)
    for f in PART_FIELDS:
        err = np.max(np.abs(np.asarray(getattr(ref.parts, f)) - getattr(out.parts, f).numpy()))
        assert err < 5e-4, (f, err)
    assert np.max(np.abs(np.asarray(ref.qpos) - out.qpos.numpy())) < 5e-4
    assert np.max(np.abs(np.asarray(ref.qvel) - out.qvel.numpy())) < 5e-4
    np.testing.assert_array_equal(np.asarray(ref.touch_l), out.touch_l.numpy())
    np.testing.assert_array_equal(np.asarray(ref.touch_r), out.touch_r.numpy())
    assert out.touch_l.any() and out.touch_r.any(), "expected gripper-part contact"


def test_plain_arm_substeps_match_jax_baxter():
    """Baxter (two arms, 19 joints, K = 1610 with the fingertip-dense
    tier): part 0 placed in the right arm's left fingertip (off its center:
    a sample point exactly on a box center ties the least-penetrated axis),
    grippers closing, n = 3 within 5e-4, touch flags exact and set."""
    jenv = JArmEnv(JEnvConfig(agent_type="Baxter", control_type="impedance"))
    tenv = ArmEnv(EnvConfig(agent_type="Baxter", control_type="impedance"), device="cpu")
    r = tenv.robot
    s = tenv.reset_batch(B, torch.Generator().manual_seed(0))
    tip = K.geom_world(r, K.fk(r, s.qpos))[0][:, int(r.finger_geoms_l[tenv.arms[0]][-1])]
    pos = s.parts.pos.clone()
    pos[:, 0] = tip + torch.tensor([0.004, 0.003, 0.002])
    d = arm_state_to_numpy(s._replace(parts=s.parts._replace(pos=pos)))
    act = np.random.default_rng(2).uniform(-1, 1, (B, tenv.dof)).astype(np.float32)
    act[:, -3:-1] = -1.0
    tctrl = tenv._direct_ctrl(torch.as_tensor(act[:, :-1]))
    jctrl = jax.vmap(jenv._direct_ctrl)(jnp.asarray(act[:, :-1]))
    ref = jax.jit(jax.vmap(lambda st, c: jenv._sim_substeps(st, c, None, 3)))(jax_arm_state(d), jctrl)
    out = tenv._substeps(arm_state_from_numpy(d, "cpu"), tctrl, None, 3)
    for f in PART_FIELDS:
        err = np.max(np.abs(np.asarray(getattr(ref.parts, f)) - getattr(out.parts, f).numpy()))
        assert err < 5e-4, (f, err)
    assert np.max(np.abs(np.asarray(ref.qpos) - out.qpos.numpy())) < 5e-4
    assert np.max(np.abs(np.asarray(ref.qvel) - out.qvel.numpy())) < 5e-4
    np.testing.assert_array_equal(np.asarray(ref.touch_l), out.touch_l.numpy())
    np.testing.assert_array_equal(np.asarray(ref.touch_r), out.touch_r.numpy())
    assert out.touch_l.any() or out.touch_r.any(), "expected gripper-part contact"


def test_step_batch_matches_jax_impedance(imp_envs, gripped, jax_imp_step):
    """From the plain reset (no contact) and from the gripped state."""
    jenv, tenv = imp_envs
    free = arm_state_to_numpy(tenv.reset_batch(B, torch.Generator().manual_seed(1)))
    for where, d, seed in (("free", free, 2), ("gripped", gripped, 3)):
        act = closing_actions(tenv.dof, seed)
        jout = jax_imp_step(jax_arm_state(d), jnp.asarray(act))
        tout = tenv.step_batch(arm_state_from_numpy(d, "cpu"), torch.as_tensor(act))
        compare_step(jout, tout, where)


def test_step_batch_matches_jax_ik(gripped):
    """The ik step: DLS solve, then three control steps of P-controlled
    velocities through the arm substeps."""
    jenv, tenv = make_envs("ik")
    act = closing_actions(tenv.dof, 4)
    act[:, -2] = 1.0   # ik layout: +1 closes
    jout = jax.jit(jax.vmap(jenv.step))(jax_arm_state(gripped), jnp.asarray(act))
    tout = tenv.step_batch(arm_state_from_numpy(gripped, "cpu"), torch.as_tensor(act))
    compare_step(jout, tout, "ik")


def test_forced_connect_matches_jax(imp_envs, jax_imp_step):
    """Leg 0 skewered through both finger pads of the raised hand (so both
    fingers touch it at once), the table top staged with its connector on
    the leg's; a connect action welds them in one step in both packages."""
    jenv, tenv = imp_envs
    r, ops = tenv.robot, tenv.ops
    s = tenv.reset_batch(B, torch.Generator().manual_seed(0))
    qpos = s.qpos.clone()
    qpos[:, 1] -= 0.8          # raise the hand: room for the table top
    qpos[:, 5] += 0.8
    fk_out = K.fk(r, qpos)
    gp, _ = K.site_world(r, fk_out, "right")
    hand_pos, _ = K.eef_pose(r, fk_out, "right")
    rg_pos, _ = K.geom_world(r, fk_out)
    a = T.unit(rg_pos[:, int(r.finger_geoms_l["right"][-1])]
               - rg_pos[:, int(r.finger_geoms_r["right"][-1])])     # leg axis: finger to finger
    x = T.rotate_vector(T.unit(T.cross(T.unit(gp - hand_pos), a)), a, 180.0)
    q_leg = T.mat_to_quat(torch.stack([x, T.cross(a, x), a], -1))
    pos, quat = s.parts.pos.clone(), s.parts.quat.clone()
    pos[:, 0], quat[:, 0] = gp, q_leg
    st = s._replace(parts=s.parts._replace(pos=pos, quat=quat), qpos=qpos)
    # the table top (part 4, site 6) snapped onto the leg's connector (site
    # 0) at the recipe angle, groups left unmerged
    _, cquat = ops.conn_world(st.parts)
    up = T.up_vector_from_quat(cquat[:, 0])
    fwd = T.rotate_vector(T.forward_vector_from_quat(cquat[:, 0]), up, 270.0)
    full = lambda v: torch.full((B,), v, dtype=torch.long)
    snapped = ops.snap_connect(st, full(0), full(6), T.lookat_to_quat(up, fwd))
    staged = arm_state_to_numpy(st._replace(parts=snapped.parts))

    act = np.zeros((B, tenv.dof), np.float32)
    act[:, -2] = -1.0
    act[:, -1] = 1.0           # connect
    js, _, jrew, _, jinfo = jax_imp_step(jax_arm_state(staged), jnp.asarray(act))
    ts, _, trew, _, tinfo = tenv.step_batch(arm_state_from_numpy(staged, "cpu"), torch.as_tensor(act))
    np.testing.assert_array_equal(np.asarray(js.num_connected), [1] * B)
    np.testing.assert_array_equal(ts.num_connected.numpy(), [1] * B)
    np.testing.assert_array_equal(np.asarray(js.group), ts.group.numpy())
    assert (ts.group[:, 0] == ts.group[:, 4]).all()
    np.testing.assert_array_equal(np.asarray(js.weld_active), ts.weld_active.numpy())
    np.testing.assert_array_equal(np.asarray(js.conn_connected), ts.conn_connected.numpy())
    np.testing.assert_array_equal(np.asarray(js.touched), ts.touched.numpy())
    assert np.max(np.abs(np.asarray(jrew) - trew.numpy())) < 1e-3
    assert np.max(np.abs(np.asarray(js.parts.pos) - ts.parts.pos.numpy())) < 1e-3
