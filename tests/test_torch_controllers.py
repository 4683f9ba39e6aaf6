"""PyTorch port: the torque-space controllers against the JAX package.

* the controller functions of ``controllers/osc.py`` (operational-space
  torques with the nullspace posture term, joint impedance, joint velocity)
  for Sawyer and Baxter on seeded ``qpos``/``qvel``/goals, batched in the
  port and mapped over the batch in JAX: 1e-3 relative to the largest
  torque of the case. The SVD-clamped inverses set the bound: the lambda
  matrices have condition numbers of 1e2-1e4 in f32, and the two SVDs
  (LAPACK through two frameworks) agree to about 1e-5 relative there;
* ``ArmEnv._controller_prepare`` for the five control types on Sawyer and
  Baxter: actuator control 1e-6, ``tau_extra`` 1e-3 relative;
* every one of the five control types steps on the port for Sawyer and
  Baxter with a full-range action: finite, not unstable (the mirror of
  ``tests/test_arm_env.py::test_every_control_type_steps``);
* one ``joint_impedance`` step of Sawyer against JAX ``vmap(env.step)`` at
  ``control_freq=100`` (5 substeps) from a state with part 0 between the
  fingers: parts, qpos and qvel within 5e-4, touch flags and the discrete
  state exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu import transforms as JT
from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.controllers import osc as josc
from furniture_tpu.envs.arm import ArmEnv as JArmEnv, ArmState as JArmState
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu.robots import compile_robot as jax_compile_robot
from furniture_tpu.robots import kinematics as JK
from furniture_tpu_torch import transforms as T
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.controllers import osc
from furniture_tpu_torch.convert import arm_state_from_numpy, arm_state_to_numpy
from furniture_tpu_torch.envs.arm import NEW_CONTROLLERS, ArmEnv
from furniture_tpu_torch.robots import compile_robot
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

B = 3
AGENTS = ("Sawyer", "Baxter")
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
FAST = {"control_freq": 100}


def _joints(robot, seed):
    rng = np.random.default_rng(seed)
    qpos = (np.asarray(robot.init_qpos)[None] + rng.uniform(-0.15, 0.15, (B, robot.nj))).astype(np.float32)
    qvel = rng.uniform(-0.3, 0.3, (B, robot.nj)).astype(np.float32)
    return qpos, qvel


def _rel_close(a, b, rel=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(a).max()), 1e-3)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def robots():
    return {a: (jax_compile_robot(a, use_torque=True), compile_robot(a, use_torque=True)) for a in AGENTS}


def test_controller_config_is_the_jax_packages():
    assert osc.load_controller_config() == josc.load_controller_config()


def test_orientation_error_and_clamped_inverse():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, 2, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    md = T.quat_to_mat(torch.from_numpy(q[:, 0]))
    mc = T.quat_to_mat(torch.from_numpy(q[:, 1]))
    out = osc.orientation_error(md, mc).numpy()
    ref = np.stack([
        np.asarray(josc.orientation_error(jnp.asarray(md[b].numpy()), jnp.asarray(mc[b].numpy())))
        for b in range(B)
    ])
    assert np.abs(out - ref).max() < 1e-6
    # a singular matrix: the clamped inverse drops the null direction
    A = rng.normal(size=(B, 3, 2)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 1e-6 * np.eye(3, dtype=np.float32)
    out = osc._svd_clamped_inv(torch.from_numpy(A)).numpy()
    ref = np.stack([np.asarray(josc._svd_clamped_inv(jnp.asarray(A[b]))) for b in range(B)])
    _rel_close(ref, out)


@pytest.mark.parametrize("position_only", [False, True])
@pytest.mark.parametrize("agent", AGENTS)
def test_osc_torques_match_jax(robots, agent, position_only):
    jr, tr = robots[agent]
    qpos, qvel = _joints(tr, 1)
    rng = np.random.default_rng(2)
    tfk = K.fk(tr, torch.from_numpy(qpos))
    tM = K.mass_matrix(tr, tfk)
    for arm in tr.arms:
        d_pos = rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
        d_eul = rng.uniform(-10, 10, (B, 3)).astype(np.float32)
        eef_pos, eef_quat = K.eef_pose(tr, tfk, arm)
        goal_pos = eef_pos + torch.from_numpy(d_pos)
        goal_mat = T.quat_to_mat(T.euler_to_quat(torch.from_numpy(d_eul), eef_quat))
        init = np.asarray(tr.init_qpos)[tr.arm_joints[arm]]
        out = osc.osc_torques(
            tr, arm, tfk, tM, torch.from_numpy(qpos), torch.from_numpy(qvel), goal_pos, goal_mat,
            150.0, 150.0, 1.0, initial_joint=init, position_only=position_only,
        ).numpy()

        def one(q, v, dp, de):
            fk_out = JK.fk(jr, q)
            M = JK.mass_matrix(jr, fk_out)
            p, qt = JK.eef_pose(jr, fk_out, arm)
            return josc.osc_torques(
                jr, arm, fk_out, M, q, v, p + dp, JT.quat_to_mat(JT.euler_to_quat(de, qt)),
                150.0, 150.0, 1.0, initial_joint=init, position_only=position_only,
            )

        ref = jax.jit(jax.vmap(one))(*map(jnp.asarray, (qpos, qvel, d_pos, d_eul)))
        assert np.abs(out).max() > 1.0           # real torques, not zeros
        _rel_close(ref, out)


@pytest.mark.parametrize("agent", AGENTS)
def test_joint_space_torques_match_jax(robots, agent):
    jr, tr = robots[agent]
    qpos, qvel = _joints(tr, 3)
    rng = np.random.default_rng(4)
    tM = K.mass_matrix(tr, K.fk(tr, torch.from_numpy(qpos)))
    jM = jax.vmap(lambda q: JK.mass_matrix(jr, JK.fk(jr, q)))(jnp.asarray(qpos))
    _rel_close(jM, tM.numpy(), 1e-4)
    for arm in tr.arms:
        aj = np.asarray(tr.arm_joints[arm])
        na = len(aj)
        goal = (qpos[:, aj] + rng.uniform(-0.2, 0.2, (B, na))).astype(np.float32)
        kp = rng.uniform(5, 50, na).astype(np.float32)
        out = osc.joint_impedance_torques(
            tM[:, aj][:, :, aj], torch.from_numpy(qpos[:, aj]), torch.from_numpy(qvel[:, aj]),
            torch.from_numpy(goal), torch.from_numpy(kp), 1.0,
        )
        ref = jax.vmap(
            lambda M, q, v, g: josc.joint_impedance_torques(M[aj][:, aj], q[aj], v[aj], g, jnp.asarray(kp), 1.0)
        )(jM, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(goal))
        _rel_close(ref, out.numpy())
        kv = rng.uniform(0.1, 8, na).astype(np.float32)
        out = osc.joint_velocity_torques(torch.from_numpy(qvel[:, aj]), torch.from_numpy(goal), torch.from_numpy(kv))
        ref = josc.joint_velocity_torques(jnp.asarray(qvel[:, aj]), jnp.asarray(goal), jnp.asarray(kv))
        assert np.abs(np.asarray(ref) - out.numpy()).max() < 1e-5


@pytest.fixture(scope="module")
def jax_envs():
    """One JAX env per agent on the torque variant of the robot; the
    control type is set per case (``_controller_prepare`` reads it when it
    is called)."""
    return {a: JArmEnv(JEnvConfig(agent_type=a, control_type="joint_torque", sim=JSimConfig(**FAST)))
            for a in AGENTS}


@pytest.mark.parametrize("control_type", NEW_CONTROLLERS)
@pytest.mark.parametrize("agent", AGENTS)
def test_controller_prepare_matches_jax(jax_envs, agent, control_type):
    jenv = jax_envs[agent]
    tenv = ArmEnv(EnvConfig(agent_type=agent, control_type=control_type, sim=SimConfig(**FAST)),
                  device="cpu")
    assert tenv.dof == jenv.dof
    qpos, qvel = _joints(tenv.robot, 5)
    act = np.random.default_rng(6).uniform(-1, 1, (B, tenv.dof - 1)).astype(np.float32)
    st = tenv._reset_unsettled(B, torch.Generator().manual_seed(0))
    st = st._replace(qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel))
    ctrl, tau = tenv._controller_prepare(st, torch.from_numpy(act))

    jstate = jenv._reset_unsettled(jax.random.PRNGKey(0))
    jenv.control_type = control_type
    try:
        jctrl, jtau = jax.jit(jax.vmap(
            lambda q, v, a: jenv._controller_prepare(jstate._replace(qpos=q, qvel=v), a)
        ))(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act))
    finally:
        jenv.control_type = "joint_torque"
    assert np.abs(np.asarray(jctrl) - ctrl.numpy()).max() < 1e-6
    assert np.abs(tau.numpy()).max() > 1e-2
    _rel_close(jtau, tau.numpy())


@pytest.mark.parametrize("control_type", NEW_CONTROLLERS)
@pytest.mark.parametrize("agent", AGENTS)
def test_every_control_type_steps(agent, control_type):
    """Every torque-space control mode steps with a full-range action and
    keeps the state finite."""
    env = ArmEnv(EnvConfig(agent_type=agent, control_type=control_type, sim=SimConfig(**FAST)),
                 device="cpu")
    s = env.reset_batch(2, torch.Generator().manual_seed(0))
    a = torch.as_tensor(np.random.RandomState(0).uniform(-1, 1, (2, env.dof)).astype(np.float32))
    s2, obs, rew, done, info = env.step_batch(s, a)
    for t in list(s2.parts) + [s2.qpos, s2.qvel, rew] + list(obs.values()):
        assert torch.isfinite(t.to(torch.float32)).all()
    assert not info["unstable"].any()
    assert (s2.qpos - s.qpos).abs().max() > 1e-5      # the controller torque moved the arm
    assert env.physics.launches == 0                  # CPU: the plain version


def test_joint_impedance_step_matches_jax():
    jenv = JArmEnv(JEnvConfig(agent_type="Sawyer", control_type="joint_impedance", sim=JSimConfig(**FAST)))
    tenv = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="joint_impedance", sim=SimConfig(**FAST)),
                  device="cpu")
    s = tenv.reset_batch(2, torch.Generator().manual_seed(0))
    gp, _ = K.site_world(tenv.robot, K.fk(tenv.robot, s.qpos), "right")
    pos = s.parts.pos.clone()
    pos[:, 0] = gp
    d = arm_state_to_numpy(s._replace(parts=s.parts._replace(pos=pos)))
    act = np.random.default_rng(7).uniform(-1, 1, (2, tenv.dof)).astype(np.float32)
    act[:, -2] = -1.0    # close the gripper hard
    act[:, -1] = -1.0    # no connect
    jparts = JPartState(*(jnp.asarray(d[f]) for f in PART_FIELDS))
    jstate = JArmState(parts=jparts, **{f: jnp.asarray(d[f]) for f in JArmState._fields if f != "parts"})
    js, jobs, jrew, jdone, jinfo = jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(act))
    ts, tobs, trew, tdone, tinfo = tenv.step_batch(arm_state_from_numpy(d, "cpu"), torch.as_tensor(act))
    td = arm_state_to_numpy(ts)
    for f in PART_FIELDS:
        err = np.abs(np.asarray(getattr(js.parts, f)) - td[f]).max()
        assert err < 5e-4, (f, err)
    for f in ("qpos", "qvel"):
        err = np.abs(np.asarray(getattr(js, f)) - td[f]).max()
        assert err < 5e-4, (f, err)
    for f in ("touch_l", "touch_r", "touched", "picked", "group", "num_connected", "t"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), td[f], err_msg=f)
    assert td["touch_l"].any() and td["touch_r"].any(), "expected gripper-part contact"
    assert np.abs(np.asarray(jrew) - trew.numpy()).max() < 1e-3
    np.testing.assert_array_equal(np.asarray(jinfo["unstable"]), tinfo["unstable"].numpy())
    assert np.abs(np.asarray(jobs["robot_ob"]) - tobs["robot_ob"].numpy()).max() < 1e-2
