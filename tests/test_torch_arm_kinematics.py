"""PyTorch port: robot kinematics, IK and the robot narrow phase against the
JAX package, for Sawyer on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Each
JAX function is jitted once for the file (module-scoped fixtures): one
bundle of the kinematics functions, one ``dls_ik``, one ``_ik_prepare`` and
one ``robot_contacts``. Tolerances: kinematics 1e-5 (G1, G2 1e-4 relative:
they go through a linear solve), IK joint commands 1e-4 after two
iterations and 5e-3 / 2e-3 once converged (see ``test_dls_ik_matches_jax``),
IK target poses 1e-5, contact masks exact and contact floats 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import furniture_tpu.robots.kinematics as JK
from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.controllers.ik import dls_ik as j_dls_ik
from furniture_tpu.envs.arm import ArmEnv as JArmEnv, ArmState as JArmState
from furniture_tpu.physics.collide import robot_contacts as j_robot_contacts
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.controllers.ik import dls_ik
from furniture_tpu_torch.convert import arm_state_from_numpy, arm_state_to_numpy
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.physics.collide import robot_contacts
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

B = 4
DT = 0.002
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")


def jax_arm_state(d: dict) -> JArmState:
    """The flat numpy dict of ``convert`` as a JAX ArmState."""
    parts = JPartState(*(jnp.asarray(d[f]) for f in PART_FIELDS))
    rest = {f: jnp.asarray(d[f]) for f in JArmState._fields if f != "parts"}
    return JArmState(parts=parts, **rest)


@pytest.fixture(scope="module")
def envs():
    jenv = JArmEnv(JEnvConfig(agent_type="Sawyer", control_type="ik",
                              sim=JSimConfig(control_freq=100)))
    tenv = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="ik",
                            sim=SimConfig(control_freq=100)), device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def joints(envs):
    """Random joint positions within the joint ranges, and velocities."""
    r = envs[1].robot
    rng = np.random.default_rng(0)
    lo = np.maximum(r.jnt_range[:, 0], -2.0)
    hi = np.minimum(r.jnt_range[:, 1], 2.0)
    q = rng.uniform(lo, hi, size=(B, r.nj)).astype(np.float32)
    qv = rng.uniform(-1.0, 1.0, size=(B, r.nj)).astype(np.float32)
    return q, qv


@pytest.fixture(scope="module")
def bundle(envs, joints):
    """(JAX outputs, port outputs) of the kinematics functions."""
    jenv, tenv = envs
    jr, tr = jenv.robot, tenv.robot
    body = jr.eef_body["right"]
    q, qv = joints

    def one(qp, qvel):
        fk_out = JK.fk(jr, qp)
        site_pos, _ = JK.site_world(jr, fk_out, "right")
        G1, G2 = JK.joint_dyn_matrices(jr, qp, DT)
        v, w = JK.geom_velocities(jr, fk_out, qvel)
        gp, gq = JK.geom_world(jr, fk_out)
        return {
            "body_pos": fk_out["body_pos"], "body_quat": fk_out["body_quat"],
            "axis_w": fk_out["axis_w"], "anchor_w": fk_out["anchor_w"],
            "J": JK.point_jacobian(jr, fk_out, body, site_pos),
            "M": JK.mass_matrix(jr, fk_out), "G1": G1, "G2": G2,
            "geom_v": v, "geom_w": w, "geom_pos": gp, "geom_quat": gq,
            "site_pos": site_pos, "angvel": JK.body_angvel(jr, fk_out, qvel, body),
            "gravity": JK.gravity_bias(jr, fk_out),
        }

    jout = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(qv)).items()}

    tq, tqv = torch.as_tensor(q), torch.as_tensor(qv)
    fk_out = K.fk(tr, tq)
    site_pos, _ = K.site_world(tr, fk_out, "right")
    G1, G2 = K.joint_dyn_matrices(tr, tq, DT)
    v, w = K.geom_velocities(tr, fk_out, tqv)
    gp, gq = K.geom_world(tr, fk_out)
    tout = {
        "body_pos": fk_out["body_pos"], "body_quat": fk_out["body_quat"],
        "axis_w": fk_out["axis_w"], "anchor_w": fk_out["anchor_w"],
        "J": K.point_jacobian(tr, fk_out, body, site_pos),
        "M": K.mass_matrix(tr, fk_out), "G1": G1, "G2": G2,
        "geom_v": v, "geom_w": w, "geom_pos": gp, "geom_quat": gq,
        "site_pos": site_pos, "angvel": K.body_angvel(tr, fk_out, tqv, body),
        "gravity": K.gravity_bias(tr, fk_out),
    }
    return jout, {k: v.numpy() for k, v in tout.items()}


@pytest.mark.parametrize(
    "names",
    [
        ("body_pos", "body_quat", "axis_w", "anchor_w"),   # fk
        ("J", "site_pos"),                                 # point_jacobian
        ("M", "gravity"),                                  # mass_matrix
        ("geom_v", "geom_w", "geom_pos", "geom_quat", "angvel"),   # geom_velocities
    ],
    ids=["fk", "point_jacobian", "mass_matrix", "geom_velocities"],
)
def test_kinematics_match_jax(bundle, names):
    jout, tout = bundle
    for name in names:
        err = np.max(np.abs(jout[name] - tout[name]))
        assert err < 1e-5, (name, err)


def test_joint_dyn_matrices_match_jax(bundle):
    """G1 = A⁻¹M and G2 = dt·A⁻¹ within 1e-4 of their largest entry."""
    jout, tout = bundle
    for name in ("G1", "G2"):
        err = np.max(np.abs(jout[name] - tout[name])) / np.max(np.abs(jout[name]))
        assert err < 1e-4, (name, err)


def test_integrators_agree(envs, joints):
    """``integrate`` with the mass matrix given equals
    ``integrate_precomputed`` with G1, G2 from the same pose (1e-4), and
    ``actuator_torques`` matches the JAX package (1e-5)."""
    jenv, tenv = envs
    r = tenv.robot
    q, qv = (torch.as_tensor(x) for x in joints)
    ctrl = torch.as_tensor(np.random.default_rng(1).uniform(-1.5, 1.5, (B, r.na)).astype(np.float32))
    tau, d_imp, k_imp = K.actuator_torques(r, q, qv, ctrl)
    jt, jd, jk = JK.actuator_torques(jenv.robot, jnp.asarray(q[0].numpy()),
                                     jnp.asarray(qv[0].numpy()), jnp.asarray(ctrl[0].numpy()))
    assert np.max(np.abs(np.asarray(jt) - tau[0].numpy()) / (1 + np.abs(np.asarray(jt)))) < 1e-5
    np.testing.assert_allclose(np.asarray(jd), d_imp.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jk), k_imp.numpy(), rtol=1e-6)
    G1, G2 = K.joint_dyn_matrices(r, q, DT)
    zeros = torch.zeros_like(qv)
    a_q, a_v = K.integrate_precomputed(r, G1, G2, q, qv, tau, zeros, DT)
    M = K.mass_matrix(r, K.fk(r, q))
    b_q, b_v = K.integrate(r, M, q, qv, tau, d_imp, k_imp, DT)
    assert (a_q - b_q).abs().max() < 1e-4 and (a_v - b_v).abs().max() < 1e-3


@pytest.fixture(scope="module")
def ik_targets(envs, joints):
    """Reachable targets: the hand pose of a perturbed joint vector."""
    _, tenv = envs
    r = tenv.robot
    q = np.tile(np.asarray(r.init_qpos, np.float32), (B, 1))
    rng = np.random.default_rng(2)
    q_goal = q.copy()
    q_goal[:, :7] += rng.uniform(-0.15, 0.15, (B, 7)).astype(np.float32)
    fk_out = K.fk(r, torch.as_tensor(q_goal))
    pos, quat = K.eef_pose(r, fk_out, "right")
    return q, pos.numpy(), quat.numpy()


@pytest.mark.parametrize("iters,tol", [(2, 1e-4), (20, 5e-3)])
def test_dls_ik_matches_jax(envs, ik_targets, iters, tol):
    """Two iterations hold the algorithm to 1e-4. At 20 the solve has
    converged, and there the reference's orientation error
    ``2·arccos(w)`` near w = 1 turns one f32 ulp of w into ~5e-4 rad, so
    the two packages' joint commands differ by that noise (5e-3 bound);
    both must reach the target pose."""
    jenv, tenv = envs
    q, tpos, tquat = ik_targets
    jq = jax.jit(jax.vmap(lambda a, b, c: j_dls_ik(jenv.robot, "right", a, b, c, iters=iters)))(
        jnp.asarray(q), jnp.asarray(tpos), jnp.asarray(tquat)
    )
    tq = dls_ik(tenv.robot, "right", torch.as_tensor(q), torch.as_tensor(tpos),
                torch.as_tensor(tquat), iters=iters)
    err = np.max(np.abs(np.asarray(jq) - tq.numpy()))
    assert err < tol, err
    if iters == 20:
        for qq in (tq, torch.as_tensor(np.array(jq))):
            pos, _ = K.eef_pose(tenv.robot, K.fk(tenv.robot, qq), "right")
            assert np.max(np.abs(pos.numpy() - tpos)) < 1e-3


@pytest.fixture(scope="module")
def port_reset(envs):
    """A port reset (B envs) as the numpy dict both packages start from."""
    _, tenv = envs
    return arm_state_to_numpy(tenv.reset_batch(B, torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("control_type", ["ik", "ik_quaternion"])
def test_ik_prepare_matches_jax(envs, port_reset, control_type):
    """IK-target update and the DLS solve: target pose 1e-5, q_cmd 2e-3."""
    jenv, tenv = envs
    if control_type == "ik_quaternion":
        jenv = JArmEnv(jenv.config.replace(control_type=control_type))
        tenv = ArmEnv(tenv.config.replace(control_type=control_type), device="cpu")
    rng = np.random.default_rng(3)
    act = rng.uniform(-1, 1, (B, tenv.dof)).astype(np.float32)
    js, jq, jg = jax.jit(jax.vmap(jenv._ik_prepare))(jax_arm_state(port_reset), jnp.asarray(act))
    ts, tq, tg = tenv._ik_prepare(arm_state_from_numpy(port_reset, "cpu"), torch.as_tensor(act))
    assert np.max(np.abs(np.asarray(js.ik_target_pos) - ts.ik_target_pos.numpy())) < 1e-5
    assert np.max(np.abs(np.asarray(js.hand_quat_init) - ts.hand_quat_init.numpy())) < 1e-5
    # q_cmd is a converged 20-iteration solve: the arccos noise floor of
    # test_dls_ik_matches_jax applies (measured 4.4e-4)
    err_q = np.max(np.abs(np.asarray(jq) - tq.numpy()))
    assert err_q < 2e-3, err_q
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    # the per-repeat actuator controls, both from the JAX command
    jc = jax.vmap(jenv._ik_ctrl)(js.qpos, jq, jg)
    tc = tenv._ik_ctrl(ts.qpos, torch.as_tensor(np.array(jq)), tg)
    assert np.max(np.abs(np.asarray(jc) - tc.numpy())) < 1e-5


def test_robot_contacts_match_jax(envs, port_reset, joints):
    """The robot narrow phase on the gripped state (part 0 teleported
    between the fingers), moving joints: mask exact, floats 1e-6."""
    jenv, tenv = envs
    jr, tr = jenv.robot, tenv.robot
    qpos = port_reset["qpos"]
    qvel = joints[1]
    fk_out = K.fk(tr, torch.as_tensor(qpos))
    gp, _ = K.site_world(tr, fk_out, "right")
    pos = port_reset["pos"].copy()
    pos[:, 0] = gp.numpy()
    quat = port_reset["quat"]
    slop = tenv.config.sim.contact_slop

    def one(p, q, qp, qv):
        f = JK.fk(jr, qp)
        rg_pos, rg_quat = JK.geom_world(jr, f)
        rg_vel, rg_ang = JK.geom_velocities(jr, f, qv)
        return j_robot_contacts(jenv.tables, jenv.tables["robot_np"], p, q,
                                rg_pos, rg_quat, rg_vel, rg_ang, slop)

    jc = jax.jit(jax.vmap(one))(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(qpos), jnp.asarray(qvel))
    rg_pos, rg_quat = K.geom_world(tr, fk_out)
    rg_vel, rg_ang = K.geom_velocities(tr, fk_out, torch.as_tensor(qvel))
    ph = tenv.physics
    tc = robot_contacts(ph._plain.tables, ph._rt, torch.as_tensor(pos), torch.as_tensor(quat),
                        rg_pos, rg_quat, rg_vel, rg_ang, slop)
    np.testing.assert_array_equal(np.asarray(jc.mask), tc.mask.numpy())
    assert tc.mask.any(), "expected gripper-part contact"
    np.testing.assert_array_equal(np.asarray(jc.part_a)[0], tc.part_a.numpy())
    np.testing.assert_array_equal(np.asarray(jc.friction)[0], tc.friction.numpy())
    np.testing.assert_array_equal(np.asarray(jc.beta)[0], tc.beta.numpy())
    for name in ("point", "normal", "depth", "vel_b"):
        err = np.max(np.abs(np.asarray(getattr(jc, name)) - getattr(tc, name).numpy()))
        assert err < 1e-6, (name, err)
