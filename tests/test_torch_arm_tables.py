"""PyTorch port: the robot chain compiler, the robot contact tables and the
arm kernel's lane tables against the JAX package, and the state converters.

Everything here is numpy against numpy (``np.array_equal``): both packages
must build identical tables, since the plain version and the CUDA kernel
read them. No JAX function is compiled.
"""

import dataclasses

import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig
from furniture_tpu.models import compile_from_config as j_compile_from_config
from furniture_tpu.physics.arm_megakernel import ArmMegaPhysics as JArmMegaPhysics
from furniture_tpu.physics.engine import physics_tables as j_physics_tables
from furniture_tpu.physics.engine import robot_contact_tables as j_robot_contact_tables
from furniture_tpu.robots import compile_robot as j_compile_robot
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import arm_state_from_numpy, arm_state_to_numpy
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.models import compile_from_config
from furniture_tpu_torch.physics.arm_megakernel import ArmMegaPhysics
from furniture_tpu_torch.physics.engine import physics_tables, robot_contact_tables
from furniture_tpu_torch.robots import compile_robot
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

AGENTS = ("Sawyer", "Panda", "Jaco", "Fetch", "Baxter")


def _same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, tuple) and a and not isinstance(a[0], str):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("agent", AGENTS)
@pytest.mark.parametrize("use_torque", [False, True])
def test_compile_robot_matches_jax(agent, use_torque):
    """Every field of ``CompiledRobot``, both actuator variants: exact."""
    jr = j_compile_robot(agent, use_torque=use_torque)
    tr = compile_robot(agent, use_torque=use_torque)
    for f in dataclasses.fields(jr):
        _same(getattr(jr, f.name), getattr(tr, f.name), f"{agent}.{f.name}")


def test_chain_compile_all_agents():
    """Mirror of the JAX suite's chain test on the port: sizes, a positive
    definite mass matrix at the init pose, finger geoms on every arm."""
    for agent in AGENTS:
        for tq in (False, True):
            r = compile_robot(agent, use_torque=tq)
            assert r.nb > 5 and r.nj >= 8
            q = torch.as_tensor(r.init_qpos, dtype=torch.float32)[None]
            M = K.mass_matrix(r, K.fk(r, q))[0].numpy()
            assert np.linalg.eigvalsh(M).min() > 0, f"{agent}: M not SPD"
            for arm in r.arms:
                assert len(r.finger_geoms_l[arm]) > 0
                assert len(r.finger_geoms_r[arm]) > 0


def test_fk_jacobian_consistency():
    """The analytic point Jacobian matches autograd through the port's fk
    (1e-4, the JAX suite's bound)."""
    r = compile_robot("Sawyer")
    q0 = torch.as_tensor(r.init_qpos, dtype=torch.float32)
    body = r.eef_body["right"]
    fk_out = K.fk(r, q0[None])
    J = K.point_jacobian(r, fk_out, body, fk_out["body_pos"][:, body])[0]
    J_ad = torch.autograd.functional.jacobian(
        lambda q: K.fk(r, q[None])["body_pos"][0, body], q0
    )
    np.testing.assert_allclose(J[:3].numpy(), J_ad.numpy(), atol=1e-4)


def _both_tables(agent):
    jcfg = JEnvConfig(agent_type=agent, control_type="impedance")
    jr = j_compile_robot(agent)
    jt = j_physics_tables(j_compile_from_config(jcfg))
    jt.update(j_robot_contact_tables(jt, jr, lane_budget=jcfg.sim.arm_lane_budget))
    cfg = EnvConfig(agent_type=agent, control_type="impedance")
    tr = compile_robot(agent)
    tt = physics_tables(compile_from_config(cfg))
    tt.update(robot_contact_tables(tt, tr, lane_budget=cfg.sim.arm_lane_budget))
    return (jr, jt, jcfg), (tr, tt, cfg)


@pytest.mark.parametrize("agent,K_want", [("Sawyer", 1260), ("Baxter", 1610)])
def test_robot_contact_and_lane_tables_match_jax(agent, K_want):
    """``robot_contact_tables`` (tiers under ``arm_lane_budget`` = 1700) and
    the arm kernel's lane tables against the JAX ``ArmMegaPhysics``: exact,
    including the lane count. The JAX one-hot matrices are compared with
    the port's index tables."""
    (jr, jt, jcfg), (tr, tt, cfg) = _both_tables(agent)
    for k in ("_robot_pairs", "_rl_pair", "_rl_rgeom", "_rl_pgeom", "_rl_sign", "_lane_rgeom"):
        assert np.array_equal(jt[k], tt[k]), k
    for k in jt["robot_np"]:
        assert np.array_equal(jt["robot_np"][k], tt["robot_np"][k]), k

    jm = JArmMegaPhysics(jt, jr, jcfg.sim, interpret=True)
    tm = ArmMegaPhysics(tt, tr, cfg.sim, "cpu")
    assert np.array_equal(jt["_robot_beta"], tt["_robot_beta"])
    assert (tm.K, tm.Kf, tm.Kp, tm.Ke, tm.Kr, tm.NRG) == (jm.K, jm.Kf, jm.Kp, jm.Ke, jm.Kr, jm.NRG)
    assert tm.K == K_want
    assert tm.hand_list == jm.hand_list
    P = tm.P
    # lane -> part maps against the one-hot matrices
    assert np.array_equal(tm.part_a, jm.OA.argmax(1))
    assert np.array_equal(tm.part_b >= 0, jm.OB.sum(1) > 0)
    has_b = tm.part_b >= 0
    assert np.array_equal(tm.part_b[has_b], jm.OB.argmax(1)[has_b])
    assert np.array_equal(tm.lane_fric, jm.lane_fric)
    assert np.array_equal(tm.lane_beta, jm.lane_beta)
    for name in ("r1_corner", "r1_rsize", "r2_off", "r2_dst_pos", "r2_dst_quat",
                 "r2_dst_size", "lane_slot"):
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
    # joint ancestry, squeeze masks and the touch map from the index tables
    assert np.array_equal(tm.rg_anc[tm.lane_slot], jm.ANC)
    arm_of = np.where(tm.lane_finger >= 0, tm.lane_finger // 2, -1)
    sqz = np.stack([arm_of == a for a in range(tm.n_arms)]).astype(np.float32)
    assert np.array_equal(sqz, jm.SQZ)
    assert np.array_equal(tm._touchmap.numpy(), jm.TOUCHMAP)
    assert tm.NT == jm.NT == 2 * tm.n_arms * P
    # the packed lane constants the kernel reads
    Kb, L = tm.Kb, tm.L
    assert np.array_equal(tm.lane_const[Kb : Kb + L, 0:3], jm.r1_corner)
    assert np.array_equal(tm.lane_const[Kb + L :, 6:10], jm.r2_dst_quat)
    assert np.array_equal(tm.lane_const[:, 20], jm.lane_fric)
    # every lane sits once in its part's list, and once in its hand geom's
    lanes = np.sort(tm.part_ent[(tm.part_ent & 1) == 0] >> 1)
    assert np.array_equal(lanes, np.arange(tm.K))
    assert np.array_equal(np.sort(tm.rg_ent), np.arange(Kb, tm.K))
    for g in range(tm.NRG):
        seg = tm.rg_ent[tm.rg_off[g] : tm.rg_off[g + 1]] - Kb
        assert np.all(tm.lane_slot[seg] == g)
    # the chain tables: parent before child, one row per joint and actuator
    assert np.all(tm.body_i[:, 0] < np.arange(tm.NB))
    assert np.array_equal(tm.jnt_i[:, 0], jr.jnt_body)
    assert np.array_equal(tm.act_i[:, 0], jr.act_joint)


@pytest.fixture(scope="module")
def sawyer_env():
    return ArmEnv(
        EnvConfig(agent_type="Sawyer", control_type="impedance", sim=SimConfig(control_freq=100)),
        device="cpu",
    )


def test_arm_state_round_trip(sawyer_env):
    """ArmState → numpy → ArmState keeps every value and dtype."""
    env = sawyer_env
    s = env.reset_batch(2, torch.Generator().manual_seed(0))
    s, *_ = env.step_batch(s, torch.zeros(2, env.dof))
    d = arm_state_to_numpy(s)
    assert d["group"].dtype == np.int32 and d["touch_l"].dtype == np.bool_
    assert d["qpos"].dtype == np.float32 and d["t"].dtype == np.int32
    s2 = arm_state_from_numpy(d, "cpu")
    for f in s._fields:
        a, b = getattr(s, f), getattr(s2, f)
        if f == "parts":
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f


def test_kernel_route_refuses_cpu_tensors(sawyer_env):
    """The kernel route takes CUDA tensors only: a CPU tensor raises before
    anything is built or launched, and the launch count stays 0."""
    env = sawyer_env
    s = env.reset_batch(2, torch.Generator().manual_seed(0))
    ph = env.physics
    G1, G2 = K.joint_dyn_matrices(env.robot, s.qpos, env.config.sim.timestep)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ph.kernel_control_step(
            s.parts, s.group, torch.ones(2, env._P), s.qpos, s.qvel,
            torch.zeros(2, env.robot.na), torch.zeros(2, env.robot.nj), G1, G2, 1,
        )
    assert ph.launches == 0


def test_registry_has_arm_ids():
    """The ids of the JAX registry for the five agents; the torque-space
    controllers and the initial-state pool raise by name."""
    from furniture_tpu_torch.api import REGISTERED_ENVS

    for agent in AGENTS:
        assert f"IKEA{agent}-v0" in REGISTERED_ENVS
        assert f"Furniture{agent}Env" in REGISTERED_ENVS
    with pytest.raises(NotImplementedError, match="joint_torque"):
        ArmEnv(EnvConfig(agent_type="Sawyer", control_type="joint_torque"), device="cpu")
    with pytest.raises(NotImplementedError, match="initial-state pool"):
        ArmEnv(EnvConfig(agent_type="Sawyer", load_init_states="x.pkl"), device="cpu")
