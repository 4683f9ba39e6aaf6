"""PyTorch port: the scripted demo generator against the JAX package.

Both packages build the generator env on table_lack at
``SimConfig(control_freq=100)``, ik control, on the CPU. States are made by
the port and cross as numpy (``furniture_tpu_torch.convert``).

* the planner primitives on seeded random inputs (the JAX ones vmapped),
  with the parallel and antiparallel cases of the shortest arc: 1e-5;
* ``scripted_action`` for one batch staged so that all twelve phases occur,
  with a drop recovery, two phase timeouts (one of a low phase, which
  re-grasps through a lift waypoint), a ``PART_DONE`` moving on to the next
  part, the connected-evidence redirect and a finished waypoint list,
  against JAX ``vmap(env.scripted_action)``: action 1e-4, every
  ``GenPolicyState`` field exact (integers) or 1e-5 (floats);
* ``init_policy_state``: the noises lie in [0, 2·furn_xyz_rand) (the port
  draws from a ``torch.Generator``, the JAX package from ``jax.random``: the
  streams differ, so only the bounds are held);
* ``generate_demos`` on the CPU at ``batch=2, max_steps=3``: the stats have
  the keys of the JAX function's stats dict (read from its source) and the
  same types; the per-step records come back from the device in segments.

``vmap(scripted_action)`` is the one JAX function compiled for the file.
"""

import ast
import inspect
import math
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import furniture_tpu.envs.sawyer_gen as jgen_mod
from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.sawyer_dense import DenseState as JDenseState, Prev as JPrev
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import (
    dense_state_to_numpy,
    gen_policy_state_from_numpy,
    gen_policy_state_to_numpy,
)
from furniture_tpu_torch.envs import sawyer_gen as G
from furniture_tpu_torch.robots import kinematics as K

torch.set_num_threads(1)

N = 256
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")


def jax_dense(d: dict) -> JDenseState:
    parts = JPartState(*(jnp.asarray(d[f]) for f in PART_FIELDS))
    prev = JPrev(*(jnp.asarray(d[f"prev_{f}"]) for f in JPrev._fields))
    rest = {f: jnp.asarray(d[f]) for f in JDenseState._fields if f not in ("parts", "prev")}
    return JDenseState(parts=parts, prev=prev, **rest)


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def envs():
    jenv = jgen_mod.FurnitureSawyerGenEnv(
        JEnvConfig(agent_type="Sawyer", control_type="ik", sim=JSimConfig(control_freq=100)))
    tenv = G.FurnitureSawyerGenEnv(
        EnvConfig(agent_type="Sawyer", control_type="ik", sim=SimConfig(control_freq=100)),
        device="cpu")
    return jenv, tenv


def close(mine, ref, atol=1e-5, msg=""):
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=atol, rtol=0, err_msg=msg)


def test_primitives_match_jax():
    rng = np.random.default_rng(0)
    t = torch.as_tensor
    cur = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    tgt = (cur + rng.normal(0.0, 0.03, (N, 3))).astype(np.float32)
    noise = rng.uniform(0.0, 0.02, (N, 3)).astype(np.float32)
    for eps in (0.005, 0.01, 0.03):
        d, r = G._move_xy(t(cur[:, :2]), t(tgt[:, :2]), eps)
        jd, jr = jax.vmap(lambda c, g: jgen_mod._move_xy(c, g, eps))(cur[:, :2], tgt[:, :2])
        close(d, jd, msg="move_xy")
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        d, r = G._move_xy(t(cur[:, :2]), t(tgt[:, :2]), eps, t(noise))
        jd, jr = jax.vmap(lambda c, g, n: jgen_mod._move_xy(c, g, eps, n))(cur[:, :2], tgt[:, :2], noise)
        close(d, jd, msg="move_xy noise")
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        d, r = G._move_xyz(t(cur), t(tgt), eps, t(noise))
        jd, jr = jax.vmap(lambda c, g, n: jgen_mod._move_xyz(c, g, eps, n))(cur, tgt, noise)
        close(d, jd, msg="move_xyz")
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        for fine in (None, 3.0):
            d = G._move_z(t(cur), t(tgt), eps, 0.05, fine=fine)
            jd = jax.vmap(lambda c, g: jgen_mod._move_z(c, g, eps, 0.05, fine=fine))(cur, tgt)
            close(d, jd, msg=f"move_z fine={fine}")
    # _move_z with a conn distance per env, as the batched policy calls it
    cd = rng.uniform(0.0, 0.1, N).astype(np.float32)
    d = G._move_z(t(cur), t(tgt), 0.01, t(cd))
    close(d, jax.vmap(lambda c, g, z: jgen_mod._move_z(c, g, 0.01, z))(cur, tgt, cd))
    a = rng.uniform(-20.0, 20.0, N).astype(np.float32)
    close(G._wrap_pi(t(a)), jgen_mod._wrap_pi(jnp.asarray(a)))

    v = unit(rng.normal(size=(N, 3)))
    w = unit(rng.normal(size=(N, 3)))
    w[:4] = v[:4]                    # parallel: zero rotation
    w[4:8] = -v[4:8]                 # antiparallel: a pi rotation about a perpendicular
    v[8], w[8] = [0, 0, 1], [0, 0, -1]
    v[9], w[9] = [1, 0, 0], [-1, 0, 0]
    arc = G._shortest_arc(t(v), t(w))
    close(arc, jax.vmap(jgen_mod._shortest_arc)(v, w), msg="shortest_arc")
    np.testing.assert_allclose(np.linalg.norm(arc[4:10].numpy(), axis=-1), np.pi, atol=1e-5)

    q = unit(rng.normal(size=(N, 4)))
    q[:3] = [[1, 0, 0, 0], [0, 1, 0, 0], [0.7071068, 0, 0, 0.7071068]]
    for eps in (0.0, 0.05):
        close(G._up_correction(t(q), eps),
              jax.vmap(lambda r: jgen_mod._up_correction(r, eps))(q), msg="up_correction")
        close(G._grip_up_correction(t(q), eps),
              jax.vmap(lambda r: jgen_mod._grip_up_correction(r, eps))(q), msg="grip_up")
        g2 = rng.normal(size=(N, 2)).astype(np.float32)
        close(G._grip_fwd_correction(t(q), t(g2), eps),
              jax.vmap(lambda r, g: jgen_mod._grip_fwd_correction(r, g, eps))(q, g2), msg="grip_fwd")
    # the forward correction on the model's own connector angle sets
    # (with and without an angle list)
    ang = rng.choice([0.0, 90.0, 180.0, 270.0], (N, 4)).astype(np.float32)
    mask = rng.random((N, 4)) < 0.6
    mask[:, 0] = True
    has = rng.random(N) < 0.8
    for eps in (0.02, 0.05):
        close(G._fwd_correction(t(q), t(ang), t(mask), t(has), eps),
              jax.vmap(lambda r, an, m, h: jgen_mod._fwd_correction(r, an, m, h, eps))(q, ang, mask, has),
              msg="fwd_correction")


def take(state, idx):
    """Rows ``idx`` of every field of a (nested) batched state."""
    if isinstance(state, tuple):
        return type(state)(*(take(x, idx) for x in state))
    return state[idx]


def cat(a, b):
    if isinstance(a, tuple):
        return type(a)(*(cat(x, y) for x, y in zip(a, b)))
    return torch.cat([a, b])


# staged cases: (phase, base state: 0/1 reset envs, 2/3 gripped, subtask
# step of the env, policy fields)
CASES = [
    ("init_grip", G.INIT_GRIP, 0, 0, {"safepos_len": 1}),
    ("xy_move_g", G.XY_MOVE_G, 0, 0, {}),
    ("align_g", G.ALIGN_G, 1, 0, {}),
    ("z_move_g", G.Z_MOVE_G, 2, 0, {"z_move_g_prev": math.inf}),
    ("move_waypoints", G.MOVE_WAYPOINTS, 2, 0, {"safepos_len": 1}),
    ("align_conn", G.ALIGN_CONN, 2, 0, {}),
    ("xy_move_conn", G.XY_MOVE_CONN, 3, 0, {}),
    ("z_move_conn", G.Z_MOVE_CONN, 2, 0, {}),
    ("align_conn_fine", G.ALIGN_CONN_FINE, 2, 0, {}),
    ("z_move_conn_fine", G.Z_MOVE_CONN_FINE, 3, 0, {}),
    ("move_nogrip", G.MOVE_NOGRIP_SAFEPOS, 0, 0, {"safepos_len": 1}),
    ("part_done", G.PART_DONE, 0, 0, {}),
    ("drop_recovery", G.ALIGN_CONN, 0, 0, {"drop_count": 7}),
    ("init_grip_timeout", G.INIT_GRIP, 1, 0, {"safepos_len": 2, "phase_steps": 99, "far": True}),
    ("low_phase_timeout", G.Z_MOVE_CONN, 3, 0, {"phase_steps": 199}),
    ("part_done_next_part", G.PART_DONE, 0, 1, {}),
    ("connected_redirect", G.XY_MOVE_CONN, 2, 1, {}),
    ("waypoints_done", G.MOVE_WAYPOINTS, 2, 0, {"safepos_len": 1, "safepos_idx": 1}),
]


@pytest.fixture(scope="module")
def staged(envs):
    """The env states and policy states of ``CASES`` (one env each)."""
    jenv, tenv = envs
    reset = tenv.reset_batch(2, torch.Generator().manual_seed(0))
    gp, _ = K.site_world(tenv.robot, K.fk(tenv.robot, reset.qpos), "right")
    leg = int(tenv._st["leg"][0])
    pos = reset.parts.pos.clone()
    pos[:, leg] = gp + torch.tensor([0.002, -0.001, 0.0])
    act = torch.zeros((2, tenv.dof))
    act[:, -2] = 1.0
    gripped = tenv.step_batch(reset._replace(parts=reset.parts._replace(pos=pos)), act)[0]
    base = take(cat(reset, gripped), torch.tensor([c[2] for c in CASES]))
    state = base._replace(subtask_step=torch.tensor([c[3] for c in CASES], dtype=torch.int32))

    n = len(CASES)
    rng = np.random.default_rng(3)
    gripbase = tenv._gripbase_pos(K.fk(tenv.robot, state.qpos)).numpy()
    g = {
        "phase": np.array([c[1] for c in CASES], np.int32),
        "part": np.zeros(n, np.int32),
        "safepos": (gripbase[:, None] + rng.uniform(-0.05, 0.05, (n, G.MAXW, 3))).astype(np.float32),
        "safepos_len": np.zeros(n, np.int32),
        "safepos_idx": np.zeros(n, np.int32),
        "z_move_g_prev": rng.uniform(0.0, 0.4, n).astype(np.float32),
        "noise_wp": rng.uniform(0.0, 0.04, (n, 3)).astype(np.float32),
        "noise_ng": rng.uniform(0.0, 0.04, (n, 3)).astype(np.float32),
        "drop_count": np.zeros(n, np.int32),
        "phase_steps": rng.integers(0, 20, n).astype(np.int32),
    }
    for i, (_, _, _, _, fields) in enumerate(CASES):
        for k, v in fields.items():
            if k == "far":
                g["safepos"][i] += np.float32([0.3, 0.0, 0.0])
            else:
                g[k][i] = v
    return state, g


def test_scripted_action_every_phase_matches_jax(envs, staged):
    jenv, tenv = envs
    state, g = staged
    action, out = tenv.scripted_action(gen_policy_state_from_numpy(g, "cpu"), state)
    jgen = jgen_mod.GenPolicyState(**{k: jnp.asarray(v) for k, v in g.items()})
    jaction, jout = jax.jit(jax.vmap(jenv.scripted_action))(jgen, jax_dense(dense_state_to_numpy(state)))
    close(action, jaction, atol=1e-4, msg="action")
    mine = gen_policy_state_to_numpy(out)
    for f in jgen_mod.GenPolicyState._fields:
        ref = np.asarray(getattr(jout, f))
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(mine[f], ref, atol=1e-5, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(mine[f], ref, err_msg=f)
    # the staged cases took the branches they stage
    case = {c[0]: i for i, c in enumerate(CASES)}
    ph = mine["phase"]
    assert ph[case["drop_recovery"]] == G.INIT_GRIP and mine["safepos_len"][case["drop_recovery"]] == 1
    assert ph[case["init_grip_timeout"]] == G.XY_MOVE_G
    assert ph[case["low_phase_timeout"]] == G.INIT_GRIP
    assert mine["part"][case["part_done_next_part"]] == 1
    assert ph[case["part_done_next_part"]] == G.INIT_GRIP
    assert ph[case["connected_redirect"]] == G.MOVE_NOGRIP_SAFEPOS
    assert ph[case["waypoints_done"]] == G.ALIGN_CONN
    assert ph[case["part_done"]] == G.PART_DONE
    assert np.all(np.abs(action.numpy()) <= 1.0)


def test_init_policy_state_noise_bounds(envs, staged):
    jenv, tenv = envs
    state, _ = staged
    gen = tenv.init_policy_state(state, torch.Generator().manual_seed(1))
    r = tenv.config.furn_xyz_rand
    for noise in (gen.noise_wp, gen.noise_ng):
        assert noise.shape == (len(CASES), 3)
        assert (noise >= 0).all() and (noise < 2 * r).all()
    assert not torch.equal(gen.noise_wp, gen.noise_ng)
    # part 0 of table_lack has no grip-init waypoint
    assert (gen.phase == G.XY_MOVE_G).all() and (gen.safepos_idx == 0).all()
    assert torch.isinf(gen.z_move_g_prev).all()
    back = gen_policy_state_from_numpy(gen_policy_state_to_numpy(gen), "cpu")
    for a, b in zip(gen, back):
        assert a.dtype == b.dtype and torch.equal(a, b)


def jax_stats_keys() -> list:
    """The keys of the stats dict that JAX ``generate_demos`` returns, read
    from its source (running it compiles a 400-step rollout)."""
    src = inspect.getsource(jgen_mod.FurnitureSawyerGenEnv.generate_demos)
    tree = ast.parse(textwrap.dedent(src))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "stats":
            return [k.value for k in node.value.keys]
    raise AssertionError("no stats dict in the JAX generate_demos")


def test_generate_demos_cpu(envs):
    jenv, tenv = envs
    demos, stats = tenv.generate_demos(1, seed=0, batch=2, max_steps=3)
    assert list(stats) == jax_stats_keys()
    types = {"batch": int, "max_steps": int, "seed": int, "success_rate": float,
             "connect_histogram": list, "mean_num_connected": float, "first_success_steps": list}
    for k, v in stats.items():
        assert type(v) is types[k], (k, type(v))
    assert stats["batch"] == 2 and stats["max_steps"] == 3
    assert len(stats["connect_histogram"]) == tenv.n_subtasks + 1
    assert sum(stats["connect_histogram"]) == 2
    assert all(type(c) is int for c in stats["connect_histogram"])
    assert demos == [] and stats["success_rate"] == 0.0


def test_records_come_to_the_host_in_one_copy():
    """``_to_host`` packs a segment of mixed-dtype records into one buffer
    and gives the same arrays back."""
    g = torch.Generator().manual_seed(0)
    recs = [{"a": torch.rand((3, 2), generator=g), "b": torch.rand(3, generator=g) > 0.5,
             "c": torch.randint(0, 9, (3, 4), generator=g, dtype=torch.int32)} for _ in range(5)]
    out = G._to_host(recs)
    for k in recs[0]:
        ref = torch.stack([r[k] for r in recs]).numpy()
        assert out[k].dtype == ref.dtype and out[k].shape == ref.shape
        np.testing.assert_array_equal(out[k], ref)
