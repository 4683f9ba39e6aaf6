"""PyTorch port: the lane contact solver against the JAX package's.

* the solver alone: the set-up of ``tests/test_pallas_solver.py`` (parts
  near their init poses with seeded noise and velocities, floor and pair
  lanes, 24 sweeps) for three seeds stacked to B = 3, made with numpy and
  fed to both packages. JAX ``solve_contacts_pallas(interpret=True)``
  against the port's plain lane solve within 1e-4 on both velocities (same
  arithmetic, f32 sums in another order), and against the port's
  warm-started solver started cold within the JAX suite's own bounds for
  that pair (2e-3 linear, 5e-3 angular, rtol 1e-3: incremental against
  recomputed velocities);
* the lane path as a whole: ``CursorEnv`` with ``use_pallas="lane"`` at
  ``control_freq=100`` in both packages from one staged state (a leg pressed
  2 mm into the tabletop, another 1 mm above it), two steps. The JAX env
  runs on the CPU with its Pallas kernel interpreted: the test swaps
  ``pallas_solver.solve_contacts_pallas`` for a partial with
  ``interpret=True`` before the env is built. Discrete state exact, reward
  1e-5, part floats 1e-3. The port's lane step must differ from its default
  step on that state (cold against warm start).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import furniture_tpu.physics.pallas_solver as jax_pallas_solver
from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
from furniture_tpu.models import compile_model as jax_compile_model
from furniture_tpu.physics import collide as jax_collide
from furniture_tpu.physics import engine as jax_engine
from furniture_tpu.physics.state import init_state as jax_init_state
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import cursor_state_from_numpy, cursor_state_to_numpy
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.models import compile_model
from furniture_tpu_torch.physics import collide, engine, lane_solver
from furniture_tpu_torch.physics.megakernel import LanePhysics, MegaPhysics, make_batched_substeps
from furniture_tpu_torch.physics.state import PartState

torch.set_num_threads(1)

NAME = "table_lack_0825"
SEEDS = (0, 1, 2)
DT, ITERS, RELAX, SLOP = 0.002, 24, 0.55, 0.001
GROUPS = {
    "free": np.arange(5, dtype=np.int32),
    "welded": np.array([0, 0, 2, 2, 4], np.int32),
}


def _inputs(seed, vel_scale=0.1):
    m = compile_model(NAME)
    rng = np.random.default_rng(seed)
    pos = m.part_init_pos.astype(np.float32) + rng.normal(0, 0.01, (m.n_parts, 3)).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2]) * 0.3 + 0.02
    quat = np.tile(np.array([1.0, 0, 0, 0], np.float32), (m.n_parts, 1))
    lin = (rng.normal(0, 1, (m.n_parts, 3)) * vel_scale).astype(np.float32)
    return pos, quat, lin


@pytest.fixture(scope="module")
def jax_tables():
    tb = jax_engine.physics_tables(jax_compile_model(NAME))
    jax_collide.attach_betas(tb, JSimConfig())
    return tb


@pytest.fixture(scope="module")
def torch_tables():
    tb = engine.physics_tables(compile_model(NAME))
    collide.attach_betas(tb, SimConfig())
    return tb, collide.torch_tables(tb, "cpu"), engine._part_tables(tb, "cpu")


def _jax_lane(tb, pos, quat, lin, group):
    st = jax_init_state(jnp.asarray(pos), jnp.asarray(quat))._replace(lin_vel=jnp.asarray(lin))
    group = jnp.asarray(group)
    _, g_com, g_im, g_iI = jax_engine._group_aggregates(tb, st, group)
    c = jax_collide.concat_contacts(
        jax_collide.floor_contacts(tb, st.pos, st.quat, SLOP),
        jax_collide.pair_contacts(tb, st.pos, st.quat, group, SLOP),
    )
    lv, av = jax_pallas_solver.solve_contacts_pallas(
        c, group, g_com, g_im, g_iI, st.lin_vel, st.ang_vel, DT, ITERS, RELAX, 0.2, SLOP,
        interpret=True,
    )
    return np.asarray(lv), np.asarray(av)


def _torch_args(tables, group):
    _, tt, pt = tables
    ins = [_inputs(s) for s in SEEDS]
    pos, quat, lin = (torch.from_numpy(np.stack([i[k] for i in ins])) for k in range(3))
    st = PartState(pos, quat, lin, torch.zeros_like(lin))
    group = torch.from_numpy(np.tile(group, (len(SEEDS), 1)))
    _, g_com, g_im, g_iI = engine._group_aggregates(pt, st, group)
    c = collide.concat_contacts(
        collide.floor_contacts(tt, pos, quat, SLOP),
        collide.pair_contacts(tt, pos, quat, group, SLOP),
    )
    return (c, group, g_com, g_im, g_iI, st.lin_vel, st.ang_vel, DT, ITERS, RELAX, SLOP)


@pytest.fixture(scope="module")
def jax_solved(jax_tables):
    return {
        name: [_jax_lane(jax_tables, *_inputs(s), group) for s in SEEDS]
        for name, group in GROUPS.items()
    }


@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_plain_lane_solve_matches_jax_kernel(jax_solved, torch_tables, groups):
    args = _torch_args(torch_tables, GROUPS[groups])
    assert int(lane_solver.lane_prep(*args[:5], DT, RELAX, SLOP).fmask.sum()) > 0
    before = lane_solver.launches
    lv, av = lane_solver.solve_contacts_lane(*args)
    assert lane_solver.launches == before      # CPU tensors: the plain version
    for b, (jlv, jav) in enumerate(jax_solved[groups]):
        assert np.abs(jlv - lv[b].numpy()).max() < 1e-4, (b, "lin")
        assert np.abs(jav - av[b].numpy()).max() < 1e-4, (b, "ang")
    # the solve did something
    assert (lv - args[5]).abs().max() > 1e-3


@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_warm_solver_started_cold_agrees(jax_solved, torch_tables, groups):
    """``engine._solve_contacts`` from lambda = 0 recomputes the velocities
    from all of lambda each sweep; the lane solve adds increments."""
    args = _torch_args(torch_tables, GROUPS[groups])
    K = args[0].depth.shape[1]
    lv, av, _, _ = engine._solve_contacts(*args, torch.zeros((len(SEEDS), K, 3)))
    for b, (jlv, jav) in enumerate(jax_solved[groups]):
        np.testing.assert_allclose(lv[b].numpy(), jlv, atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(av[b].numpy(), jav, atol=5e-3, rtol=1e-3)


def test_kernel_wrapper_refuses_cpu_tensors(torch_tables):
    """The kernel path takes CUDA tensors only; it never falls back."""
    args = _torch_args(torch_tables, GROUPS["free"])
    tables = lane_solver.LaneTables.of(args[0], args[1].shape[1])
    before = lane_solver.launches
    with pytest.raises((ValueError, RuntimeError)):
        lane_solver.launch(tables, *args)
    assert lane_solver.launches == before


def test_kernel_inputs_built_once():
    """What the kernel takes: the raw contacts of a substep and the model's
    lane tables, built once when the lane backend is set up and handed to
    every solve, in the layout and dtypes the kernel reads."""
    env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, use_pallas="lane")), device="cpu")
    st = env.reset_batch(2, torch.Generator().manual_seed(0))
    ones = torch.ones((2, env._P))
    c = env.physics.solver_args(st.parts, st.group, ones)[0]
    t1 = env.physics.lane_tables
    env.physics.substeps(st.parts, st.group, ones, 2)
    assert env.physics.lane_tables is t1 is env.physics._substep.lane_tables
    K = c.depth.shape[1]
    assert (t1.K, t1.P, t1.route) == (K, env._P, lane_solver.ROUTE_REGS)
    assert t1.slot_i.dtype == torch.int32 and t1.slot_i.shape == (t1.KS, 4)
    assert t1.slot_f.dtype == torch.float32 and t1.slot_f.shape == (t1.KS, 2)
    for t in (t1.slot_i, t1.slot_f, t1.seg_off, t1.b_off):
        assert t.is_contiguous() and t.device == c.point.device
    # slot rows: lane, part a, part b, b entry | friction, beta
    lanes = t1.slot_i[:, 0].numpy()
    used = lanes >= 0
    np.testing.assert_array_equal(t1.slot_i[used, 1].numpy(), c.part_a.numpy()[lanes[used]])
    np.testing.assert_array_equal(t1.slot_i[used, 2].numpy(), c.part_b.numpy()[lanes[used]])
    np.testing.assert_array_equal(t1.slot_f[used, 0].numpy(), c.friction.numpy()[lanes[used]])
    np.testing.assert_array_equal(t1.slot_f[used, 1].numpy(), c.beta.numpy()[lanes[used]])
    # the per-env inputs the kernel reads as they are: no packed copy
    for t, dtype in ((c.point, torch.float32), (c.normal, torch.float32),
                     (c.depth, torch.float32), (c.mask, torch.bool)):
        assert t.dtype == dtype and t.is_contiguous()
    assert c.vel_b is None
    # on the CPU the tables are not needed: the plain version, either way
    args = env.physics.solver_args(st.parts, st.group, ones)
    before = lane_solver.launches
    lv, av = lane_solver.solve_contacts_lane(*args)
    lv_t, av_t = lane_solver.solve_contacts_lane(*args, tables=t1)
    assert torch.equal(lv, lv_t) and torch.equal(av, av_t) and lane_solver.launches == before


def test_work_model_counts():
    """The bound's inputs for table_lack inside a substep (K = 210 lanes,
    170 with a side b, P = 5, 12 sweeps), every lane in contact, and for a
    state with fewer lanes in contact."""
    ops = lane_solver.fp32_ops_per_env(210, 170, 5, 12)
    prep = 210 + 210 * (lane_solver.PREP_LANE + lane_solver.SCALE_LANE) + 170 * lane_solver.PREP_LANE_B
    sweeps = 12 * (210 * lane_solver.SWEEP_LANE + 170 * lane_solver.SWEEP_LANE_B
                   + 5 * lane_solver.SWEEP_PART)
    assert ops == prep + sweeps == 331130
    assert 40_000 < prep < 50_000 and 3.2e5 < ops < 3.5e5
    assert lane_solver.bytes_per_env(210, 5) == 210 * 29 + 5 * 104 == 6610
    assert lane_solver.bytes_per_env(210, 5, vel_b=True) == 6610 + 210 * 12
    # bytes counted as the operations are: every lane's mask, the depth of a
    # lane whose mask is set, point and normal (and vel_b) of one in contact
    assert lane_solver.bytes_per_env(210, 5, masked=22, active=20) == 210 + 22 * 4 + 20 * 24 + 520
    assert lane_solver.bytes_per_env(210, 5, 0, 0, vel_b=True) == 210 + 520
    # the work follows the lanes in contact; the contact test covers all
    few = lane_solver.fp32_ops_per_env(210, 170, 5, 12, active=20, active_b=0)
    assert few == 210 + 20 * (lane_solver.PREP_LANE + lane_solver.SCALE_LANE) + 12 * (
        20 * lane_solver.SWEEP_LANE + 5 * lane_solver.SWEEP_PART)
    assert lane_solver.fp32_ops_per_env(210, 170, 5, 12, vel_b=True) == ops + 210 * lane_solver.PREP_VEL_B


def test_backend_dispatch():
    tb = engine.physics_tables(compile_model(NAME))
    assert isinstance(make_batched_substeps(tb, SimConfig(use_pallas="lane"), "cpu"), LanePhysics)
    for mode in ("auto", "on", "off"):
        assert isinstance(make_batched_substeps(tb, SimConfig(use_pallas=mode), "cpu"), MegaPhysics)
    # the free-part kernel's plain version stays warm-started in lane mode
    assert MegaPhysics(tb, SimConfig(use_pallas="lane"), "cpu")._plain.supports_warm
    assert not LanePhysics(tb, SimConfig(use_pallas="lane"), "cpu")._substep.supports_warm


# -- the lane path as a whole ----------------------------------------------------

B = 2
PART_FIELDS = ("pos", "quat", "lin_vel", "ang_vel")
EXACT = (
    "group", "selected", "num_connected", "connect_step", "conn_connected",
    "weld_active", "t", "subtask", "connected_body1",
)


def _to_np(state) -> dict:
    d = {f: np.array(getattr(state.parts, f)) for f in PART_FIELDS}
    for f in state._fields:
        if f != "parts":
            d[f] = np.array(getattr(state, f))
    return d


def _from_np(d: dict, like):
    parts = like.parts._replace(
        **{f: jnp.asarray(d[f], like.parts.pos.dtype) for f in PART_FIELDS}
    )
    rest = {
        f: jnp.asarray(d[f], getattr(like, f).dtype) for f in like._fields if f != "parts"
    }
    return like._replace(parts=parts, **rest)


@pytest.fixture(scope="module")
def staged():
    """A settled reset of the port (default backend) with leg 0 pressed 2 mm
    into the tabletop and leg 1 laid 1 mm above it; the numpy dict and the
    actions (cursor 0 moves, nothing selected)."""
    env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
    d = cursor_state_to_numpy(env.reset_batch(B, torch.Generator().manual_seed(0)))
    pos = d["pos"]
    pos[:, 0] = pos[:, 4] + np.array([0.05, 0.0, 0.02 + 0.015 - 0.002], np.float32)
    pos[1, 0, 0] += 0.1
    pos[:, 1] = pos[:, 4] + np.array([-0.1, 0.02, 0.02 + 0.015 + 0.001], np.float32)
    rng = np.random.default_rng(3)
    a = np.zeros((2, B, 15), np.float32)
    a[:, :, 0:3] = rng.uniform(-1, 1, (2, B, 3))
    return env, d, a


def test_lane_step_matches_jax_lane_path(staged, monkeypatch):
    _, d, actions = staged
    monkeypatch.setattr(
        jax_pallas_solver, "solve_contacts_pallas",
        functools.partial(jax_pallas_solver.solve_contacts_pallas, interpret=True),
    )
    jenv = JCursorEnv(JEnvConfig(sim=JSimConfig(control_freq=100, use_pallas="lane")))
    tenv = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, use_pallas="lane")), device="cpu")
    assert isinstance(tenv.physics, LanePhysics)
    like = jax.vmap(jenv._initial_state)(
        jax.tree.map(lambda x: jnp.zeros((B,) + x.shape, x.dtype), jenv._sample_parts(jax.random.PRNGKey(0)))
    )
    jstate = _from_np(d, like)
    tstate = cursor_state_from_numpy(d, "cpu")
    jstep = jax.jit(jenv.step_batch)
    for i, a in enumerate(actions):
        jstate, _, jr, jd, _ = jstep(jstate, jnp.asarray(a))
        tstate, _, tr, td, _ = tenv.step_batch(tstate, torch.as_tensor(a))
        jn, tn = _to_np(jstate), cursor_state_to_numpy(tstate)
        for f in EXACT:
            np.testing.assert_array_equal(jn[f], tn[f], err_msg=f"step {i}: {f}")
        for f in PART_FIELDS + ("cursor_pos",):
            err = np.max(np.abs(jn[f].astype(np.float32) - tn[f]))
            assert err < 1e-3, (i, f, err)
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    # the parts moved: the comparison was not of a state at rest
    assert np.abs(tn["ang_vel"]).max() > 0.1


def test_lane_step_differs_from_default_step(staged):
    """Cold-started sweeps against the warm-started default: a port that
    ignored the mode would give equal states."""
    env, d, actions = staged
    lane_env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, use_pallas="lane")), device="cpu")
    s_def = cursor_state_from_numpy(d, "cpu")
    s_lane = cursor_state_from_numpy(d, "cpu")
    for a in actions:
        s_def = env.step_batch(s_def, torch.as_tensor(a))[0]
        s_lane = lane_env.step_batch(s_lane, torch.as_tensor(a))[0]
    diff = (s_def.parts.ang_vel - s_lane.parts.ang_vel).abs().max().item()
    assert diff > 1e-2, diff
    for t in s_lane.parts:
        assert torch.isfinite(t).all()


def test_settled_reset_is_the_same_in_lane_mode():
    """Nothing moves in a settle from rest on the floor, so the lane backend
    gives the default backend's reset."""
    out = {}
    for mode in ("off", "lane"):
        env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, use_pallas=mode)), device="cpu")
        out[mode] = env.reset_batch(B, torch.Generator().manual_seed(5)).parts
    for a, b in zip(out["off"], out["lane"]):
        assert (a - b).abs().max() < 1e-5
