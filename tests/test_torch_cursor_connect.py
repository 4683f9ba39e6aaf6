"""PyTorch port: the connect's alignment gate and the solver's normal floor.

``test_connect_requires_alignment`` mirrors ``tests/test_cursor_env.py:135``
on the port alone (CPU, the free-part kernel's plain version, ``SimConfig(
control_freq=100)``), beside the same staged state connecting where it is
aligned. The normal-impulse floor (``min_normal`` of ``_solve_contacts``,
``extra_min_normal`` of the substep) is held against the JAX package's
``engine._solve_contacts`` and ``substep``, called eagerly (no ``jax.jit``)
on the same inputs, with a floor on some lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import SimConfig as JSimConfig
from furniture_tpu.models import compile_model as jax_compile_model
from furniture_tpu.physics import engine as jax_engine
from furniture_tpu.physics.collide import Contacts as JContacts
from furniture_tpu.physics.state import PartState as JPartState
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.models import compile_model
from furniture_tpu_torch.physics import engine
from furniture_tpu_torch.physics.collide import Contacts
from furniture_tpu_torch.physics.state import PartState

torch.set_num_threads(1)

NAME = "table_lack_0825"


# -- the connect's alignment gate (tests/test_cursor_env.py:135) -----------------


@pytest.fixture(scope="module")
def env():
    return CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")


def _staged_connect_state(env):
    """The JAX test's staged state: tabletop held at 0.5 m, leg 0 posed so its
    conn site sits 1 cm under the table's conn_site1, identity quats, both
    cursors selecting."""
    m = env.model
    s = env.reset(torch.Generator().manual_seed(1))
    pos = s.parts.pos.clone()
    pos[4] = torch.tensor([0.0, 0.0, 0.5])
    table_site = list(m.conn_names).index("table-leg,0,90,180,270,conn_site1")
    site_t = pos[4] + torch.as_tensor(m.conn_pos[table_site], dtype=torch.float32)
    pos[0] = site_t - torch.as_tensor(m.conn_pos[0], dtype=torch.float32) + torch.tensor([0.0, 0.0, -0.01])
    return s._replace(
        parts=s.parts._replace(pos=pos, quat=torch.tensor([1.0, 0, 0, 0]).repeat(5, 1)),
        selected=torch.tensor([0, 4], dtype=torch.int32),
        cursor_pos=torch.stack([pos[0], pos[4]]),
    )


def _connect_steps(env, s, n=12):
    a = torch.zeros(15)
    a[6] = a[13] = a[14] = 1.0
    for _ in range(n):
        s, *_ = env.step(s, a)
    return s


def test_staged_connect_connects(env):
    """The aligned staged state connects within the connect window (the
    positive control of the test below)."""
    s = _connect_steps(env, _staged_connect_state(env), env.config.num_connect_steps + 1)
    assert int(s.num_connected) == 1


def test_connect_requires_alignment(env):
    """Far-apart parts never connect: leg 0 moved 1 m away, 12 steps of
    select + connect."""
    s = _staged_connect_state(env)
    pos = s.parts.pos.clone()
    pos[0, 0] += 1.0
    s = _connect_steps(env, s._replace(parts=s.parts._replace(pos=pos)))
    assert int(s.num_connected) == 0


# -- the normal-impulse floor against the JAX engine ------------------------------


B = 2


@pytest.fixture(scope="module")
def setup():
    """The port's substep for table_lack, a state of B envs with the parts
    pressed 2 mm into the floor and moving (so floor lanes are active), and
    the JAX package's substep on the same model."""
    tables = engine.physics_tables(compile_model(NAME))
    sub = engine.make_substep(tables, SimConfig(), "cpu")
    m = compile_model(NAME)
    rng = np.random.default_rng(0)
    P = m.n_parts
    pos = np.tile(m.part_init_pos.astype(np.float32), (B, 1, 1))
    pos[..., :2] += rng.uniform(-0.02, 0.02, (B, P, 2)).astype(np.float32)
    pos[..., 2] -= 0.002
    quat = np.tile(m.part_init_quat.astype(np.float32), (B, 1, 1))
    lin = rng.normal(0, 0.05, (B, P, 3)).astype(np.float32)
    ang = rng.normal(0, 0.1, (B, P, 3)).astype(np.float32)
    state = [np.ascontiguousarray(a) for a in (pos, quat, lin, ang)]
    group = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    gscale = np.ones((B, P), np.float32)
    jtables = jax_engine.physics_tables(jax_compile_model(NAME))
    jsub = jax_engine.make_substep(jtables, JSimConfig())
    return sub, jsub, state, group, gscale


def _jax_contacts(c: Contacts, b: int) -> JContacts:
    K = c.depth.shape[1]
    vel_b = np.zeros((K, 3), np.float32) if c.vel_b is None else c.vel_b[b].numpy()
    return JContacts(
        point=jnp.asarray(c.point[b].numpy()), normal=jnp.asarray(c.normal[b].numpy()),
        depth=jnp.asarray(c.depth[b].numpy()), part_a=jnp.asarray(c.part_a.numpy().astype(np.int32)),
        part_b=jnp.asarray(c.part_b.numpy().astype(np.int32)), friction=jnp.asarray(c.friction.numpy()),
        mask=jnp.asarray(c.mask[b].numpy()), vel_b=jnp.asarray(vel_b), beta=jnp.asarray(c.beta.numpy()),
    )


def test_solve_min_normal_matches_jax(setup):
    """``_solve_contacts`` with a normal floor on a third of the lanes (cold
    start) against the JAX solve on the same contacts and aggregates,
    within 1e-5; the floor changes the result."""
    sub, _, state, group, gscale = setup
    _, args = sub.solver_args(PartState(*map(torch.from_numpy, state)), torch.from_numpy(group),
                              torch.from_numpy(gscale))
    c = args[0]
    K = c.depth.shape[1]
    rng = np.random.default_rng(1)
    floor = np.where(rng.random(K) < 0.3, rng.uniform(0.0, 0.002, K), 0.0).astype(np.float32)
    assert bool((c.mask & (torch.from_numpy(floor) > 0)).any()), "no floored lane is active"
    lam0 = torch.zeros((B, K, 3))
    lv, av, _, _ = engine._solve_contacts(*args, lam0, None, torch.from_numpy(floor))
    lv0, av0, _, _ = engine._solve_contacts(*args, lam0)
    assert (lv - lv0).abs().max().item() > 1e-3, "the floor did not bite"
    (_, group_t, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel, dt, iters, relax, slop) = args
    for b in range(B):
        jl, ja = jax_engine._solve_contacts(
            _jax_contacts(c, b), jnp.asarray(group_t[b].numpy()), jnp.asarray(g_com[b].numpy()),
            jnp.asarray(g_inv_mass[b].numpy()), jnp.asarray(g_inv_inertia[b].numpy()),
            jnp.asarray(lin_vel[b].numpy()), jnp.asarray(ang_vel[b].numpy()), dt, iters, relax,
            JSimConfig().baumgarte, slop, min_normal=jnp.asarray(floor),
        )
        np.testing.assert_allclose(lv[b].numpy(), np.asarray(jl), atol=1e-5)
        np.testing.assert_allclose(av[b].numpy(), np.asarray(ja), atol=1e-5)


def _finger_lanes(pos0: np.ndarray) -> tuple[Contacts, np.ndarray]:
    """Four kinematic lanes pressing part 0 down from above (a finger pad,
    ``part_b == -1``, resting), in every env, and their normal floors."""
    E = 4
    off = np.array([[0.01, 0.01, 0.02], [-0.01, 0.01, 0.02], [0.01, -0.01, 0.02],
                    [-0.01, -0.01, 0.02]], np.float32)
    point = (pos0[:, None, :] + off[None]).astype(np.float32)           # [B,E,3]
    normal = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (B, E, 1))
    c = Contacts(
        point=torch.from_numpy(point), normal=torch.from_numpy(normal),
        depth=torch.full((B, E), 0.001), mask=torch.ones((B, E), dtype=torch.bool),
        part_a=torch.zeros(E, dtype=torch.int64), part_b=torch.full((E,), -1, dtype=torch.int64),
        friction=torch.ones(E), beta=torch.full((E,), 0.2), vel_b=torch.zeros((B, E, 3)),
    )
    return c, np.array([0.02, 0.0, 0.01, 0.03], np.float32)


def test_substep_extra_min_normal_matches_jax(setup):
    """One ``substep`` with four floored kinematic lanes against the JAX
    ``substep`` with the same extra lanes and floor, within 1e-4."""
    sub, jsub, state, group, gscale = setup
    extra, floor = _finger_lanes(state[0][:, 0])
    lam = torch.zeros((B, sub.n_base_lanes + extra.depth.shape[1], 3))
    out, _, imp = sub(PartState(*map(torch.from_numpy, state)), torch.from_numpy(group),
                      torch.from_numpy(gscale), lam, extra_contacts=extra,
                      extra_min_normal=torch.from_numpy(floor))
    plain, _, _ = sub(PartState(*map(torch.from_numpy, state)), torch.from_numpy(group),
                      torch.from_numpy(gscale), lam, extra_contacts=extra)
    assert (out.lin_vel - plain.lin_vel).abs().max().item() > 1e-4, "the floor did not bite"
    for b in (0,):
        ref = jsub(JPartState(*(jnp.asarray(a[b]) for a in state)), jnp.asarray(group[b]),
                   jnp.asarray(gscale[b]), extra_contacts=_jax_contacts(extra, b),
                   extra_min_normal=jnp.asarray(floor))
        for name in PartState._fields:
            np.testing.assert_allclose(getattr(out, name)[b].numpy(), np.asarray(getattr(ref, name)),
                                       atol=1e-4, err_msg=name)


def test_extra_min_normal_needs_extra_lanes(setup):
    sub, _, state, group, gscale = setup
    with pytest.raises(ValueError):
        sub(PartState(*map(torch.from_numpy, state)), torch.from_numpy(group),
            torch.from_numpy(gscale), torch.zeros((B, sub.n_base_lanes, 3)),
            extra_min_normal=torch.zeros(4))
