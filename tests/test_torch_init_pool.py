"""PyTorch port: the initial-state pool against the JAX package.

* ``utils.init_pool``: ``snapshot``, ``stack_pool``, ``save_pool`` and
  ``load_pool`` give what the JAX package's give on the same states, and a
  pool file written by one package loads in the other; ``pool_from_demo``
  likewise on a synthetic demo;
* a reset with a pool (the mirror of ``tests/test_reset_variants.py``'s pool
  case): each env takes the pool entry its draw gives it where the uniform
  draw exceeds 0.2 and keeps the sampler's placement elsewhere, velocities
  are zero, and ``subtask`` equals the JAX ``next_subtask`` of the same
  groups. The draws are replayed from an identically seeded generator;
* the arm env takes ``qpos``/``qvel`` from the pool too, and
  ``EnvConfig.load_init_states`` loads a pool file at construction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu.config import EnvConfig as JEnvConfig
from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
from furniture_tpu.utils import init_pool as jpool
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.assembly import apply_reset_variants, pool_draw
from furniture_tpu_torch.envs.cursor import CursorEnv, _squeeze
from furniture_tpu_torch.utils import init_pool as tpool

torch.set_num_threads(1)

FAST = SimConfig(control_freq=100)
POOL_KEYS = ("pos", "quat", "group", "weld_active", "conn_connected", "num_connected")


@pytest.fixture(scope="module")
def env():
    return CursorEnv(EnvConfig(sim=FAST), device="cpu")


@pytest.fixture(scope="module")
def entries(env):
    """Three recognizable states: all parts shifted to distinct x bands, the
    second with two recipe steps connected, the third with the recipe step
    of the first weld connected."""
    out = []
    for dx, pre in ((5.0, ()), (9.0, (0, 1)), (13.0, (3,))):
        e = CursorEnv(EnvConfig(sim=FAST, preassembled=pre), device="cpu")
        s = e.reset_batch(1, torch.Generator().manual_seed(int(dx)))
        shift = torch.tensor([dx, 0.0, 0.0])
        out.append(_squeeze(s._replace(parts=s.parts._replace(pos=s.parts.pos + shift))))
    return out


class _JaxLike:
    """A state with the same fields as jnp arrays, for the JAX snapshot."""

    def __init__(self, s):
        self.parts = type("P", (), {"pos": jnp.asarray(s.parts.pos.numpy()),
                                    "quat": jnp.asarray(s.parts.quat.numpy())})
        for f in ("group", "weld_active", "conn_connected", "num_connected"):
            setattr(self, f, jnp.asarray(getattr(s, f).numpy()))


def test_snapshot_and_stack_match_jax(entries):
    ours = tpool.stack_pool([tpool.snapshot(s) for s in entries])
    theirs = jpool.stack_pool([jpool.snapshot(_JaxLike(s)) for s in entries])
    assert set(ours) == set(theirs) == set(POOL_KEYS)
    for k in POOL_KEYS:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["pos"].shape == (3, 5, 3)


def test_save_load_round_trip_across_packages(entries, tmp_path):
    snaps = [tpool.snapshot(s) for s in entries]
    tpool.save_pool(str(tmp_path / "ours.pkl"), snaps)              # a list of snapshots
    jpool.save_pool(str(tmp_path / "theirs.pkl"), jpool.stack_pool(snaps))
    for path in ("ours.pkl", "theirs.pkl"):
        a = tpool.load_pool(str(tmp_path / path))
        b = jpool.load_pool(str(tmp_path / path))
        for k in POOL_KEYS:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], tpool.stack_pool(snaps)[k])


def test_pool_from_demo_matches_jax():
    rng = np.random.default_rng(0)
    states = [
        {"parts_pos": rng.normal(size=(5, 3)), "parts_quat": rng.normal(size=(5, 4)),
         "group": np.arange(5), "weld_active": np.zeros(4, bool),
         "conn_connected": np.zeros(8, bool), "num_connected": np.int32(i % 2),
         "qpos": rng.normal(size=9), "qvel": rng.normal(size=9)}
        for i in range(7)
    ]
    a = tpool.pool_from_demo({"states": states}, stride=3)
    b = jpool.pool_from_demo({"states": states}, stride=3)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert len(a["pos"]) == 3 and not a["qvel"].any()
    with pytest.raises(ValueError, match="no states"):
        tpool.pool_from_demo({"states": []})


def test_reset_with_pool_follows_the_draw(env, entries):
    B = 16
    pool = tpool.stack_pool([tpool.snapshot(s) for s in entries])
    env.set_init_state_pool(pool)
    try:
        seed = 11
        state = env.reset_batch(B, torch.Generator().manual_seed(seed))
        # replay: the placement draws, then the pool draws
        g = torch.Generator().manual_seed(seed)
        sampled = env.sample_parts(B, g)
        idx, use = pool_draw(3, B, g, "cpu")
    finally:
        env.set_init_state_pool(None)
    fresh = env.reset_from_parts(sampled)
    assert use.any() and not use.all(), "seed must exercise both branches"
    assert len(set(idx[use].tolist())) > 1
    for b in range(B):
        if use[b]:
            i = int(idx[b])
            np.testing.assert_array_equal(state.parts.pos[b].numpy(), pool["pos"][i])
            np.testing.assert_array_equal(state.parts.quat[b].numpy(), pool["quat"][i])
            np.testing.assert_array_equal(state.group[b].numpy(), pool["group"][i])
            np.testing.assert_array_equal(state.weld_active[b].numpy(), pool["weld_active"][i])
            np.testing.assert_array_equal(state.conn_connected[b].numpy(), pool["conn_connected"][i])
            assert int(state.num_connected[b]) == int(pool["num_connected"][i])
        else:
            np.testing.assert_array_equal(state.parts.pos[b].numpy(), fresh.parts.pos[b].numpy())
            assert int(state.num_connected[b]) == 0
    assert not state.parts.lin_vel.any() and not state.parts.ang_vel.any()
    assert state.group.dtype == torch.int32 and state.num_connected.dtype == torch.int32
    # subtask: the JAX next_subtask of the same groups
    jenv = JCursorEnv(JEnvConfig())
    for b in range(B):
        ref = np.asarray(jenv.ops.next_subtask(jnp.asarray(state.group[b].numpy())))
        np.testing.assert_array_equal(state.subtask[b].numpy(), ref)
    # the entry whose first weld is closed moves on to another subtask
    moved_on = state.subtask[use & (idx == 2)]
    assert len(moved_on) and (moved_on != state.subtask[~use][:1]).any(-1).all()


def test_pool_share_is_the_references(env, entries):
    """The pool entry is used with probability 0.8."""
    env.set_init_state_pool([tpool.snapshot(s) for s in entries])   # a list is accepted
    try:
        state = apply_reset_variants(
            env.ops, env.config, env._init_pool,
            env._initial_state(env.sample_parts(400, torch.Generator().manual_seed(0))),
            torch.Generator().manual_seed(1),
        )
    finally:
        env.set_init_state_pool(None)
    share = (state.parts.pos[:, :, 0].mean(-1) > 2.0).float().mean().item()
    assert 0.72 < share < 0.88, share
    with pytest.raises(ValueError, match="generator"):
        apply_reset_variants(env.ops, env.config, {"pos": torch.zeros(1, 5, 3)},
                             env._initial_state(env.sample_parts(1, torch.Generator())), None)


def test_load_init_states_from_config(entries, tmp_path):
    path = str(tmp_path / "pool.pkl")
    tpool.save_pool(path, [tpool.snapshot(s) for s in entries])
    env = CursorEnv(EnvConfig(sim=FAST, load_init_states=path), device="cpu")
    assert env._init_pool["pos"].shape == (3, 5, 3)
    assert env._init_pool["group"].dtype == torch.int32
    s = env.reset_batch(8, torch.Generator().manual_seed(0))
    assert (s.parts.pos[:, :, 0].mean(-1) > 2.0).any()


def test_arm_env_pool_carries_joints(tmp_path):
    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance", sim=FAST), device="cpu")
    base = env.reset_batch(2, torch.Generator().manual_seed(0))
    bent = base._replace(qpos=base.qpos + 0.3, qvel=torch.zeros_like(base.qvel))
    snaps = [tpool.snapshot(_squeeze(bent._replace(qpos=bent.qpos + 0.1 * i))) for i in range(2)]
    assert "qpos" in snaps[0] and snaps[0]["qpos"].shape == (env.robot.nj,)
    env.set_init_state_pool(snaps)
    seed = 3
    s = env.reset_batch(12, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    env._reset_unsettled(12, g)                 # placement and joint-noise draws
    idx, use = pool_draw(2, 12, g, "cpu")
    assert use.any()
    pool = tpool.stack_pool(snaps)
    for b in range(12):
        if use[b]:
            np.testing.assert_array_equal(s.qpos[b].numpy(), pool["qpos"][int(idx[b])])
            np.testing.assert_array_equal(s.parts.pos[b].numpy(), pool["pos"][int(idx[b])])
    assert not s.qvel[use].any()
    # a step from a pooled reset runs
    s2, _, rew, _, info = env.step_batch(s, torch.zeros((12, env.dof)))
    assert torch.isfinite(s2.qpos).all() and not info["unstable"].any()
