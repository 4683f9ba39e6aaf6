"""PyTorch port: every furniture model reset and stepped, on the card.

Card-only (``gpu`` marker): each case skips itself without a CUDA card. The
mirror of ``tests/test_all_furniture_runtime.py``: every model of the
registry as a live ``CursorEnv`` (reset, then 3 steps of the JAX test's
action), and a subset of six through the Sawyer impedance env, at the
JAX test's coarse ``SimConfig(timestep=0.01, solver_iters=6)``, with its
checks on every env of a batch of 16: finite state, unit quaternions, parts
above the floor, finite reward and observations. The padded lane tables,
conn-site tables, placement sampling and settle run here through the
kernels: 10 launches of kernel 1 a reset, 2 a cursor step, one of kernel 2
an impedance step. Then kernel 1 against its plain version after 5
substeps from the settled reset and, for the cursor, from the stepped
state (``hold_free`` with ``chaotic``: a model's reset may be chaotic in
most of its envs), and kernel 2 at each arm step's recorded inputs
(``assert_held``). The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_all_furniture_gpu.py
"""

import pytest
import torch
from torch_gpu_holds import assert_held, card, hold_free, recording

from furniture_tpu_torch.models import furniture_names

B = 16
_COARSE = dict(timestep=0.01, solver_iters=6)
_ARM_SUBSET = [
    "table_lack_0825",
    "swivel_chair_0700",
    "chair_agne_0007",
    "bench_bjursta_0210",
    "desk_mikael_1064",
    "shelf_ivar_0678",
]


def _config(name, **kw):
    card()
    from furniture_tpu_torch.config import EnvConfig, SimConfig

    return EnvConfig(furniture_name=name, sim=SimConfig(**_COARSE), **kw)


def _assert_live_state(env, state, name):
    parts = state.parts
    for f in ("pos", "quat", "lin_vel"):
        assert torch.isfinite(getattr(parts, f)).all(), f"{name}: {f} not finite"
    qn = torch.linalg.norm(parts.quat, dim=-1)
    assert (qn - 1.0).abs().max().item() <= 1e-3, f"{name}: quaternions not unit"
    zmin = parts.pos[..., 2].min().item()
    max_halfdim = float(env.model.geom_size.max())
    assert zmin > -max_halfdim - 0.02, f"{name}: part center sank below the floor (z={zmin:.3f})"


def _generator(seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


@pytest.mark.gpu
@pytest.mark.parametrize("name", furniture_names)
def test_cursor_reset_and_step_every_furniture(name):
    from furniture_tpu_torch.envs.cursor import CursorEnv

    env = CursorEnv(_config(name), device="cuda")
    state = reset = env.reset_batch(B, _generator(3))
    _assert_live_state(env, state, name)
    action = torch.zeros((B, env.dof), device="cuda")
    action[:, 0] = 0.5
    action[:, 2] = 0.2
    for _ in range(3):
        state, obs, rew, done, info = env.step_batch(state, action)
    assert env.physics.launches == 10 + 2 * 3
    _assert_live_state(env, state, name)
    assert torch.isfinite(rew).all()
    for k, v in obs.items():
        assert torch.isfinite(v.float()).all(), f"{name}: obs[{k}]"
    ones = torch.ones((B, env._P), device="cuda")
    for st in (reset, state):
        h = hold_free(env.physics, st.parts, st.group, ones, 5, 1e-4, chaotic=True)
        assert h["problem"] is None, h


@pytest.mark.gpu
@pytest.mark.parametrize("name", _ARM_SUBSET)
def test_arm_reset_and_step_subset(name):
    from furniture_tpu_torch.envs.arm import ArmEnv

    env = ArmEnv(_config(name, agent_type="Sawyer", control_type="impedance"), device="cuda")
    state = env.reset_batch(B, _generator(4))
    _assert_live_state(env, state, name)
    assert torch.isfinite(state.qpos).all()
    reset = state
    action = torch.zeros((B, env.dof), device="cuda")
    action[:, -2] = -1.0
    with recording(env, keep=3) as calls:
        for _ in range(3):
            state, obs, rew, done, info = env.step_batch(state, action)
    assert (env._settle_physics.launches, env.physics.launches, len(calls)) == (10, 3, 3)
    ones = torch.ones((B, env._P), device="cuda")
    h = hold_free(env._settle_physics, reset.parts, reset.group, ones, 5, 1e-4, chaotic=True)
    assert h["problem"] is None, h
    assert_held(env.physics, calls, name)
    _assert_live_state(env, state, name)
    assert torch.isfinite(state.qpos).all(), f"{name}: qpos"
    assert torch.isfinite(rew).all()
