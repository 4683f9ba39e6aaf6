"""PyTorch port: the renderer and the single-env wrapper on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_render_gpu.py

* the typed chunked path against the generic per-geom path at 200 x 200,
  B = 8, for the cursor (table_lack) and for Sawyer: ``seg`` identical,
  ``rgb`` within 1e-5;
* a render makes no host synchronisation
  (``torch.cuda.set_sync_debug_mode("error")``), for the cursor and for
  Sawyer;
* the reference's two render-on rollouts, with their kernel held at a
  step's own inputs;
* the wrapper on the card: reset, steps, camera observations and the three
  render modes, for the cursor and for Sawyer, with its launches and its
  kernel held at the last step's inputs.
"""

import numpy as np
import pytest
import torch
from torch_gpu_holds import assert_held, card, recording

from furniture_tpu_torch.api import make_env
from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.render import SEG_BACKGROUND, frontview, make_render_fn, render

B, SIDE = 8, 200


def _env(kind, dev):
    if kind == "cursor":
        return CursorEnv(EnvConfig(furniture_name="table_lack_0825"), device=dev)
    return ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device=dev)


def _states(env, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = env.reset_batch(B, gen)
    # a step of random actions, so that every env differs
    return env.step_batch(st, torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cursor", "sawyer"])
def test_chunked_matches_generic_on_the_card(kind):
    dev = card()
    env = _env(kind, dev)
    state = _states(env, dev)
    cam = frontview(SIDE, SIDE)
    rf = make_render_fn(env, cam)
    rgb_c, depth_c, seg_c = rf(state)
    rgb_g, depth_g, seg_g = render(rf.scene(state), cam)
    assert torch.equal(seg_c, seg_g)
    assert (rgb_c - rgb_g).abs().max().item() < 1e-5
    assert (seg_c >= 0).any() and rgb_c.shape == (B, SIDE, SIDE, 3)
    hit = seg_c != SEG_BACKGROUND
    assert bool(hit.any() and (~hit).any())
    assert bool(torch.isfinite(depth_c[hit]).all()) and bool(torch.isinf(depth_c[~hit]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cursor", "sawyer"])
def test_render_makes_no_host_sync(kind):
    dev = card()
    env = _env(kind, dev)
    state = _states(env, dev)
    rf = make_render_fn(env, frontview(SIDE, SIDE))
    rf(state)                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rgb, depth, seg = rf(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(rgb).all() and seg.dtype == torch.int32


@pytest.mark.gpu
@pytest.mark.parametrize("kind,nb,side", [("sawyer", 128, 200), ("cursor", 32, 500)])
def test_render_rollout(kind, nb, side):
    """The reference's two render-on workloads (``bench.py:118-160``,
    ``:304-309``): Sawyer impedance at 128 envs, 200 x 200, and the cursor at
    32 envs, 500 x 500, as rollouts of random actions, a step then a render,
    3 steps: one launch of kernel 2 a step and none of kernel 1, or two of
    kernel 1 a step; frames finite. Then one more step, its physics
    inputs recorded, and the kernel held there (``assert_held``)."""
    dev = card()
    env = _env(kind, dev)
    rf = make_render_fn(env, frontview(side, side))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    st = env.reset_batch(nb, gen)
    arm = kind == "sawyer"
    counters = [env.physics, env.physics.free] if arm else [env.physics]
    for c in counters:
        c.launches = 0
    for _ in range(3):
        st = env.step_batch(st, torch.rand((nb, env.dof), generator=gen, device=dev) * 2 - 1)[0]
        rgb, depth, seg = rf(st)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == ([3, 0] if arm else [6])
    assert torch.isfinite(rgb).all() and rgb.shape == (nb, side, side, 3)
    with recording(env, keep=2) as calls:
        rf(env.step_batch(st, torch.rand((nb, env.dof), generator=gen, device=dev) * 2 - 1)[0])
    assert_held(env.physics, calls, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["IKEACursor-v0", "IKEASawyer-v0"])
def test_wrapper_on_the_card(name):
    """Reset and 3 steps with all three camera observations at 64 x 64: the
    shapes, the three render modes equal to the observations, an unknown
    mode raising, the launches (the cursor 10 a reset and 2 a step; Sawyer
    under ik 10 of kernel 1 a reset and 3 of kernel 2 a step), and the
    kernel held at the last step's recorded inputs."""
    card()
    env = make_env(name, camera_ob=True, depth_ob=True, segmentation_ob=True,
                   screen_width=64, screen_height=64)
    assert env.device.type == "cuda"
    arm = "Sawyer" in name
    counters = [env.env.physics, env.env.physics.free] if arm else [env.env.physics]
    for c in counters:
        c.launches = 0
    ob = env.reset(seed=0)
    rng = np.random.RandomState(0)
    for _ in range(2):
        env.step(env.action_space.sample(rng))
    with recording(env.env, keep=8) as calls:
        ob, rew, done, info = env.step(env.action_space.sample(rng))
    assert [c.launches for c in counters] == ([3 * env.env.config.action_repeat, 10] if arm else [16])
    assert ob["camera_ob"].shape == (64, 64, 3) and ob["depth_ob"].shape == (64, 64)
    assert ob["segmentation_ob"].shape == (64, 64) and np.isfinite(rew)
    assert np.array_equal(env.render("rgb_array"), ob["camera_ob"])
    assert np.array_equal(env.render("depth_array"), ob["depth_ob"])
    assert np.array_equal(env.render("segmentation"), ob["segmentation_ob"])
    with pytest.raises(ValueError):
        env.render("no_such_mode")
    assert_held(env.env.physics, calls, name)
