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
* the wrapper on the card: reset, steps, camera observations and the three
  render modes, for the cursor and for Sawyer.
"""

import numpy as np
import pytest
import torch

from furniture_tpu_torch.api import make_env
from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.render import frontview, make_render_fn, render

B, SIDE = 8, 200


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's entry points run on it")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    dev = _card()
    env = _env(kind, dev)
    state = _states(env, dev)
    cam = frontview(SIDE, SIDE)
    rf = make_render_fn(env, cam)
    rgb_c, depth_c, seg_c = rf(state)
    rgb_g, depth_g, seg_g = render(rf.scene(state), cam)
    assert torch.equal(seg_c, seg_g)
    assert (rgb_c - rgb_g).abs().max().item() < 1e-5
    assert (seg_c >= 0).any() and rgb_c.shape == (B, SIDE, SIDE, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cursor", "sawyer"])
def test_render_makes_no_host_sync(kind):
    dev = _card()
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
@pytest.mark.parametrize("name", ["IKEACursor-v0", "IKEASawyer-v0"])
def test_wrapper_on_the_card(name):
    _card()
    env = make_env(name, camera_ob=True, depth_ob=True, segmentation_ob=True,
                   screen_width=64, screen_height=64)
    assert env.device.type == "cuda"
    ob = env.reset(seed=0)
    rng = np.random.RandomState(0)
    for _ in range(3):
        ob, rew, done, info = env.step(env.action_space.sample(rng))
    assert ob["camera_ob"].shape == (64, 64, 3) and ob["depth_ob"].shape == (64, 64)
    assert ob["segmentation_ob"].shape == (64, 64) and np.isfinite(rew)
    assert np.array_equal(env.render("rgb_array"), ob["camera_ob"])
    assert np.array_equal(env.render("depth_array"), ob["depth_ob"])
    assert np.array_equal(env.render("segmentation"), ob["segmentation_ob"])
