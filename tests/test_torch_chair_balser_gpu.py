"""PyTorch port: the cursor on chair_balser_0115 on the card, at the
benchmark cell's batch (B = 1024).

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The model's lane working set (4153
lanes, 5376 slots of one block) is over the shared memory a block may have,
so every launch of kernel 1 takes the cluster route (one env on a cluster of
3 CTAs whose shared memories hold the working set), in the reset's settle,
in the step and in the snap. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_chair_balser_gpu.py
"""

import pytest
import torch
from torch_gpu_holds import card

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import SimConfig

NAME, B = "chair_balser_0115", 1024


@pytest.mark.gpu
def test_vec_env_b1024_takes_global_scratch():
    """``make_vec_env`` at the cell's size (the default ``SimConfig``): a
    reset and 3 closed-loop steps on uniform random actions launch kernel 1
    10 times a reset and twice a step (the n-substep and the 1-substep snap
    launches), every launch on the cluster route (3 CTAs an env, every
    launch counted in ``cluster_launches``), and leave the state finite with
    unit quaternions and no env unstable."""
    card()
    vec = ft.make_vec_env("IKEACursor-v0", B, seed=2147483659, device="cuda", sim=SimConfig(),
                          furniture_name=NAME)
    env = vec.env
    ph = env.physics
    lay = ph.layout
    assert (lay.route, lay.cluster, lay.threads) == ("cluster", 3, 512) and lay.smem <= 232448
    assert (ph.P, ph.K, ph.slots["KS"], ph.cluster["KS"]) == (8, 4153, 5376, 1536)
    assert ph.resident_blocks() >= 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    vec.reset()
    dones = 0
    for _ in range(3):
        obs, rew, done, info = vec.step(torch.rand((B, env.dof), generator=gen, device="cuda") * 2 - 1)
        dones += bool(done.any())
        assert not bool(info["unstable"].any())
    torch.cuda.synchronize()
    assert ph.launches == 10 + 2 * 3 + 10 * dones
    assert ph.cluster_launches == ph.launches
    s = vec.state
    for t in list(s.parts) + [rew] + [o for o in obs.values() if o.is_floating_point()]:
        assert bool(torch.isfinite(t).all())
    assert bool(((s.parts.quat.norm(dim=-1) - 1).abs() < 1e-3).all())
