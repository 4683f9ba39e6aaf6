"""PyTorch port: import hygiene, transforms parity and the placement sampler.

The port (``furniture_tpu_torch``) runs here on the CPU. Inputs are made
with numpy from a seed and handed to both packages; JAX stays on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu import transforms as JT
from furniture_tpu_torch import transforms as TT
from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.envs.assembly import sample_placement
from furniture_tpu_torch.models import compile_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Importing the port, building a table_lack cursor env and a Sawyer arm
    env and stepping both loads neither jax nor the JAX package (fresh
    interpreter: this process has imported jax already)."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import furniture_tpu_torch as ft\n"
        "from furniture_tpu_torch.config import EnvConfig, SimConfig\n"
        "env = ft.CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device='cpu')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "s = env.reset_batch(2, g)\n"
        "s, obs, rew, done, info = env.step_batch(s, torch.zeros(2, 15))\n"
        "assert torch.isfinite(s.parts.pos).all()\n"
        "import furniture_tpu_torch.envs.arm\n"
        "vec = ft.make_vec_env('IKEASawyer-v0', 2, device='cpu', control_type='impedance',\n"
        "                      sim=SimConfig(control_freq=100))\n"
        "vec.reset()\n"
        "obs, rew, done, info = vec.step(torch.zeros(2, vec.env.dof))\n"
        "assert torch.isfinite(vec.state.qpos).all() and vec.env.physics.K == 1260\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'furniture_tpu' or m.startswith('furniture_tpu.')]\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _unit_quats(rng, n):
    q = _rand(rng, n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "name",
    [
        "unit", "quat_normalize", "quat_mul", "quat_inv", "quat_rotate",
        "quat_from_axis_angle", "quat_to_mat", "mat_to_quat", "euler_to_quat",
        "quat_slerp", "directions", "lookat_to_quat", "rotate_vector",
        "rotate_vector_cos_siml", "cos_siml", "pose_ops", "pose_compose",
        "angles", "conventions",
    ],
)
def test_transforms_match_jax(name):
    """Elementwise parity with furniture_tpu.transforms at 1e-6."""
    rng = np.random.default_rng(0)
    n = 64
    q1, q2 = _unit_quats(rng, n), _unit_quats(rng, n)
    v, w = _rand(rng, n, 3), _rand(rng, n, 3)
    J = lambda f, *a: getattr(JT, f)(*(jnp.asarray(x) for x in a))
    P = lambda f, *a: getattr(TT, f)(*(torch.as_tensor(np.array(x)) for x in a))
    if name in ("unit", "quat_normalize"):
        x = v if name == "unit" else _rand(rng, n, 4)
        x[0] = 0.0  # the smoothed norm at zero
        _close(J(name, x), P(name, x))
    elif name in ("quat_mul",):
        _close(J(name, q1, q2), P(name, q1, q2))
    elif name in ("quat_inv", "quat_to_mat"):
        _close(J(name, q1), P(name, q1))
    elif name == "quat_rotate":
        _close(J(name, q1, v), P(name, q1, v))
    elif name == "quat_from_axis_angle":
        ang = _rand(rng, n)
        _close(J(name, v, ang), P(name, v, ang))
    elif name == "mat_to_quat":
        m = np.asarray(JT.quat_to_mat(jnp.asarray(q1)))
        _close(J(name, m), P(name, m))
    elif name == "euler_to_quat":
        rot = (rng.uniform(-180, 180, (n, 3))).astype(np.float32)
        _close(J(name, rot), P(name, rot))
        _close(J(name, rot, q1), P(name, rot, q1))
    elif name == "quat_slerp":
        t = rng.uniform(0, 1, n).astype(np.float32)
        _close(J(name, q1, q2, t), P(name, q1, q2, t), atol=2e-6)
        _close(J(name, q1, q1, t), P(name, q1, q1, t))  # the lerp branch
    elif name == "directions":
        for f in ("forward_vector_from_quat", "up_vector_from_quat",
                  "right_vector_from_quat"):
            _close(J(f, q1), P(f, q1))
    elif name == "lookat_to_quat":
        _close(J(name, v, w), P(name, v, w), atol=2e-6)
    elif name == "rotate_vector":
        ang = rng.uniform(-360, 360, n).astype(np.float32)
        _close(J(name, v, w, ang), P(name, v, w, ang), atol=2e-6)
    elif name == "rotate_vector_cos_siml":
        c = rng.uniform(-1.2, 1.2, n).astype(np.float32)
        for d in (1.0, -1.0):
            _close(JT.rotate_vector_cos_siml(jnp.asarray(v), jnp.asarray(w), jnp.asarray(c), d),
                   TT.rotate_vector_cos_siml(torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(c), d))
    elif name == "cos_siml":
        _close(J(name, v, w), P(name, v, w))
    elif name == "pose_ops":
        p1 = np.concatenate([v, q1], -1)
        p2 = np.concatenate([w, q2], -1)
        _close(J("rel_pose", p1, p2), P("rel_pose", p1, p2), atol=2e-6)
        for a, b in zip(J("transform_to_target_quat", p1, p2, q2),
                        P("transform_to_target_quat", p1, p2, q2)):
            _close(a, b, atol=2e-6)
    elif name == "pose_compose":
        for a, b in zip(J("pose_mul", v, q1, w, q2), P("pose_mul", v, q1, w, q2)):
            _close(a, b, atol=2e-6)
        for a, b in zip(J("pose_inv", v, q1), P("pose_inv", v, q1)):
            _close(a, b, atol=2e-6)
    elif name == "angles":
        ang = _rand(rng, n)
        _close(J("angle_between2D", v[:, :2], w[:, :2]), P("angle_between2D", v[:, :2], w[:, :2]))
        _close(J("angle_between", v, w), P("angle_between", v, w), atol=2e-6)
        _close(J("rotate_vector2D", v[:, :2], ang), P("rotate_vector2D", v[:, :2], ang))
    elif name == "conventions":
        for to in ("xyzw", "wxyz"):
            _close(JT.convert_quat(jnp.asarray(q1), to), TT.convert_quat(torch.as_tensor(q1), to), atol=0)
        _close(J("l2_dist", v, w), P("l2_dist", v, w))
        _close(JT.quat_identity((3,)), TT.quat_identity((3,)), atol=0)


def test_sampler_bounds_and_overlap_rejection():
    """The port's own sampler (it cannot reproduce jax.random's bits): xy
    noise within ±furn_xyz_rand of the init pose, z lifted by 1 cm, the
    constant rotation offset, and overlap rejection that leaves fewer
    overlapping envs than a single draw."""
    model = compile_model("table_lack_0825")
    base = model.part_init_pos.astype(np.float32)
    radius = model.part_horiz_radius.astype(np.float32)

    def overlap_frac(pos):
        d = np.linalg.norm(pos[:, :, None, :2] - pos[:, None, :, :2], axis=-1)
        lower = np.tril(np.ones(d.shape[1:], bool), -1)
        bad = (d <= radius[:, None] + radius[None, :]) & lower
        return bad.any((1, 2)).mean()

    cfg = EnvConfig(furn_xyz_rand=0.25)
    g = torch.Generator().manual_seed(0)
    pos, quat = sample_placement(model, cfg, 512, g, "cpu")
    pos, quat = pos.numpy(), quat.numpy()
    r = cfg.furn_xyz_rand
    assert np.all(np.abs(pos[..., :2] - base[:, :2]) <= r + 1e-6)
    np.testing.assert_allclose(pos[..., 2], np.broadcast_to(base[:, 2] + 0.01, pos.shape[:2]), atol=1e-6)
    rot = np.zeros((model.n_parts, 3), np.float32)
    rot[:, 0] = cfg.furn_rot_rand
    want = np.asarray(JT.euler_to_quat(jnp.asarray(rot), jnp.asarray(model.part_init_quat, jnp.float32)))
    np.testing.assert_allclose(quat, np.broadcast_to(want, quat.shape), atol=1e-6)

    # the first draw alone (before any rejection round) overlaps far more often
    u = torch.rand((512, model.n_parts, 2), generator=torch.Generator().manual_seed(0))
    raw = base[:, :2] + (-r + u.numpy() * (2 * r))
    f_raw, f_rej = overlap_frac(raw), overlap_frac(pos)
    assert f_raw > 0.3, f_raw
    assert f_rej < 0.5 * f_raw, (f_raw, f_rej)
