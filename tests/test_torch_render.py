"""PyTorch port: the ray-cast renderer, the single-env wrapper and the
info/video utilities, against the JAX package.

* the ray primitives (box slab, sphere, capped cylinder) on 4,096 random
  rays from a numpy seed, axis-parallel rays and rays from inside included:
  the hit masks identical, ``t`` within 1e-5 relative to max(t, 1 m) and
  the normals within 1e-5 where both hit;
* whole frames from one JAX state carried across with ``convert``: the
  cursor on table_lack at ``frontview(72, 72)`` and Sawyer at 64 x 64, the
  shapes ``tests/test_render.py`` renders. The ``seg`` maps agree except on
  at most 0.1% of the pixels, each on a silhouette edge (a 4-neighbour has
  another id in one of the two maps: XLA and PyTorch may round a ray's
  float32 arithmetic differently, which can flip a pixel a grazing ray
  decides); ``rgb`` and ``depth`` within 1e-4 where ``seg`` agrees, and
  ``depth`` is ``inf`` on the background;
* the typed chunked path against the generic per-geom path for rotated
  geoms of every type (the scene of ``tests/test_render.py:83-111``):
  ``seg`` identical, ``rgb`` within 1e-5;
* mirrors of ``tests/test_render.py`` (shapes, ids, depth order, a moving
  part, the batch, ``to_uint8``, the robot ids, the wrapper's camera
  observations and render modes) and of ``tests/test_utils.py``'s video
  recorder and ``Info``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furniture_tpu import transforms as JT
from furniture_tpu.config import EnvConfig as JEnvConfig
from furniture_tpu.envs.arm import ArmEnv as JArmEnv
from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
from furniture_tpu.render import Camera as JCamera
from furniture_tpu.render import frontview as jfrontview
from furniture_tpu.render import make_render_fn as jmake_render_fn
from furniture_tpu.render import raycast as jr
from furniture_tpu_torch import api
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import arm_state_from_numpy, cursor_state_from_numpy
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.models.compiler import BOX, CYLINDER, SPHERE
from furniture_tpu_torch.physics.state import PartState
from furniture_tpu_torch.render import (
    SEG_BACKGROUND,
    SEG_FLOOR,
    Camera,
    GeomScene,
    frontview,
    make_render_fn,
    render,
    to_uint8,
)
from furniture_tpu_torch.render import raycast as R

torch.set_num_threads(1)

FAST = SimConfig(control_freq=100)


def _batched_np(jstate) -> dict:
    """A single-env JAX state as the flat numpy dict of ``convert``, with a
    batch dimension of 1."""
    d = {f: np.array(getattr(jstate.parts, f))[None] for f in PartState._fields}
    for f in jstate._fields:
        if f != "parts":
            d[f] = np.array(getattr(jstate, f))[None]
    return d


def _take(state, i: int):
    """Env ``i`` of a batched state, as a batch of one."""
    return type(state)(*(_take(x, i) if isinstance(x, tuple) else x[i:i + 1] for x in state))


# -- the ray primitives --------------------------------------------------------------


def _rays(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # axis-parallel rays (exact zeros in two components), aimed at the origin
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 512)] * rng.choice([-1, 1], (512, 1))
    d[:512] = axes
    o[:512] = -0.5 * axes + rng.uniform(-0.05, 0.05, (512, 3)).astype(np.float32) * (axes == 0)
    o[512:1024] *= 0.05                      # from inside (or nearly) every primitive
    size = rng.uniform(0.08, 0.3, (n, 3)).astype(np.float32)
    return o, d, size


@pytest.mark.parametrize("prim", ["box", "sphere", "cylinder"])
def test_ray_primitives_match_jax(prim):
    o, d, size = _rays()
    if prim == "box":
        jt, jn = jax.jit(jr._ray_box)(o, d, size)
        tt, tn = R._ray_box(*map(torch.from_numpy, (o, d, size)))
    elif prim == "sphere":
        jt, jn = jax.jit(jr._ray_sphere)(o, d, size[:, 0])
        tt, tn = R._ray_sphere(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(size[:, 0]))
    else:
        jt, jn = jax.jit(jr._ray_cylinder)(o, d, size[:, 0], size[:, 1])
        tt, tn = R._ray_cylinder(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(size[:, 0]), torch.from_numpy(size[:, 1]))
    jt, jn, tt, tn = np.asarray(jt), np.asarray(jn), tt.numpy(), tn.numpy()
    jhit, thit = jt < 1e9, tt < 1e9
    assert np.array_equal(jhit, thit)
    assert 500 < thit.sum() < 4000, thit.sum()          # both hits and misses
    # relative to max(t, 1 m): a ray starting within a millimetre of a
    # surface has t ~ 1e-4, where -b - sqrt(disc) cancels to a few ulps of b
    assert (np.abs(tt - jt)[thit] <= 1e-5 * np.maximum(jt[thit], 1.0)).all()
    assert np.abs(tn[thit] - jn[thit]).max() < 1e-5
    assert thit[:512].any() and not thit[512:1024].all()


# -- whole frames against the JAX package ------------------------------------------------


def _hold_frame(jframe, tframe):
    """``seg`` equal but for <= 0.1% silhouette pixels; rgb and depth within
    1e-4 where seg agrees; depth inf on the background."""
    jrgb, jdepth, jseg = (np.asarray(x) for x in jframe)
    trgb, tdepth, tseg = (x[0].numpy() for x in tframe)
    assert trgb.shape == jrgb.shape and tseg.dtype == np.int32
    diff = jseg != tseg
    assert diff.mean() <= 1e-3, diff.mean()

    def edge(seg):
        p = np.pad(seg, 1, mode="edge")
        c = p[1:-1, 1:-1]
        return ((p[:-2, 1:-1] != c) | (p[2:, 1:-1] != c) | (p[1:-1, :-2] != c)
                | (p[1:-1, 2:] != c))

    assert (edge(jseg) | edge(tseg))[diff].all(), "a pixel off a silhouette edge differs"
    same = ~diff
    assert np.abs(trgb - jrgb)[same].max() < 1e-4
    fin = same & (tseg != SEG_BACKGROUND)
    assert np.abs(tdepth[fin] - jdepth[fin]).max() < 1e-4
    assert np.isinf(tdepth[tseg == SEG_BACKGROUND]).all()


@pytest.fixture(scope="module")
def cursor_frames():
    """One JAX table_lack cursor reset rendered by both packages at
    ``frontview(72, 72)``; the port's env and state come along."""
    jenv = JCursorEnv(JEnvConfig(furniture_name="table_lack_0825"))
    jstate = jenv.reset(jax.random.PRNGKey(0))
    jframe = jax.jit(jmake_render_fn(jenv, jfrontview(72, 72)))(jstate)
    tenv = CursorEnv(EnvConfig(furniture_name="table_lack_0825"), device="cpu")
    tstate = cursor_state_from_numpy(_batched_np(jstate), "cpu")
    tframe = make_render_fn(tenv, frontview(72, 72))(tstate)
    return jframe, tframe, tenv, tstate


@pytest.fixture(scope="module")
def sawyer_frames():
    jenv = JArmEnv(JEnvConfig(agent_type="Sawyer", control_type="impedance"))
    jstate = jenv.reset(jax.random.PRNGKey(0))
    # the camera of tests/test_render.py:125-131: 64 x 64, the robot base from the front
    jcam = JCamera(pos=jnp.array([0.0, -1.2, 0.9]),
                   quat=JT.quat_normalize(jnp.array([0.86, 0.51, 0.0, 0.0])),
                   fovy=60.0, width=64, height=64)
    jframe = jax.jit(jmake_render_fn(jenv, jcam))(jstate)
    tenv = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device="cpu")
    tstate = arm_state_from_numpy(_batched_np(jstate), "cpu")
    tcam = Camera(pos=torch.tensor([0.0, -1.2, 0.9]),
                  quat=R.T.quat_normalize(torch.tensor([0.86, 0.51, 0.0, 0.0])),
                  fovy=60.0, width=64, height=64)
    tframe = make_render_fn(tenv, tcam)(tstate)
    return jframe, tframe, tenv


def test_cursor_frame_matches_jax(cursor_frames):
    jframe, tframe, _, _ = cursor_frames
    _hold_frame(jframe, tframe)


def test_sawyer_frame_matches_jax(sawyer_frames):
    jframe, tframe, _ = sawyer_frames
    _hold_frame(jframe, tframe)


# -- the chunked path against the generic one --------------------------------------------


def _rotated_scene():
    """Six rotated geoms of all three types (``tests/test_render.py:90-104``),
    and a second frame with the same geoms moved."""
    rng = np.random.RandomState(3)
    n = 6
    quat = rng.randn(n, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = rng.uniform(-0.3, 0.3, (n, 3)) + np.array([0, 0, 0.3])
    pos = np.stack([pos, pos + rng.uniform(-0.1, 0.1, (n, 3))])
    types = [BOX, BOX, SPHERE, CYLINDER, BOX, CYLINDER]
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    scene = GeomScene(
        pos=f32(pos),
        quat=f32(quat).expand(2, n, 4),
        type=torch.tensor(types, dtype=torch.int32).expand(2, n),
        size=f32(rng.uniform(0.05, 0.15, (n, 3))).expand(2, n, 3),
        seg=torch.arange(n, dtype=torch.int32).expand(2, n),
        rgba=f32(rng.uniform(0.2, 0.9, (n, 3))).expand(2, n, 3),
    )
    return scene, tuple(types)


def test_chunked_matches_generic_for_rotated_geoms():
    scene, types = _rotated_scene()
    cam = frontview(56, 56)
    rgb_g, d_g, seg_g = render(scene, cam)
    rgb_c, d_c, seg_c = render(scene, cam, static_types=types)
    assert torch.equal(seg_g, seg_c)
    assert (rgb_g - rgb_c).abs().max().item() < 1e-5
    assert len(torch.unique(seg_c)) >= 5


def test_chunked_matches_generic_on_env_scenes(cursor_frames, sawyer_frames):
    """``make_render_fn``'s chunked frames against the generic path on the
    scenes it draws (the table_lack cursor and Sawyer)."""
    _, _, cenv, cstate = cursor_frames
    sawyer_env = sawyer_frames[2]
    sstate = sawyer_env.reset_batch(2, torch.Generator().manual_seed(0))
    for env, state in ((cenv, cstate), (sawyer_env, sstate)):
        cam = frontview(48, 48)
        rf = make_render_fn(env, cam)
        rgb_c, _, seg_c = rf(state)
        rgb_g, _, seg_g = render(rf.scene(state), cam)
        assert torch.equal(seg_c, seg_g)
        assert (rgb_c - rgb_g).abs().max().item() < 1e-5


# -- mirrors of tests/test_render.py ---------------------------------------------------------


def test_shapes_and_ranges(cursor_frames):
    rgb, depth, seg = (x[0].numpy() for x in cursor_frames[1])
    assert rgb.shape == (72, 72, 3) and seg.shape == (72, 72)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0
    assert np.isfinite(depth[seg != SEG_BACKGROUND]).all()
    assert np.isinf(depth[seg == SEG_BACKGROUND]).all()


def test_segmentation_ids(cursor_frames):
    _, _, seg = (x[0].numpy() for x in cursor_frames[1])
    ids = set(np.unique(seg).tolist())
    assert SEG_FLOOR in ids and SEG_BACKGROUND in ids
    parts_visible = [i for i in ids if i >= 0]
    assert len(parts_visible) >= 2
    assert max(parts_visible) < cursor_frames[2].model.n_parts + 2   # parts + cursors


def test_depth_orders_floor_behind_parts(cursor_frames):
    _, depth, seg = (x[0].numpy() for x in cursor_frames[1])
    part_px, floor_px = seg >= 0, seg == SEG_FLOOR
    assert part_px.any() and floor_px.any()
    assert np.median(depth[part_px]) < depth[floor_px].max()


def test_moving_part_changes_image(cursor_frames):
    _, _, tenv, tstate = cursor_frames
    rf = make_render_fn(tenv, frontview(64, 64))
    seg0 = rf(tstate)[2]
    lifted = tstate._replace(parts=tstate.parts._replace(
        pos=tstate.parts.pos + torch.tensor([0.0, 0.0, 0.4])))
    assert not torch.equal(seg0, rf(lifted)[2])


def test_batch():
    env = CursorEnv(EnvConfig(sim=FAST), device="cpu")
    states = env.reset_batch(3, torch.Generator().manual_seed(2))
    rgb, depth, seg = make_render_fn(env, frontview(48, 48))(states)
    assert rgb.shape == (3, 48, 48, 3) and depth.shape == seg.shape == (3, 48, 48)
    assert all((seg[i] >= 0).any() for i in range(3))        # each env sees furniture
    one = make_render_fn(env, frontview(48, 48))(_take(states, 1))     # env 1 alone
    assert all(torch.equal(a[1:2], b) for a, b in zip((rgb, depth, seg), one))


def test_to_uint8(cursor_frames):
    img = to_uint8(cursor_frames[1][0])
    assert img.dtype == torch.uint8 and img.max().item() > 40


def test_arm_render_includes_robot(sawyer_frames):
    _, (rgb, depth, seg), tenv = sawyer_frames
    ids = torch.unique(seg)
    assert (ids >= tenv.model.n_parts).any(), "robot body ids visible"
    assert (ids == SEG_FLOOR).any()


def test_wrapper_camera_obs_and_render_modes():
    env = api.make_env("IKEACursor-v0", device="cpu", furniture_name="table_lack_0825",
                       camera_ob=True, depth_ob=True, segmentation_ob=True,
                       screen_width=40, screen_height=40, sim=FAST)
    with pytest.raises(RuntimeError):
        env.render()
    ob = env.reset(seed=0)
    assert ob["camera_ob"].shape == (40, 40, 3)
    assert ob["depth_ob"].shape == (40, 40)
    assert ob["segmentation_ob"].shape == (40, 40) and ob["segmentation_ob"].dtype == np.int32
    assert ob["object_ob"].shape == env.observation_space.spaces["object_ob"].shape
    saved = env.get_env_state()
    ob, rew, done, info = env.step(env.action_space.sample(np.random.RandomState(0)))
    assert ob["camera_ob"].shape == (40, 40, 3) and isinstance(rew, float) and isinstance(done, bool)
    assert np.array_equal(env.render("rgb_array"), ob["camera_ob"])
    assert np.array_equal(env.render("depth_array"), ob["depth_ob"])
    assert np.array_equal(env.render("segmentation"), ob["segmentation_ob"])
    with pytest.raises(ValueError):
        env.render("no_such_mode")
    env.set_env_state(saved)
    again = env.reset(seed=0)
    assert np.array_equal(again["camera_ob"], env.render())


# -- mirrors of tests/test_utils.py ------------------------------------------------------------


def test_video_recorder_fallback(tmp_path):
    from furniture_tpu_torch.utils.video_recorder import VideoRecorder

    vr = VideoRecorder(record_dir=str(tmp_path), fps=5)
    vr.capture_frame(np.zeros((8, 8, 3), np.uint8))
    vr.capture_frame(torch.full((8, 8, 3), 255, dtype=torch.uint8))
    vr.capture_frame(torch.full((8, 8, 3), 0.5))
    vr.capture_frame(to_uint8(torch.ones(8, 8, 3)))
    out = vr.close("clip")
    assert out is not None and tmp_path.joinpath(out).exists()
    assert len(vr) == 0                                       # buffer cleared
    if out.endswith(".npz"):
        frames = np.load(out)["frames"]
        assert frames.shape == (4, 8, 8, 3) and frames.dtype == np.uint8
        assert frames[1].min() == 255 and frames[2].max() == 127


def test_info():
    from furniture_tpu_torch.utils.info_dict import Info

    info = Info()
    info.add({"x": 1.0, "y": torch.tensor(2.0), "h": [1, 2], "img": np.zeros(2)})
    info.add({"x": 3.0, "y": torch.tensor(4.0), "h": [6]})
    assert info["h"] == [1, 2, 6]
    out = info.get_dict()
    assert out["x"] == 2.0 and out["y"] == 3.0 and out["h"] == 3.0
    assert len(out["img"]) == 1 and "x" not in info
    info.add({"x": 1.0})
    assert info.get_dict(reduction="sum", only_scalar=True) == {"x": 1.0}
