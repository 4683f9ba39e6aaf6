"""Batched ray-casting renderer: rgb, depth and segmentation camera
observations on the env's device.

The port's counterpart of ``furniture_tpu.render.raycast``. The reference
takes its camera observations from the Unity renderer over TCP or from
mujoco-py's OpenGL context; the JAX package casts one ray a pixel against
the analytic collision primitives (box, sphere, capped cylinder, floor
plane) of the compiled geom tables the physics uses. This module does the
same in plain PyTorch for a batch of envs at once: scene leaves are
``[B,G,...]`` and images ``[B,H,W,...]``.

Two paths, as in the JAX package. The typed chunked path (``static_types``
given: the per-geom type codes, compile-time data of a model) partitions
the geoms by primitive type once and intersects ``chunk`` geoms of a type
at a time against every pixel; it is the path :func:`make_renderer` and
``make_render_fn`` run, and makes no host synchronisation. The generic path
(``static_types=None``) runs all three tests for one geom at a time and
selects by type; it is the plain reference the tests hold the chunked path
against. Both compute a ray's frame change and each test with the same
elementwise operations, so on one device they agree bit for bit up to ties
between geoms at equal depth. The nearest hit of a chunk is ``argmin`` plus
``gather`` (the first minimum on ties, as ``jnp.argmin``).

Conventions are the reference's: the camera frame is MuJoCo's (looks along
-Z, +X right, +Y up), ``fovy`` is the vertical field of view in degrees, the
default camera is the floor arena's ``frontview``. Segmentation ids: part
index 0..P-1, ``SEG_FLOOR`` for the ground plane, ``SEG_BACKGROUND`` for no
hit; other geoms (cursor boxes, robot links) carry the ids their scene
gives them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T
from ..models.compiler import BOX, CYLINDER, SPHERE

SEG_BACKGROUND = -1
SEG_FLOOR = -2

_FAR = 1e9


class Camera(NamedTuple):
    """A fixed pinhole camera in MuJoCo convention."""

    pos: torch.Tensor    # [3] world position
    quat: torch.Tensor   # [4] wxyz world orientation (the camera looks along -Z)
    fovy: float          # vertical field of view, degrees
    width: int
    height: int

    def to(self, device) -> "Camera":
        return self._replace(pos=self.pos.to(device), quat=self.quat.to(device))


def frontview(width: int = 500, height: int = 500) -> Camera:
    """The reference's default ``frontview`` camera
    (``floor_arena.xml:16``: pos (0, -1.2, 0.9), quat (0.86, 0.51, 0, 0)
    wxyz, fovy 60; 500x500 by default, ``config/furniture.py:273-276``), on
    the CPU; a renderer moves it to its device."""
    return Camera(
        pos=torch.tensor([0.0, -1.2, 0.9]),
        quat=T.quat_normalize(torch.tensor([0.86, 0.51, 0.0, 0.0])),
        fovy=60.0,
        width=width,
        height=height,
    )


class GeomScene(NamedTuple):
    """World-space primitives of a batch of frames, every leaf ``[B,G,...]``."""

    pos: torch.Tensor    # [B,G,3]
    quat: torch.Tensor   # [B,G,4] wxyz
    type: torch.Tensor   # [B,G] BOX | SPHERE | CYLINDER
    size: torch.Tensor   # [B,G,3]
    seg: torch.Tensor    # [B,G] int32 segmentation id
    rgba: torch.Tensor   # [B,G,3] albedo


def part_palette(n: int, device=None) -> torch.Tensor:
    """Deterministic distinct albedos (golden-ratio hue walk), [n,3]."""
    h = (np.arange(n) * 0.61803398875) % 1.0
    c, x = 0.75, 0.75 * (1 - np.abs((h * 6) % 2 - 1))
    k = (h * 6).astype(int) % 6
    one, zero = c * np.ones(n), np.zeros(n)
    rgb = np.choose(
        k[:, None],
        np.array([
            np.stack([one, x, zero], -1),
            np.stack([x, one, zero], -1),
            np.stack([zero, one, x], -1),
            np.stack([zero, x, one], -1),
            np.stack([x, zero, one], -1),
            np.stack([one, zero, x], -1),
        ]),
    )
    return torch.as_tensor(rgb + 0.2, dtype=torch.float32, device=device)


def part_scene(tables: dict, parts, albedo: torch.Tensor | None = None) -> GeomScene:
    """World poses of every furniture collision geom of a batch of
    ``PartState``s (geom-local frames composed with part poses, as the
    physics does). ``tables`` holds ``geom_part``, ``geom_pos``,
    ``geom_quat``, ``geom_type`` and ``geom_size``, as numpy arrays or, to
    make no host copy, as tensors on the parts' device; ``albedo`` is
    ``[G,3]``."""
    dev = parts.pos.device
    gpart = torch.as_tensor(tables["geom_part"], device=dev).long()
    gpos_l = torch.as_tensor(tables["geom_pos"], dtype=torch.float32, device=dev)
    gquat_l = torch.as_tensor(tables["geom_quat"], dtype=torch.float32, device=dev)
    ppos, pquat = parts.pos[:, gpart], parts.quat[:, gpart]
    pos = ppos + T.quat_rotate(pquat, gpos_l)
    quat = T.quat_mul(pquat, gquat_l)
    B, G = pos.shape[:2]
    if albedo is None:
        albedo = part_palette(int(parts.pos.shape[1]), dev)[gpart]
    return GeomScene(
        pos=pos,
        quat=quat,
        type=torch.as_tensor(tables["geom_type"], device=dev).to(torch.int32).expand(B, G),
        size=torch.as_tensor(tables["geom_size"], dtype=torch.float32, device=dev).expand(B, G, 3),
        seg=gpart.to(torch.int32).expand(B, G),
        rgba=albedo.expand(B, G, 3),
    )


def box_scene(pos, size, seg_ids, rgba=None, quat=None) -> GeomScene:
    """Boxes at ``pos`` [B,n,3] as a scene (cursors, markers): ``size`` [3]
    or [n,3] half-extents, ``seg_ids`` [n], ``rgba`` [n,3] (yellow by
    default), ``quat`` [B,n,4] (identity by default)."""
    B, n = pos.shape[:2]
    dev = pos.device
    if quat is None:
        quat = T.quat_identity((B, n), device=dev)
    if rgba is None:
        rgba = torch.tensor([0.9, 0.9, 0.2], device=dev)
    return GeomScene(
        pos=pos,
        quat=quat,
        type=torch.full((B, n), BOX, dtype=torch.int32, device=dev),
        size=torch.as_tensor(size, dtype=torch.float32, device=dev).expand(B, n, 3),
        seg=torch.as_tensor(seg_ids, dtype=torch.int32, device=dev).expand(B, n),
        rgba=torch.as_tensor(rgba, dtype=torch.float32, device=dev).expand(B, n, 3),
    )


def merge_scenes(*scenes: GeomScene) -> GeomScene:
    """The scenes' geoms side by side (along G)."""
    return GeomScene(*(torch.cat(f, dim=1) for f in zip(*scenes)))


def _vec_mat(v, m):
    """``v @ m`` for rows ``v`` [...,3] and matrices ``m`` [...,3,3]
    (broadcast), as elementwise products and sums: the same operations for
    every element whatever the shapes, so the two paths agree bit for bit."""
    return v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :] + v[..., 2:3] * m[..., 2, :]


def _camera_rays(camera: Camera) -> torch.Tensor:
    """Per-pixel world-space ray directions [H*W,3], row-major from the top
    left (the image layout of ``sim.render``)."""
    h, w = camera.height, camera.width
    dev = camera.pos.device
    tan_half = float(np.tan(np.radians(camera.fovy) / 2.0))
    aspect = w / h
    # pixel centers; +y is up in the camera frame, so rows flip
    ys = (0.5 - (torch.arange(h, device=dev) + 0.5) / h) * 2.0 * tan_half
    xs = ((torch.arange(w, device=dev) + 0.5) / w - 0.5) * 2.0 * tan_half * aspect
    dirs = torch.stack(
        [xs[None, :].expand(h, w), ys[:, None].expand(h, w), torch.full((h, w), -1.0, device=dev)],
        dim=-1,
    ).reshape(-1, 3)
    return T.unit(_vec_mat(dirs, T.quat_to_mat(camera.quat).T))


def _ray_box(o, d, half):
    """Slab test in the geom frame: (t [...], normal [...,3] in the geom
    frame); a miss gives t = 1e9. ``o``/``d`` [...,3], ``half``
    broadcastable to them."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    tn = tmin.amax(-1)
    tf = tmax.amin(-1)
    hit = (tn <= tf) & (tf > 0.0) & (tn > 0.0)
    axis = tmin.argmax(-1, keepdim=True)
    d_ax = torch.gather(d.expand(tmin.shape), -1, axis)
    one_hot = (axis == torch.arange(3, device=d.device)).to(d.dtype)
    return torch.where(hit, tn, _FAR), -torch.sign(d_ax) * one_hot


def _ray_sphere(o, d, r):
    """Sphere of radius ``r`` at the geom origin: (t, normal)."""
    b = torch.sum(o * d, -1)
    c = torch.sum(o * o, -1) - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    hit = (disc > 0.0) & (t > 0.0)
    p = o + t[..., None] * d
    return torch.where(hit, t, _FAR), T.unit(p)


def _ray_cylinder(o, d, r, hh):
    """Z-aligned capped cylinder in the geom frame (MuJoCo size = (r,
    half-length)): (t, normal). ``o``/``d`` [...,3], ``r``/``hh``
    broadcastable to [...]."""
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a < 1e-12, 1e-12, a)
    t_side = (-b - sq) / a_safe
    z = o[..., 2] + t_side * d[..., 2]
    side_ok = (disc > 0.0) & (t_side > 0.0) & (z.abs() <= hh) & (a > 1e-12)
    t_side = torch.where(side_ok, t_side, _FAR)
    # the cap facing the ray
    dz = torch.where(d[..., 2].abs() < 1e-12, 1e-12, d[..., 2])
    cap_sign = torch.where(d[..., 2] < 0, 1.0, -1.0)
    t_cap = (cap_sign * hh - o[..., 2]) / dz
    xc = o[..., 0] + t_cap * d[..., 0]
    yc = o[..., 1] + t_cap * d[..., 1]
    cap_ok = (t_cap > 0.0) & (xc * xc + yc * yc <= r * r)
    t_cap = torch.where(cap_ok, t_cap, _FAR)
    use_cap = t_cap < t_side
    t = torch.minimum(t_side, t_cap)
    p = o + t[..., None] * d
    zs = torch.zeros_like(t)
    n_side = T.unit(torch.stack([p[..., 0], p[..., 1], zs], -1))
    n_cap = torch.stack([zs, zs, cap_sign.expand_as(t)], -1)
    return t, torch.where(use_cap[..., None], n_cap, n_side)


def _fill3(values, device) -> torch.Tensor:
    """A [3] float32 constant made on ``device`` by fills (no host copy)."""
    return torch.stack([torch.full((), float(v), device=device) for v in values])


def make_renderer(
    camera: Camera,
    device=None,
    light_dir=(-0.35, 0.25, -0.9),
    floor_z: float = 0.0,
    floor_rgb=(0.58, 0.56, 0.54),
    sky_rgb=(0.76, 0.84, 0.92),
    static_types: tuple | None = None,
    chunk: int = 8,
):
    """``scene -> (rgb [B,H,W,3] float32 in [0,1], depth [B,H,W] float32
    meters along the ray (inf where nothing is hit), seg [B,H,W] int32)``
    for ``camera`` on ``device``. The rays, constants and the typed chunks of
    ``static_types`` (a host tuple of per-geom type codes) are made here,
    once, so a call makes no host copy and no host synchronisation."""
    dev = torch.device(device) if device is not None else camera.pos.device
    cam = camera.to(dev)
    o_w = cam.pos
    d_w = _camera_rays(cam)                                   # [N,3]
    ldir = T.unit(_fill3(light_dir, dev))
    floor_rgb, sky_rgb = _fill3(floor_rgb, dev), _fill3(sky_rgb, dev)
    up = _fill3((0.0, 0.0, 1.0), dev)
    h, w = cam.height, cam.width
    if static_types is not None:
        types = np.asarray(static_types)
        # the geoms sorted by type: each chunk is a slice of the sorted scene
        order = np.concatenate([np.flatnonzero(types == c) for c in (BOX, SPHERE, CYLINDER)])
        if len(order) != len(types):
            raise ValueError(f"static_types has codes other than BOX, SPHERE, CYLINDER: {static_types}")
        order_t = torch.as_tensor(order, device=dev)
        chunks, lo = [], 0
        for code in (BOX, SPHERE, CYLINDER):
            n = int((types == code).sum())
            chunks += [(code, s, min(s + chunk, lo + n)) for s in range(lo, lo + n, chunk)]
            lo += n

    def chunked(scene: GeomScene):
        """(t [B,N], geom normal [B,N,3] in the world, seg, albedo) of the
        nearest geom hit, over typed chunks of the sorted scene."""
        if scene.pos.shape[1] != len(order):
            raise ValueError(f"the scene has {scene.pos.shape[1]} geoms, static_types {len(order)}")
        s = GeomScene(*(x[:, order_t] for x in scene))
        B, G = s.pos.shape[:2]
        rot_all = T.quat_to_mat(s.quat)                       # [B,G,3,3]
        o_all = _vec_mat(o_w - s.pos, rot_all)                # the camera in each geom's frame
        n_pix = d_w.shape[0]
        t = torch.full((B, n_pix), _FAR, device=dev)
        g = torch.zeros((B, n_pix), dtype=torch.long, device=dev)
        n_geom = torch.zeros((B, n_pix, 3), device=dev)
        for code, a, b in chunks:
            rot = rot_all[:, a:b]                                             # [B,CH,3,3]
            d = _vec_mat(d_w[None, :, None, :], rot[:, None])                 # [B,N,CH,3]
            o = o_all[:, None, a:b]                                           # [B,1,CH,3]
            sz = s.size[:, None, a:b]                                         # [B,1,CH,3]
            if code == BOX:
                tg, ng = _ray_box(o, d, sz)
            elif code == SPHERE:
                tg, ng = _ray_sphere(o, d, sz[..., 0])
            else:
                tg, ng = _ray_cylinder(o, d, sz[..., 0], sz[..., 1])
            tg = torch.where(torch.isnan(tg), _FAR, tg)
            i = tg.argmin(-1, keepdim=True)                                   # [B,N,1]
            tc = torch.gather(tg, -1, i)[..., 0]
            ng = torch.gather(ng, -2, i[..., None].expand(B, n_pix, 1, 3))[..., 0, :]
            closer = tc < t
            t = torch.where(closer, tc, t)
            g = torch.where(closer, a + i[..., 0], g)
            n_geom = torch.where(closer[..., None], ng, n_geom)
        # the winner's frame, id and albedo, gathered once
        rot_g = torch.gather(rot_all.reshape(B, G, 9), 1, g[..., None].expand(-1, -1, 9))
        normal = _vec_mat(n_geom, rot_g.reshape(B, -1, 3, 3).transpose(-1, -2))
        hit = t < _FAR
        seg = torch.where(hit, torch.gather(s.seg, 1, g), SEG_BACKGROUND)
        albedo = torch.gather(s.rgba, 1, g[..., None].expand(-1, -1, 3))
        return t, normal, seg, albedo

    def generic(scene: GeomScene):
        """The same, one geom at a time with all three tests, selected by
        type (the plain reference)."""
        B, G = scene.pos.shape[:2]
        n_pix = d_w.shape[0]
        t_best = torch.full((B, n_pix), _FAR, device=dev)
        seg_best = torch.full((B, n_pix), SEG_BACKGROUND, dtype=torch.int32, device=dev)
        n_best = torch.zeros((B, n_pix, 3), device=dev)
        alb_best = torch.zeros((B, n_pix, 3), device=dev)
        rot_all = T.quat_to_mat(scene.quat)
        for gi in range(G):
            rot = rot_all[:, gi]                                              # [B,3,3]
            o = _vec_mat((o_w - scene.pos[:, gi])[:, None, :], rot[:, None])  # [B,1,3]
            d = _vec_mat(d_w[None], rot[:, None])                             # [B,N,3]
            sz = scene.size[:, gi, None]                                      # [B,1,3]
            tb, nb = _ray_box(o, d, sz)
            ts, ns = _ray_sphere(o, d, sz[..., 0])
            tc, nc = _ray_cylinder(o, d, sz[..., 0], sz[..., 1])
            gtype = scene.type[:, gi, None]                                   # [B,1]
            t = torch.where(gtype == BOX, tb, torch.where(gtype == SPHERE, ts, tc))
            n = torch.where((gtype == BOX)[..., None], nb,
                            torch.where((gtype == SPHERE)[..., None], ns, nc))
            n_world = _vec_mat(n, rot[:, None].transpose(-1, -2))
            closer = t < t_best
            t_best = torch.where(closer, t, t_best)
            seg_best = torch.where(closer, scene.seg[:, gi, None], seg_best)
            n_best = torch.where(closer[..., None], n_world, n_best)
            alb_best = torch.where(closer[..., None], scene.rgba[:, gi, None], alb_best)
        return t_best, n_best, seg_best, alb_best

    # the floor plane z = floor_z, with a checker pattern for depth cues
    dz = torch.where(d_w[:, 2].abs() < 1e-12, -1e-12, d_w[:, 2])
    t_floor = (floor_z - o_w[2]) / dz                                         # [N]
    fp = o_w[None, :2] + t_floor[:, None] * d_w[:, :2]
    checker = ((torch.floor(fp[:, 0] * 4) + torch.floor(fp[:, 1] * 4)) % 2) * 0.06
    floor_albedo = floor_rgb + checker[:, None]

    def draw(scene: GeomScene):
        t, normal, seg, albedo = (chunked if static_types is not None else generic)(scene)
        B = t.shape[0]
        floor_hit = (t_floor > 0.0) & (t_floor < t)
        t = torch.where(floor_hit, t_floor, t)
        seg = torch.where(floor_hit, SEG_FLOOR, seg).to(torch.int32)
        normal = torch.where(floor_hit[..., None], up, normal)
        albedo = torch.where(floor_hit[..., None], floor_albedo, albedo)
        hit = seg != SEG_BACKGROUND
        lambert = torch.clamp(torch.sum(normal * (-ldir), -1), 0.0, 1.0)
        headlight = torch.clamp(torch.sum(normal * (-d_w), -1), 0.0, 1.0)
        shade = 0.30 + 0.45 * lambert + 0.25 * headlight
        rgb = torch.where(hit[..., None], albedo * shade[..., None], sky_rgb)
        depth = torch.where(hit, t, torch.inf)
        return (torch.clamp(rgb, 0.0, 1.0).reshape(B, h, w, 3), depth.reshape(B, h, w),
                seg.reshape(B, h, w))

    return draw


def render(scene: GeomScene, camera: Camera, light_dir=(-0.35, 0.25, -0.9), floor_z: float = 0.0,
           floor_rgb=(0.58, 0.56, 0.54), sky_rgb=(0.76, 0.84, 0.92),
           static_types: tuple | None = None, chunk: int = 8):
    """Cast one ray a pixel against ``scene``: ``(rgb [B,H,W,3], depth
    [B,H,W], seg [B,H,W] int32)``. A one-shot :func:`make_renderer` on the
    scene's device; build the renderer once to render many frames."""
    return make_renderer(camera, scene.pos.device, light_dir, floor_z, floor_rgb, sky_rgb,
                         static_types, chunk)(scene)


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """Colors in [0,1] as 8-bit, rounded."""
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
