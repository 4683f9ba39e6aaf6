"""Camera observations (rgb, depth, segmentation) on the env's device.

The port's counterpart of ``furniture_tpu.render``: a ray-casting renderer
over the compiled geom tables the physics uses (``raycast``), and
:func:`make_render_fn`, the batched ``state -> (rgb, depth, seg)`` of a
cursor or arm env. It is plain PyTorch (the JAX package's renderer is XLA,
not a Pallas kernel), so frames stay on the device with the env state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.compiler import BOX
from .raycast import (
    SEG_BACKGROUND,
    SEG_FLOOR,
    Camera,
    GeomScene,
    box_scene,
    frontview,
    make_renderer,
    merge_scenes,
    part_palette,
    part_scene,
    render,
    to_uint8,
)

__all__ = [
    "Camera",
    "GeomScene",
    "SEG_BACKGROUND",
    "SEG_FLOOR",
    "box_scene",
    "frontview",
    "make_render_fn",
    "make_renderer",
    "merge_scenes",
    "part_palette",
    "part_scene",
    "render",
    "to_uint8",
]

_CURSOR_HALF = 0.015  # cursor box visual half-size (robots/cursor/robot.xml)
_GEOM_KEYS = ("geom_part", "geom_pos", "geom_quat", "geom_type", "geom_size")


def make_render_fn(env, camera: Camera | None = None):
    """The batched ``state -> (rgb [B,H,W,3] float32, depth [B,H,W] float32,
    seg [B,H,W] int32)`` of a cursor or arm env (the reference's
    ``render()`` camera path, ``env/furniture.py:586-668``), on the env's
    device with ``camera`` (``frontview()`` by default) on the typed chunked
    path; tables and constants are copied to the device here, once.

    Segmentation ids: furniture parts 0..P-1; the two cursors ``P`` and
    ``P+1``, or robot geoms ``P + geom_body`` (all drawn as boxes of the
    robot's collision sizes, as the JAX package draws them); the floor
    ``SEG_FLOOR``, nothing ``SEG_BACKGROUND``.

    The function's ``scene(state)`` is the :class:`GeomScene` it draws and
    its ``static_types`` the type codes of that scene's geoms, for holding
    the chunked path against ``render(scene, camera)``'s generic one.
    """
    dev = env.device
    cam = camera or frontview()
    tables = {k: torch.as_tensor(np.asarray(env.tables[k]), device=dev) for k in _GEOM_KEYS}
    types = tuple(np.asarray(env.tables["geom_type"]).tolist())
    P = int(env.model.n_parts)
    albedo = part_palette(P + 8, dev)[tables["geom_part"].long()]

    if not hasattr(env, "robot"):
        types += (BOX, BOX)
        size = torch.full((3,), _CURSOR_HALF, device=dev)
        seg = torch.tensor([P, P + 1], dtype=torch.int32, device=dev)
        rgba = torch.tensor([[0.15, 0.9, 0.9], [0.9, 0.25, 0.9]], device=dev)

        def scene_of(state):
            parts = part_scene(tables, state.parts, albedo)
            return merge_scenes(parts, box_scene(state.cursor_pos, size, seg, rgba=rgba))
    else:
        from ..robots import kinematics as K

        r = env.robot
        ng = len(r.geom_body)
        types += (BOX,) * ng
        robot_seg = torch.as_tensor(P + np.asarray(r.geom_body), dtype=torch.int32, device=dev)
        robot_rgba = torch.tensor([0.55, 0.57, 0.62], device=dev).expand(ng, 3)
        robot_size = torch.as_tensor(np.asarray(r.geom_size), dtype=torch.float32, device=dev)

        def scene_of(state):
            parts = part_scene(tables, state.parts, albedo)
            gpos, gquat = K.geom_world(r, K.fk(r, state.qpos))
            B = gpos.shape[0]
            robot = GeomScene(
                pos=gpos,
                quat=gquat,
                type=torch.full((B, ng), BOX, dtype=torch.int32, device=dev),
                size=robot_size.expand(B, ng, 3),
                seg=robot_seg.expand(B, ng),
                rgba=robot_rgba.expand(B, ng, 3),
            )
            return merge_scenes(parts, robot)

    draw = make_renderer(cam, dev, static_types=types)

    def render_state(state):
        return draw(scene_of(state))

    render_state.scene = scene_of
    render_state.static_types = types
    return render_state
