"""Model compiler: JSON asset specs → static padded arrays (``CompiledModel``).

This replaces the reference's MJCF merge machinery + MuJoCo model compile
(``furniture/env/models/base.py:76-129`` ``MujocoXML.merge/get_model``) with a
TPU-first design: the furniture model becomes a *static array description*
that a jitted, vmapped step function closes over. Nothing here runs per-step;
it runs once on the host at env construction.

This is the port's own copy of ``furniture_tpu.models.compiler`` (numpy
only); it reads the same JSON assets in place.

Array groups:

* parts      — free rigid bodies (one per furniture part), with composite
               mass properties derived from their collision prims
* geoms      — collision primitives (box / sphere / cylinder), body-frame
* sites      — every site (used for bounding boxes, reference
               ``env/furniture.py:749-762``), plus typed views:
               connector sites with parsed pair-groups and allowed angles
               (naming convention ``"groupA-groupB,a1,...,conn_siteN"``,
               see ``objects/table_lack_0825.xml`` and
               ``env/furniture.py:978-988``)
* welds      — equality weld rows (``<equality><weld>``), with a dense
               part-pair → weld-index lookup
* recipe     — assembly order compiled to conn-site index pairs + angles
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import ASSET_DIR  # noqa: F401  (circular-safe: ASSET_DIR defined first)

# geom type codes
BOX, SPHERE, CYLINDER = 0, 1, 2
_GEOM_CODE = {"box": BOX, "sphere": SPHERE, "cylinder": CYLINDER}

MAX_ANGLES = 6  # max allowed-angle entries per conn site (reference max is 4)


def load_spec(kind: str, name: str) -> dict:
    path = ASSET_DIR / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def _geom_mass_inertia(g: dict) -> tuple[float, np.ndarray]:
    """Mass and body-frame inertia (diag, about geom center) of a prim."""
    t = g["type"]
    size = g["size"]
    density = g["density"]
    if t == "box":
        a, b, c = size[0], size[1], size[2]
        m = density * 8.0 * a * b * c
        inertia = m / 3.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    elif t == "sphere":
        r = size[0]
        m = density * 4.0 / 3.0 * math.pi * r ** 3
        inertia = 0.4 * m * r * r * np.ones(3)
    elif t == "cylinder":
        r, h = size[0], size[1]  # radius, half-height
        m = density * math.pi * r * r * 2.0 * h
        ixy = m * (3 * r * r + 4 * h * h) / 12.0
        inertia = np.array([ixy, ixy, 0.5 * m * r * r])
    else:  # mesh/visual prims carry no collision mass in our build
        return 0.0, np.zeros(3)
    if g.get("mass") is not None:
        scale = g["mass"] / max(m, 1e-12)
        m = g["mass"]
        inertia = inertia * scale
    return m, inertia


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _is_collision_geom(g: dict) -> bool:
    """Collision prims: the reference enables contype=1 for object geoms whose
    name contains "collision" at reset (``env/furniture.py:1459-1464``) and
    mesh geoms are visual-only (contype=0)."""
    if g["type"] == "mesh":
        return False
    name = g.get("name") or ""
    return ("collision" in name) or (g["contype"] != 0)


@dataclass(frozen=True)
class CompiledModel:
    """Static, host-built description of one furniture model (+ floor)."""

    name: str
    part_names: tuple[str, ...]

    # parts [P]
    part_init_pos: np.ndarray      # [P,3] XML init pose (<custom> initpos,
    part_init_quat: np.ndarray     # [P,4]  fallback body pos) — placement anchor
    part_mass: np.ndarray          # [P]
    part_com: np.ndarray           # [P,3] body-frame center of mass
    part_inertia: np.ndarray       # [P,3,3] body-frame inertia about COM
    part_horiz_radius: np.ndarray  # [P] placement-sampler footprint radius

    # collision geoms [G]
    geom_part: np.ndarray          # [G] owning part index
    geom_type: np.ndarray          # [G] BOX/SPHERE/CYLINDER
    geom_size: np.ndarray          # [G,3]
    geom_pos: np.ndarray           # [G,3]
    geom_quat: np.ndarray          # [G,4]
    geom_friction: np.ndarray      # [G]
    geom_solref: np.ndarray        # [G,2]

    # all sites [S] (bounding boxes; reference env/furniture.py:749-762)
    site_names: tuple[str, ...]
    site_part: np.ndarray          # [S]
    site_pos: np.ndarray           # [S,3]

    # connector sites [C]
    conn_names: tuple[str, ...]
    conn_part: np.ndarray          # [C] owning part
    conn_pos: np.ndarray           # [C,3] body-frame position
    conn_pair_a: np.ndarray        # [C] int id of first group token
    conn_pair_b: np.ndarray        # [C] int id of second group token
    conn_angles: np.ndarray        # [C,MAX_ANGLES] degrees
    conn_angle_mask: np.ndarray    # [C,MAX_ANGLES] bool
    conn_has_angles: np.ndarray    # [C] bool (False -> free-angle connector)

    # welds [W]
    weld_part1: np.ndarray         # [W]
    weld_part2: np.ndarray         # [W]
    weld_lookup: np.ndarray        # [P,P] -> weld index or -1

    # recipe (may be empty)
    recipe_site1: np.ndarray       # [R] conn-site index
    recipe_site2: np.ndarray       # [R]
    recipe_angle: np.ndarray       # [R] degrees (nan = free)
    num_connects: int              # success criterion (recipe or W)
    recipe_raw: dict = field(default=None, repr=False, hash=False, compare=False)

    @property
    def n_parts(self) -> int:
        return len(self.part_names)

    @property
    def n_conn(self) -> int:
        return len(self.conn_names)

    @property
    def n_welds(self) -> int:
        return len(self.weld_part1)


def scale_spec(spec: dict, s: float) -> dict:
    """Uniformly rescale a furniture spec — geometry, body/site offsets and
    init poses all scale by ``s``; masses/inertias follow automatically since
    they are derived from geom sizes at compile time.

    Reference counterpart: ``MujocoXMLObject(path, resize=factor)`` +
    ``resize_objects`` (``env/furniture.py:1986-1992, 1428-1431``) backed by
    the XML rescaler (``env/xml_adjusting/rescale.py:30-97``), which rewrites
    mesh scales, body/site positions and geom sizes.
    """
    import copy

    spec = copy.deepcopy(spec)
    for b in spec.get("bodies", []):
        b["pos"] = [p * s for p in b["pos"]]
        for g in b.get("geoms", []):
            g["pos"] = [p * s for p in g["pos"]]
            g["size"] = [x * s for x in g["size"]]
            if g.get("fromto"):
                g["fromto"] = [x * s for x in g["fromto"]]
        for site in b.get("sites", []):
            site["pos"] = [p * s for p in site["pos"]]
            if site.get("size"):
                site["size"] = [x * s for x in site["size"]]
    custom = spec.get("custom", {})
    for k, v in list(custom.items()):
        if k.endswith("_initpos") and len(v) == 7:
            custom[k] = [v[0] * s, v[1] * s, v[2] * s] + list(v[3:])
    return spec


def compile_model(furniture_name: str, size_scale: float = 1.0) -> CompiledModel:
    spec = load_spec("furniture", furniture_name)
    if size_scale != 1.0:
        spec = scale_spec(spec, float(size_scale))
    try:
        recipe = load_spec("recipes", furniture_name)
    except FileNotFoundError:
        recipe = None

    bodies = spec["bodies"]
    # top-level bodies are parts; child bodies (rare) are folded into parents
    part_index: dict[str, int] = {}
    parts = []
    for b in bodies:
        if b["parent"] == -1:
            part_index[b["name"]] = len(parts)
            parts.append(b)
    P = len(parts)
    part_names = tuple(b["name"] for b in parts)

    # init poses: <custom> "<i>_<name>_initpos" = pos3 + quat4(wxyz)
    # (reference objects.py:149 get_init_qpos), fallback = XML body pos.
    init_pos = np.array([b["pos"] for b in parts], dtype=np.float64)
    init_quat = np.array([b["quat"] for b in parts], dtype=np.float64)
    for key, data in spec.get("custom", {}).items():
        if key.endswith("_initpos"):
            body_name = key[: -len("_initpos")]
            if body_name in part_index and len(data) == 7:
                i = part_index[body_name]
                init_pos[i] = data[:3]
                init_quat[i] = data[3:]

    # geoms / mass properties
    geom_rows = []
    part_mass = np.zeros(P)
    part_com = np.zeros((P, 3))
    part_inertia = np.zeros((P, 3, 3))
    for b in bodies:
        owner = b["name"] if b["parent"] == -1 else bodies[b["parent"]]["name"]
        while owner not in part_index:
            # walk up to the top-level ancestor (folding child bodies)
            pb = bodies[b["parent"]]
            owner = pb["name"] if pb["parent"] == -1 else bodies[pb["parent"]]["name"]
            b = pb
        pi = part_index[owner]
        for g in b["geoms"]:
            if not _is_collision_geom(g):
                continue
            m, diag = _geom_mass_inertia(g)
            size = (g["size"] + [0.0, 0.0, 0.0])[:3]
            geom_rows.append(
                (
                    pi,
                    _GEOM_CODE.get(g["type"], BOX),
                    size,
                    g["pos"],
                    g["quat"],
                    g["friction"][0],
                    g["solref"],
                )
            )
            part_mass[pi] += m
            part_com[pi] += m * np.asarray(g["pos"])
            R = _quat_to_mat_np(g["quat"])
            I_g = R @ np.diag(diag) @ R.T
            part_inertia[pi] += I_g  # parallel-axis applied after COM known
            # store for parallel-axis pass
            geom_rows[-1] = geom_rows[-1] + (m,)

    # mesh-collision fallback: a few models (e.g. shelf_liden_0922) carry
    # ONLY type="mesh" collision geoms, which have no primitive shape here.
    # The reference's own bounding machinery is the part's
    # top/bottom/horizontal_radius sites (``env/furniture.py:749-762``,
    # ``objects.py:166-184``); synthesize one bounding-box prim per such
    # part from them (SURVEY §7.4's "mesh-bbox approximation").
    parts_with_prims = {r[0] for r in geom_rows}
    for b in parts:
        pi = part_index[b["name"]]
        if pi in parts_with_prims:
            continue
        mesh_gs = [
            g for g in b["geoms"]
            if g["type"] == "mesh" and g["contype"] != 0
        ]
        if not mesh_gs:
            continue
        top = bot = None
        hr = 0.05
        for s in b["sites"]:
            n = s["name"] or ""
            if n.endswith("top_site"):
                top = float(s["pos"][2])
            elif n.endswith("bottom_site"):
                bot = float(s["pos"][2])
            elif "horizontal_radius" in n:
                hr = max(
                    abs(float(s["pos"][0])), abs(float(s["pos"][1])), 1e-3
                )
        if top is None or bot is None:
            top, bot = 0.02, -0.02
        g0 = mesh_gs[0]
        half = [hr, hr, max((top - bot) / 2.0, 1e-3)]
        center = [0.0, 0.0, (top + bot) / 2.0]
        m, diag = _geom_mass_inertia(
            {**g0, "type": "box", "size": half, "pos": center}
        )
        geom_rows.append(
            (pi, BOX, half, center, [1.0, 0.0, 0.0, 0.0],
             g0["friction"][0], g0["solref"], m)
        )
        part_mass[pi] += m
        part_com[pi] += m * np.asarray(center)
        part_inertia[pi] += np.diag(diag)

    part_mass = np.maximum(part_mass, 1e-6)
    part_com = part_com / part_mass[:, None]
    # parallel-axis: shift each geom inertia from its own center to part COM
    for row in geom_rows:
        pi, _, _, gpos, _, _, _, m = row
        d = np.asarray(gpos) - part_com[pi]
        part_inertia[pi] += m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    # floor of inertia for numerical safety
    for pi in range(P):
        tr = np.trace(part_inertia[pi]) / 3.0
        part_inertia[pi] += np.eye(3) * max(1e-7, 1e-3 * tr)

    G = len(geom_rows)
    geom_part = np.array([r[0] for r in geom_rows], dtype=np.int32)
    geom_type = np.array([r[1] for r in geom_rows], dtype=np.int32)
    geom_size = np.array([r[2] for r in geom_rows], dtype=np.float64)
    geom_pos = np.array([r[3] for r in geom_rows], dtype=np.float64)
    geom_quat = np.array([r[4] for r in geom_rows], dtype=np.float64)
    geom_friction = np.array([r[5] for r in geom_rows], dtype=np.float64)
    geom_solref = np.array([r[6] for r in geom_rows], dtype=np.float64)

    # sites
    site_part_l, site_pos_l, site_names_l = [], [], []
    conn_rows = []
    horiz_radius = np.full(P, 0.05)
    pair_vocab: dict[str, int] = {}
    for b in bodies:
        if b["name"] not in part_index:
            continue
        pi = part_index[b["name"]]
        for s in b["sites"]:
            name = s["name"] or ""
            site_part_l.append(pi)
            site_pos_l.append(s["pos"])
            site_names_l.append(name)
            if "conn_site" in name:
                tokens = name.split(",")
                pair = tokens[0].split("-")
                angles = [float(t) for t in tokens[1:-1] if t]
                for p in pair:
                    pair_vocab.setdefault(p, len(pair_vocab))
                conn_rows.append(
                    (name, pi, s["pos"], pair_vocab[pair[0]], pair_vocab[pair[1]], angles)
                )
            elif "horizontal_radius" in name:
                horiz_radius[pi] = s["size"][0]

    S = len(site_part_l)
    site_part = np.array(site_part_l, dtype=np.int32).reshape(S)
    site_pos = np.array(site_pos_l, dtype=np.float64).reshape(S, 3)
    site_names = tuple(site_names_l)

    C = len(conn_rows)
    conn_names = tuple(r[0] for r in conn_rows)
    conn_part = np.array([r[1] for r in conn_rows], dtype=np.int32).reshape(C)
    conn_pos = np.array([r[2] for r in conn_rows], dtype=np.float64).reshape(C, 3)
    conn_pair_a = np.array([r[3] for r in conn_rows], dtype=np.int32).reshape(C)
    conn_pair_b = np.array([r[4] for r in conn_rows], dtype=np.int32).reshape(C)
    conn_angles = np.zeros((C, MAX_ANGLES))
    conn_angle_mask = np.zeros((C, MAX_ANGLES), dtype=bool)
    conn_has_angles = np.zeros(C, dtype=bool)
    for i, r in enumerate(conn_rows):
        angles = r[5][:MAX_ANGLES]
        conn_angles[i, : len(angles)] = angles
        conn_angle_mask[i, : len(angles)] = True
        conn_has_angles[i] = len(angles) > 0

    # welds
    weld_p1, weld_p2 = [], []
    for w in spec.get("equality", []):
        if w["type"] != "weld":
            continue
        if w["body1"] in part_index and w["body2"] in part_index:
            weld_p1.append(part_index[w["body1"]])
            weld_p2.append(part_index[w["body2"]])
    W = len(weld_p1)
    weld_part1 = np.array(weld_p1, dtype=np.int32).reshape(W)
    weld_part2 = np.array(weld_p2, dtype=np.int32).reshape(W)
    weld_lookup = np.full((P, P), -1, dtype=np.int32)
    for i in range(W):
        weld_lookup[weld_part1[i], weld_part2[i]] = i
        weld_lookup[weld_part2[i], weld_part1[i]] = i

    # recipe
    conn_name2id = {n: i for i, n in enumerate(conn_names)}
    rs1, rs2, rang = [], [], []
    if recipe is not None:
        for entry in recipe.get("site_recipe", []):
            s1, s2 = entry[0], entry[1]
            if s1 in conn_name2id and s2 in conn_name2id:
                rs1.append(conn_name2id[s1])
                rs2.append(conn_name2id[s2])
                rang.append(float(entry[2]) if len(entry) > 2 else np.nan)
    R = len(rs1)
    num_connects = recipe["num_connects"] if recipe and "num_connects" in recipe else W

    return CompiledModel(
        name=furniture_name,
        part_names=part_names,
        part_init_pos=init_pos,
        part_init_quat=init_quat,
        part_mass=part_mass,
        part_com=part_com,
        part_inertia=part_inertia,
        part_horiz_radius=horiz_radius,
        geom_part=geom_part,
        geom_type=geom_type,
        geom_size=geom_size,
        geom_pos=geom_pos,
        geom_quat=geom_quat,
        geom_friction=geom_friction,
        geom_solref=geom_solref,
        site_names=site_names,
        site_part=site_part,
        site_pos=site_pos,
        conn_names=conn_names,
        conn_part=conn_part,
        conn_pos=conn_pos,
        conn_pair_a=conn_pair_a,
        conn_pair_b=conn_pair_b,
        conn_angles=conn_angles,
        conn_angle_mask=conn_angle_mask,
        conn_has_angles=conn_has_angles,
        weld_part1=weld_part1,
        weld_part2=weld_part2,
        weld_lookup=weld_lookup,
        recipe_site1=np.array(rs1, dtype=np.int32).reshape(R),
        recipe_site2=np.array(rs2, dtype=np.int32).reshape(R),
        recipe_angle=np.array(rang, dtype=np.float64).reshape(R),
        num_connects=int(num_connects),
        recipe_raw=recipe,
    )


def compile_from_config(config) -> CompiledModel:
    """Compile honoring the config's resize flags: ``furn_size_scale`` is a
    deterministic factor; ``furn_size_rand`` adds the reference's random
    resize ``1 + U(-r, r)`` sampled at build time
    (``env/furniture.py:1428-1431,1986-1992`` — the reference likewise
    rebuilds the MJCF model when resizing)."""
    scale = getattr(config, "furn_size_scale", 1.0)
    r = getattr(config, "furn_size_rand", 0.0)
    if r:
        scale *= 1.0 + float(np.random.uniform(-r, r))
    return compile_model(config.furniture_name, size_scale=scale)
