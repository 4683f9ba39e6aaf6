"""Robot chain compiler: robot + gripper JSON specs → static arrays.

The port's own copy of ``furniture_tpu.robots.chain`` (numpy only): the
same compiler with the same outputs, so both packages build identical
robot tables. The robot and gripper JSONs are read in place from the JAX
package's ``assets/`` directory (data, not an import).

Grippers are grafted onto the arm's hand body at compile time, the base
placement offset (each robot's ``bottom_offset``) is folded into the root
body, and everything becomes padded numpy arrays that the batched
kinematics (``robots/kinematics.py``) and the arm kernel's tables read.

Per-agent constants (init poses, gripper types, finger geoms) mirror the
reference robot/gripper classes (``models/robots/sawyer_robot.py:20``,
``models/grippers/two_finger_gripper.py:22,54-59``, etc.); citations inline.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

from ..models import ASSET_DIR

HINGE, SLIDE = 0, 1
MOTOR, VELOCITY, POSITION = 0, 1, 2
_ACT_CODE = {"motor": MOTOR, "velocity": VELOCITY, "position": POSITION}

# Per-agent constants, mirroring the reference robot classes
# (models/robots/*.py) and _load_model_robot (env/furniture.py:1889-1966).
AGENT_SPECS: dict[str, dict] = {
    "Sawyer": dict(
        file="sawyer",
        # sawyer_robot.py:20
        init_qpos=[-0.28, -0.60, 0.00, 1.86, 0.00, 0.3, 1.57],
        bottom_offset=[0, 0, -0.913],          # sawyer_robot.py:17
        grippers={"right": ("two_finger_gripper", "right_hand")},
        gripper_init={"right": [0.020833, -0.020833]},  # two_finger_gripper.py:22
        gripper_dof={"right": 1},              # two_finger_gripper.py:75
        finger_geoms={
            "right": (
                ["l_finger_g0", "l_finger_g1", "l_fingertip_g0"],
                ["r_finger_g0", "r_finger_g1", "r_fingertip_g0"],
            )
        },  # two_finger_gripper.py:54-59
    ),
    "Panda": dict(
        file="panda",
        # panda_robot.py:24
        init_qpos=[
            0, math.pi / 16.0, 0.00, -math.pi / 2.0 - math.pi / 3.0,
            0.00, math.pi - 0.2, -math.pi / 4,
        ],
        bottom_offset=[0, 0, -0.913],
        grippers={"right": ("panda_gripper", "right_hand")},
        gripper_init={"right": [0.04, -0.04]},  # panda_gripper.py:22
        gripper_dof={"right": 1},
        finger_geoms={
            "right": (["finger1_tip_collision"], ["finger2_tip_collision"])
        },  # panda_gripper.py:48-57
    ),
    "Jaco": dict(
        file="jaco",
        init_qpos=[0, math.pi * 3 / 4, -math.pi / 4, 0, 0, 0],  # jaco_robot.py:44
        bottom_offset=[0, 0, -0.913],
        grippers={"right": ("jaco_gripper", "right_hand")},
        gripper_init={"right": [0.0, 0.0, 0.0]},  # jaco_gripper.py:21
        gripper_dof={"right": 1},
        finger_geoms={
            "right": (
                ["jaco_link_finger_geom_1"],
                ["jaco_link_finger_geom_2", "jaco_link_finger_geom_3"],
            )
        },  # jaco_gripper.py:45-54
    ),
    "Fetch": dict(
        file="fetch",
        init_qpos=[0, 0.0, 0.00, 0.54, 0.0, 0.95, 0],  # fetch_robot.py:21
        bottom_offset=[-0.3, -0.4, -0.7],      # fetch_robot.py:18
        grippers={"right": ("fetch_gripper", "right_hand")},
        gripper_init={"right": [0.05, 0.05]},  # fetch_gripper.py:22
        gripper_dof={"right": 1},
        finger_geoms={
            "right": (
                ["l_gripper_finger_link_collision"],
                ["r_gripper_finger_link_collision"],
            )
        },  # fetch_gripper.py:50-55
    ),
    "Baxter": dict(
        file="baxter",
        # baxter_robot.py:44-46 (right arm 7 + left arm 7)
        init_qpos=[
            0.814, -0.44, -0.07, 0.5, 0, 1.641, -1.57629266,
            -0.872, -0.39, 0.07, 0.5, 0, 1.641, -1.57629197,
        ],
        bottom_offset=[0, 0, -0.913],
        grippers={
            "right": ("two_finger_gripper", "right_hand"),
            "left": ("left_two_finger_gripper", "left_hand"),
        },
        gripper_init={
            "right": [0.020833, -0.020833],
            "left": [0.020833, -0.020833],
        },
        gripper_dof={"right": 1, "left": 1},
        finger_geoms={
            "right": (
                ["l_finger_g0", "l_finger_g1", "l_fingertip_g0"],
                ["r_finger_g0", "r_finger_g1", "r_fingertip_g0"],
            ),
            "left": (
                ["l_g_l_finger_g0", "l_g_l_finger_g1", "l_g_l_fingertip_g0"],
                ["l_g_r_finger_g0", "l_g_r_finger_g1", "l_g_r_fingertip_g0"],
            ),
        },  # two_finger_gripper.py:120-125
    ),
}

# base placement for every arm agent (env/furniture.py:1901-1902 etc.)
_BASE_XPOS = np.array([0.0, 0.65, -0.7])
_BASE_XQUAT = np.array([1.0, 0.0, 0.0, -1.0]) / math.sqrt(2.0)


def _load(kind: str, name: str) -> dict:
    with open(ASSET_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass(frozen=True)
class CompiledRobot:
    """Static description of one articulated agent (arm(s) + gripper(s))."""

    agent: str
    control_variant: str           # "velocity" (robot.xml) | "torque" (robot_torque.xml)
    body_names: tuple[str, ...]

    # bodies [NB] — topological order (parent index < body index)
    parent: np.ndarray             # [NB] int, -1 = world
    body_pos: np.ndarray           # [NB,3] local offset in parent frame
    body_quat: np.ndarray          # [NB,4] local rotation (wxyz)
    body_mass: np.ndarray          # [NB]
    body_com: np.ndarray           # [NB,3] body-frame COM (inertial pos)
    body_inertia: np.ndarray       # [NB,3,3] body-frame inertia about COM

    # joints [NJ] — at most one joint per body (true for all agent models)
    jnt_name: tuple[str, ...]
    jnt_body: np.ndarray           # [NJ]
    jnt_type: np.ndarray           # [NJ] HINGE | SLIDE
    jnt_axis: np.ndarray           # [NJ,3] body-frame axis
    jnt_pos: np.ndarray            # [NJ,3] body-frame anchor
    jnt_range: np.ndarray          # [NJ,2] (±inf when unlimited)
    jnt_damping: np.ndarray        # [NJ]
    jnt_armature: np.ndarray       # [NJ]
    jnt_frictionloss: np.ndarray   # [NJ]
    jnt_maxvel: np.ndarray         # [NJ] velocity cap (inf for arm joints;
                                   # gripper slides limited — MuJoCo's stiff
                                   # position servos are otherwise unstable
                                   # against kinematic contact coupling)
    body_joint: np.ndarray         # [NB] joint index or -1
    ancestor: np.ndarray           # [NB,NJ] bool: joint j moves body b

    # actuators [NA] — order: arm actuators then gripper actuators per arm
    act_joint: np.ndarray          # [NA] joint index
    act_kind: np.ndarray           # [NA] MOTOR | VELOCITY | POSITION
    act_gain: np.ndarray           # [NA] kv (velocity) / kp (position) / gear (motor)
    act_ctrlrange: np.ndarray      # [NA,2]
    act_forcerange: np.ndarray     # [NA,2] (±inf when unlimited)
    act_close_sign: np.ndarray     # [NA] gripper closing direction (+1/-1),
                                   # 0 for arm actuators

    # collision geoms [NG] (non-mesh prims, box-ified half extents)
    geom_names: tuple = field(hash=False)          # [NG] geom name strings
    geom_body: np.ndarray          # [NG]
    geom_pos: np.ndarray           # [NG,3]
    geom_quat: np.ndarray          # [NG,4]
    geom_size: np.ndarray          # [NG,3]
    geom_friction: np.ndarray      # [NG]
    geom_solref: np.ndarray        # [NG,2] MuJoCo (timeconst, dampratio)
    hand_geoms: np.ndarray         # [NG] bool: gripper-side geoms used for
                                   # arm↔part contact coupling

    # per-arm indices
    arms: tuple[str, ...]                      # ("right",) or ("right","left")
    eef_body: dict = field(hash=False)         # arm -> hand body index
    grip_site: dict = field(hash=False)        # arm -> (body idx, local pos) of grip_site
    griptip_site: dict = field(hash=False)     # arm -> (body idx, local pos) of griptip_site
    arm_joints: dict = field(hash=False)       # arm -> np[int] actuated arm joint idx
    gripper_joints: dict = field(hash=False)   # arm -> np[int] gripper joint idx
    arm_actuators: dict = field(hash=False)    # arm -> np[int] actuator rows (arm)
    gripper_actuators: dict = field(hash=False)  # arm -> np[int] actuator rows (grip)
    finger_geoms_l: dict = field(hash=False)   # arm -> np[int] geom idx (left finger)
    finger_geoms_r: dict = field(hash=False)   # arm -> np[int] geom idx (right finger)

    init_qpos: np.ndarray          # [NJ] reference init pose (arm + gripper open)
    gripper_dof: dict = field(hash=False)      # arm -> action dims for the gripper

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def nj(self) -> int:
        return len(self.jnt_body)

    @property
    def na(self) -> int:
        return len(self.act_joint)

    @property
    def dof(self) -> int:
        """Arm torque/velocity action dims (reference ``mujoco_robot.dof``)."""
        return sum(len(v) for v in self.arm_actuators.values())


def compile_robot(agent: str, use_torque: bool = False) -> CompiledRobot:
    """Build the static chain for ``agent`` with its gripper(s) grafted.

    ``use_torque`` selects ``robot_torque.xml``-derived specs (motor
    actuators ±80 Nm) as the reference does for torque/impedance control
    (``env/furniture.py:1893``, ``models/robots/sawyer_robot.py:12-15``).
    """
    spec_info = AGENT_SPECS[agent]
    variant = "torque" if use_torque else "velocity"
    fname = spec_info["file"] + ("_torque" if use_torque else "")
    spec = _load("robots", fname)

    bodies = list(spec["bodies"])
    # fold base placement into the root body (set_base_xpos/xquat)
    base_pos = _BASE_XPOS - np.asarray(spec_info["bottom_offset"])
    for b in bodies:
        if b["parent"] == -1:
            b = dict(b)
    bodies = [dict(b) for b in bodies]
    roots = [i for i, b in enumerate(bodies) if b["parent"] == -1]
    assert len(roots) == 1, f"{agent}: expected one root body"
    bodies[roots[0]]["pos"] = list(base_pos)
    bodies[roots[0]]["quat"] = list(_BASE_XQUAT)

    name2idx = {b["name"]: i for i, b in enumerate(bodies)}

    # graft grippers: append gripper bodies re-parented onto the hand body
    gripper_meta = {}
    for arm, (gname, hand_body) in spec_info["grippers"].items():
        gspec = _load("grippers", gname)
        offset = len(bodies)
        hand_idx = name2idx[hand_body]
        for gb in gspec["bodies"]:
            gb = dict(gb)
            gb["parent"] = hand_idx if gb["parent"] == -1 else gb["parent"] + offset
            bodies.append(gb)
        gripper_meta[arm] = dict(
            spec=gspec, offset=offset, hand_idx=hand_idx,
            joints=[j["name"] for gb in gspec["bodies"] for j in gb["joints"]],
            actuators=gspec["actuators"],
        )
        name2idx.update(
            {b["name"]: offset + i for i, b in enumerate(gspec["bodies"])}
        )

    NB = len(bodies)
    parent = np.array([b["parent"] for b in bodies], dtype=np.int32)
    assert np.all(parent < np.arange(NB)), "bodies must be topologically ordered"
    body_pos = np.array([b["pos"] for b in bodies], dtype=np.float64)
    body_quat = np.array([b["quat"] for b in bodies], dtype=np.float64)
    body_quat /= np.linalg.norm(body_quat, axis=-1, keepdims=True)

    body_mass = np.zeros(NB)
    body_com = np.zeros((NB, 3))
    body_inertia = np.zeros((NB, 3, 3))
    for i, b in enumerate(bodies):
        inert = b.get("inertial")
        if inert:
            body_mass[i] = inert["mass"]
            body_com[i] = inert["pos"]
            R = _quat_to_mat_np(
                np.asarray(inert["quat"]) / np.linalg.norm(inert["quat"])
            )
            body_inertia[i] = R @ np.diag(inert["diaginertia"]) @ R.T

    # joints (one per body max)
    jnames, jbody, jtype, jaxis, jpos, jrange = [], [], [], [], [], []
    jdamp, jarm, jfric = [], [], []
    body_joint = np.full(NB, -1, dtype=np.int32)
    for i, b in enumerate(bodies):
        assert len(b["joints"]) <= 1, f"{b['name']}: multiple joints unsupported"
        for j in b["joints"]:
            body_joint[i] = len(jnames)
            jnames.append(j["name"])
            jbody.append(i)
            jtype.append(HINGE if j["type"] == "hinge" else SLIDE)
            ax = np.asarray(j["axis"], dtype=np.float64)
            jaxis.append(ax / max(np.linalg.norm(ax), 1e-12))
            jpos.append(j["pos"])
            jrange.append(j["range"] if j.get("range") else [-np.inf, np.inf])
            jdamp.append(j.get("damping") or 0.0)
            jarm.append(j.get("armature") or 0.0)
            jfric.append(j.get("frictionloss") or 0.0)
    NJ = len(jnames)
    jname2idx = {n: i for i, n in enumerate(jnames)}

    # ancestor matrix: joint j moves body b iff j's body is an ancestor of b
    ancestor = np.zeros((NB, NJ), dtype=bool)
    for b in range(NB):
        a = b
        while a != -1:
            if body_joint[a] >= 0:
                ancestor[b, body_joint[a]] = True
            a = parent[a]

    # actuators: robot's own, then each gripper's
    act_rows = []
    arm_actuators, gripper_actuators = {}, {}
    arm_joints, gripper_joints = {}, {}
    for arm in spec_info["grippers"]:
        arm_actuators[arm] = []
        gripper_actuators[arm] = []

    arms = tuple(spec_info["grippers"].keys())
    # robot actuators (belong to the right arm for single-arm agents; Baxter's
    # are split right/left by joint-name prefix)
    for a in spec["actuators"]:
        jidx = jname2idx[a["joint"]]
        row = len(act_rows)
        act_rows.append(a)
        if agent == "Baxter" and a["joint"].startswith("left_"):
            arm_actuators["left"].append(row)
        else:
            arm_actuators[arms[0]].append(row)
        # record the actuated joint per arm
    for arm in arms:
        arm_joints[arm] = np.array(
            [jname2idx[act_rows[r]["joint"]] for r in arm_actuators[arm]],
            dtype=np.int32,
        )
    for arm, meta in gripper_meta.items():
        gripper_joints[arm] = np.array(
            [jname2idx[n] for n in meta["joints"]], dtype=np.int32
        )
        for a in meta["actuators"]:
            jidx = jname2idx[a["joint"]]
            gripper_actuators[arm].append(len(act_rows))
            act_rows.append(a)

    NA = len(act_rows)
    act_joint = np.array([jname2idx[a["joint"]] for a in act_rows], dtype=np.int32)
    act_kind = np.array([_ACT_CODE[a["kind"]] for a in act_rows], dtype=np.int32)
    act_gain = np.zeros(NA)
    act_ctrl = np.zeros((NA, 2))
    act_force = np.zeros((NA, 2))
    for i, a in enumerate(act_rows):
        kind = _ACT_CODE[a["kind"]]
        if kind == VELOCITY:
            act_gain[i] = a["kv"]
        elif kind == POSITION:
            act_gain[i] = a["kp"]
        else:
            act_gain[i] = (a.get("gear") or [1.0])[0]
        act_ctrl[i] = a.get("ctrlrange") or [-1.0, 1.0]
        act_force[i] = a.get("forcerange") or [-np.inf, np.inf]

    # collision geoms (non-mesh prims; named finger MESH geoms — Jaco's —
    # get a small box proxy so finger contact still works)
    finger_names = {
        n
        for pair in spec_info["finger_geoms"].values()
        for lst in pair
        for n in lst
    }
    gbody, gpos, gquat, gsize, gfric, gname = [], [], [], [], [], []
    gsolref = []
    for i, b in enumerate(bodies):
        for g in b["geoms"]:
            if g["type"] == "mesh":
                if (g.get("name") or "") in finger_names:
                    g = dict(g, type="box", size=[0.015, 0.015, 0.025])
                else:
                    continue
            size = (list(g["size"]) + [0.0, 0.0, 0.0])[:3]
            if g["type"] == "sphere":
                size = [size[0]] * 3
            elif g["type"] == "cylinder":
                size = [size[0], size[0], size[1]]
            elif g["type"] == "capsule":
                if g.get("fromto"):
                    ft = np.asarray(g["fromto"], dtype=np.float64)
                    mid = 0.5 * (ft[:3] + ft[3:])
                    half = 0.5 * np.linalg.norm(ft[3:] - ft[:3]) + size[0]
                    size = [size[0], size[0], half]
                    g = dict(g, pos=list(mid))
                else:
                    size = [size[0], size[0], size[0] + (size[1] or size[0])]
            gbody.append(i)
            gpos.append(g["pos"])
            gquat.append(g["quat"])
            gsize.append(size)
            gfric.append(g["friction"][0])
            gsolref.append(g.get("solref") or [0.02, 1.0])
            gname.append(g.get("name") or "")
    NG = len(gbody)
    geom_body = np.array(gbody, dtype=np.int32).reshape(NG)
    geom_pos = np.array(gpos, dtype=np.float64).reshape(NG, 3)
    geom_quat = np.array(gquat, dtype=np.float64).reshape(NG, 4)
    geom_quat /= np.linalg.norm(geom_quat, axis=-1, keepdims=True)
    geom_size = np.array(gsize, dtype=np.float64).reshape(NG, 3)
    geom_friction = np.array(gfric, dtype=np.float64).reshape(NG)
    geom_solref = np.array(gsolref, dtype=np.float64).reshape(NG, 2)

    gname2idx: dict[str, int] = {}
    for i, n in enumerate(gname):
        if n:
            gname2idx[n] = i

    # gripper-side geoms = any geom on a body at/under a hand body
    hand_geoms = np.zeros(NG, dtype=bool)
    eef_body, grip_site, griptip_site = {}, {}, {}
    finger_geoms_l, finger_geoms_r = {}, {}
    for arm, meta in gripper_meta.items():
        hand_idx = meta["hand_idx"]
        under = np.zeros(NB, dtype=bool)
        for b in range(NB):
            a = b
            while a != -1:
                if a == hand_idx:
                    under[b] = True
                    break
                a = parent[a]
        hand_geoms |= under[geom_body]
        # eef body: the gripper body carrying grip_site (reference obs use
        # "right_hand" body pos; grip_site sits in the grafted gripper,
        # two_finger_gripper.xml)
        eef_body[arm] = hand_idx
        found = None
        found_tip = None
        n_grip_bodies = len(meta["spec"]["bodies"])
        for bi in range(meta["offset"], meta["offset"] + n_grip_bodies):
            for s in bodies[bi]["sites"]:
                name = s["name"] or ""
                if name in ("grip_site", "l_g_grip_site"):
                    found = (bi, np.asarray(s["pos"], dtype=np.float64))
                if name in ("griptip_site", "l_g_griptip_site"):
                    found_tip = (bi, np.asarray(s["pos"], dtype=np.float64))
        grip_site[arm] = found if found else (hand_idx, np.zeros(3))
        griptip_site[arm] = found_tip if found_tip else grip_site[arm]
        lg, rg = spec_info["finger_geoms"][arm]
        finger_geoms_l[arm] = np.array(
            [gname2idx[n] for n in lg if n in gname2idx], dtype=np.int32
        )
        finger_geoms_r[arm] = np.array(
            [gname2idx[n] for n in rg if n in gname2idx], dtype=np.int32
        )

    # init qpos: reference arm init + gripper open pose
    init_qpos = np.zeros(NJ)
    arm_init = np.asarray(spec_info["init_qpos"], dtype=np.float64)
    k = 0
    for arm in arms:
        for j in arm_joints[arm]:
            init_qpos[j] = arm_init[k]
            k += 1
    for arm, meta in gripper_meta.items():
        ginit = np.asarray(spec_info["gripper_init"][arm], dtype=np.float64)
        for gi, j in enumerate(gripper_joints[arm][: len(ginit)]):
            init_qpos[j] = ginit[gi]

    # joint velocity caps + closing signs.
    # Arm joints driven by VELOCITY servos are capped at 1.5x the servo's
    # command range: a velocity-servo'd joint cannot physically sustain
    # speeds past its range, and without the cap the explicit contact
    # coupling admits a mutual runaway — part ping-pong in the grasp feeds
    # Jᵀλ impulses to the arm, the arm sweeps faster, the pads bat the
    # part harder (observed: qvel hitting 12 rad/s and held parts ejected
    # across the workspace at 10+ m/s).
    jnt_maxvel = np.full(NJ, np.inf)
    for i in range(NA):
        if act_kind[i] == VELOCITY:
            j = act_joint[i]
            jnt_maxvel[j] = min(
                jnt_maxvel[j], 1.5 * float(np.abs(act_ctrl[i]).max())
            )
    act_close_sign = np.zeros(NA)
    for arm in arms:
        for j in gripper_joints[arm]:
            jnt_maxvel[j] = 0.15
        for row in gripper_actuators[arm]:
            j = act_joint[row]
            mid = 0.5 * (act_ctrl[row, 0] + act_ctrl[row, 1])
            act_close_sign[row] = np.sign(mid - init_qpos[j]) or 1.0

    return CompiledRobot(
        agent=agent,
        control_variant=variant,
        body_names=tuple(b["name"] for b in bodies),
        parent=parent,
        body_pos=body_pos,
        body_quat=body_quat,
        body_mass=body_mass,
        body_com=body_com,
        body_inertia=body_inertia,
        jnt_name=tuple(jnames),
        jnt_body=np.array(jbody, dtype=np.int32),
        jnt_type=np.array(jtype, dtype=np.int32),
        jnt_axis=np.array(jaxis, dtype=np.float64).reshape(NJ, 3),
        jnt_pos=np.array(jpos, dtype=np.float64).reshape(NJ, 3),
        jnt_range=np.array(jrange, dtype=np.float64).reshape(NJ, 2),
        jnt_damping=np.array(jdamp, dtype=np.float64),
        jnt_armature=np.array(jarm, dtype=np.float64),
        jnt_frictionloss=np.array(jfric, dtype=np.float64),
        jnt_maxvel=jnt_maxvel,
        body_joint=body_joint,
        ancestor=ancestor,
        act_joint=act_joint,
        act_kind=act_kind,
        act_gain=act_gain,
        act_ctrlrange=act_ctrl,
        act_forcerange=act_force,
        act_close_sign=act_close_sign,
        geom_names=tuple(gname),
        geom_body=geom_body,
        geom_pos=geom_pos,
        geom_quat=geom_quat,
        geom_size=geom_size,
        geom_friction=geom_friction,
        geom_solref=geom_solref,
        hand_geoms=hand_geoms,
        arms=arms,
        eef_body=eef_body,
        grip_site=grip_site,
        griptip_site=griptip_site,
        arm_joints=arm_joints,
        gripper_joints={k: np.asarray(v) for k, v in gripper_joints.items()},
        arm_actuators={k: np.asarray(v, dtype=np.int32) for k, v in arm_actuators.items()},
        gripper_actuators={k: np.asarray(v, dtype=np.int32) for k, v in gripper_actuators.items()},
        finger_geoms_l=finger_geoms_l,
        finger_geoms_r=finger_geoms_r,
        init_qpos=init_qpos,
        gripper_dof=dict(spec_info["gripper_dof"]),
    )
