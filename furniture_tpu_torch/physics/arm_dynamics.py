"""Joint dynamics of an arm in one launch: the hand-written CUDA kernel of
the per-control-step update matrices G1, G2, and its wrapper.

``csrc/arm_dynamics.cu`` computes, for every env of a batch, what
``robots.kinematics.joint_dyn_matrices`` computes: forward kinematics, the
mass matrix M, A = M + dt·diag(D), its Cholesky factor, G1 = A⁻¹M and
G2 = dt·A⁻¹, one warp an env (see the note at the top of the ``.cu`` file).
It replaces no TPU kernel: it takes the host's enqueue of the plain
version's ~1,430 small kernels, and the host synchronisation of its
``torch.cholesky_solve``, off the arm env's step.

:class:`ArmDynamics` packs the robot's tables once, at construction, and
wraps the launch:

* ``matrices(qpos)`` launches the kernel for CUDA tensors (one launch, no
  host synchronisation) and returns ``K.joint_dyn_matrices`` itself for CPU
  tensors, which is the **plain version** the kernel is held against.
  There is no other route: another device, or a kernel that fails to build
  or launch, raises. It takes no gradient (the iLQR planner differentiates
  through the plain version).
* ``launches`` counts kernel launches, and nothing else.

One kernel serves every arm: the body and joint counts, the parents and the
hinge or slide joints come from the robot's tables, within the kernel's
``MAX_NB`` bodies and ``MAX_NJ`` joints, which the wrapper holds a robot to.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from ..robots import kinematics as K
from ..robots.chain import CompiledRobot

SOURCE = Path(__file__).resolve().parent / "csrc" / "arm_dynamics.cu"

# the .cu file's limits and table widths (checked when the library loads)
MAX_NB = 64
MAX_NJ = 32
BODY_F, BODY_I, JNT_F, JNT_I = 23, 5, 8, 2

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _cuda.load(SOURCE)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.arm_dyn_matrices.argtypes = [vp] * 8 + [i] * 4 + [ctypes.c_float, vp]
        lib.arm_dyn_matrices.restype = i
        lib.arm_dyn_error_string.argtypes = [i]
        lib.arm_dyn_error_string.restype = ctypes.c_char_p
        names = ("max_nb", "max_nj", "body_f", "body_i", "jnt_f", "jnt_i")
        for n in names:
            getattr(lib, f"arm_dyn_{n}").argtypes = []
            getattr(lib, f"arm_dyn_{n}").restype = i
        layout = tuple(getattr(lib, f"arm_dyn_{n}")() for n in names)
        if layout != (MAX_NB, MAX_NJ, BODY_F, BODY_I, JNT_F, JNT_I):
            raise RuntimeError(f"arm_dynamics.cu limits or table layout changed: {layout}")
        lib.arm_dyn_smem_bytes.argtypes = [i, i]
        lib.arm_dyn_smem_bytes.restype = i
        _lib = lib
    return _lib


def pack_tables(robot: CompiledRobot, dt: float) -> dict:
    """The kernel's tables of ``robot`` at timestep ``dt`` (numpy):

    * ``body_f`` [NB, 23]: local pos, local quat, the unit joint axis (the
      hinge's rotation axis, as the plain version normalises it; zeros
      without a joint), COM, mass, inertia (row-major);
    * ``body_i`` [NB, 5]: parent (-1: world), joint (-1: none), joint type
      (-1: none), depth in the chain, the joints that move the body (bit j,
      the robot's ancestor matrix);
    * ``jnt_f`` [NJ, 8]: axis, anchor, armature, dt·D (D: joint damping +
      velocity-servo kv + dt·position-servo kp, ``K.static_damping``);
    * ``jnt_i`` [NJ, 2]: body, type;
    * ``pairs`` [NJ(NJ+1)/2]: the upper triangle's (k, j), k ≤ j, as
      ``k | j << 16``;
    * ``nlev``: the chain's depth + 1.

    Bodies keep the robot's topological order (a parent before its
    children)."""
    f32, i32 = np.float32, np.int32
    nb, nj = robot.nb, robot.nj
    parent = np.asarray(robot.parent, np.int64)
    depth = np.zeros(nb, np.int64)
    for b in range(nb):
        if parent[b] >= b:
            raise ValueError(f"{robot.agent}: body {b} comes before its parent {parent[b]}")
        depth[b] = 0 if parent[b] < 0 else depth[parent[b]] + 1
    bj = np.asarray(robot.body_joint, np.int64)
    j_safe = np.maximum(bj, 0)
    axis = np.asarray(robot.jnt_axis, f32)
    # transforms.unit, as quat_from_axis_angle normalises the axis
    unit = axis / np.sqrt(np.sum(axis * axis, -1, keepdims=True) + f32(1e-24))
    mask = (np.asarray(robot.ancestor, np.int64) << np.arange(nj)).sum(-1)
    body_f = np.concatenate(
        [
            np.asarray(robot.body_pos, f32),
            np.asarray(robot.body_quat, f32),
            np.where(bj[:, None] >= 0, unit[j_safe], f32(0)),
            np.asarray(robot.body_com, f32),
            np.asarray(robot.body_mass, f32)[:, None],
            np.asarray(robot.body_inertia, f32).reshape(nb, 9),
        ],
        axis=1,
    ).astype(f32)
    body_i = np.stack(
        [parent, bj, np.where(bj >= 0, np.asarray(robot.jnt_type)[j_safe], -1), depth,
         mask.astype(np.uint32).view(i32)],
        axis=1,
    ).astype(i32)
    dtD = (f32(dt) * K.static_damping(robot, dt)).astype(f32)
    jnt_f = np.concatenate(
        [axis, np.asarray(robot.jnt_pos, f32),
         np.asarray(robot.jnt_armature, f32)[:, None], dtD[:, None]],
        axis=1,
    ).astype(f32)
    jnt_i = np.stack([robot.jnt_body, robot.jnt_type], axis=1).astype(i32)
    k, j = np.triu_indices(nj)
    pairs = (k | (j << 16)).astype(i32)
    return dict(body_f=body_f, body_i=body_i, jnt_f=jnt_f, jnt_i=jnt_i, pairs=pairs,
                nlev=int(depth.max()) + 1)


TABLES = ("body_f", "body_i", "jnt_f", "jnt_i", "pairs")


class ArmDynamics:
    """The joint dynamics of one robot at one timestep on one device:
    ``matrices(qpos) -> (G1, G2)``, each [B, NJ, NJ]."""

    def __init__(self, robot: CompiledRobot, dt: float, device):
        if robot.nb > MAX_NB or robot.nj > MAX_NJ:
            raise ValueError(
                f"{robot.agent} has {robot.nb} bodies and {robot.nj} joints: the joint-dynamics "
                f"kernel takes at most MAX_NB = {MAX_NB} bodies and MAX_NJ = {MAX_NJ} joints"
            )
        self.robot = robot
        self.dt = float(dt)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # tensors report a concrete index; compare against the same
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.launches = 0
        self.tables = pack_tables(robot, dt)
        self._dev = (
            {n: torch.as_tensor(self.tables[n], device=self.device) for n in TABLES}
            if self.device.type == "cuda"
            else None
        )

    def matrices(self, qpos: torch.Tensor):
        """G1 = A⁻¹M and G2 = dt·A⁻¹ for ``qpos`` [B, NJ]: the kernel for
        CUDA tensors, the plain version for CPU tensors."""
        kind = qpos.device.type
        if kind == "cuda":
            return self._launch(qpos)
        if kind == "cpu":
            return K.joint_dyn_matrices(self.robot, qpos, self.dt)
        raise RuntimeError(f"no joint dynamics for device {qpos.device}")

    def _launch(self, qpos: torch.Tensor):
        """One launch of the CUDA kernel; raises on anything it cannot take."""
        nj = self.robot.nj
        if self._dev is None or qpos.device != self.device:
            raise ValueError(f"tables live on {self.device}, qpos on {qpos.device}")
        if qpos.dim() != 2 or qpos.shape[1] != nj or qpos.dtype != torch.float32:
            raise ValueError(f"qpos: want [B, {nj}] float32, got {tuple(qpos.shape)} {qpos.dtype}")
        if not qpos.is_contiguous():
            raise ValueError("qpos must be contiguous")
        B = qpos.shape[0]
        G1 = torch.empty((B, nj, nj), dtype=torch.float32, device=qpos.device)
        G2 = torch.empty_like(G1)
        lib = library()
        t = self._dev
        with torch.cuda.device(qpos.device):
            stream = torch.cuda.current_stream(qpos.device).cuda_stream
            err = lib.arm_dyn_matrices(
                qpos.data_ptr(), G1.data_ptr(), G2.data_ptr(),
                *(t[n].data_ptr() for n in TABLES),
                B, self.robot.nb, nj, self.tables["nlev"], self.dt, stream,
            )
        if err != 0:
            raise RuntimeError(
                "joint-dynamics kernel launch failed: " + lib.arm_dyn_error_string(err).decode()
            )
        self.launches += 1
        return G1, G2
