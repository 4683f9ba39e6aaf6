"""Batched damped-least-squares inverse kinematics, and the IK control
step of an arm env in one launch.

The port's counterpart of ``furniture_tpu.controllers.ik``: ``dls_ik`` is
plain PyTorch on the same FK that the dynamics use, for a whole batch at
once, and ``ik_prepare`` the arm env's IK control step around it (the IK
target's update from the action, then the solve toward it, arm by arm).

``physics/csrc/arm_ik.cu`` computes ``ik_prepare`` for every env and arm of
a batch in one launch, one warp an env (see the note at the top of the
``.cu`` file). It replaces no TPU kernel: it takes the host's enqueue of
the plain version's 21 forward kinematics and 20 batched Cholesky solves,
about 32,000 small kernels and 21 host synchronisations an ik step, off the
arm env's step. :class:`ArmIK` packs the robot's tables once, at
construction, and wraps the launch:

* ``prepare(qpos, ik_target_pos, hand_quat_init, action)`` launches the
  kernel for CUDA tensors (one launch, no host synchronisation) and runs
  ``ik_prepare`` itself for CPU tensors, which is the **plain version** the
  kernel is held against. There is no other route: another device, or a
  kernel that fails to build or launch, raises.
* ``launches`` counts kernel launches, and nothing else.

The kernel rounds every operation as the plain version's PyTorch ops do on
the card (the note in the ``.cu`` file says why: the solve is chaotic at
the last bit), and at B = 256 on the H100 its outputs equal the plain
version's bit for bit; at batch sizes where the library's batched
matrix-vector product takes another form they differ by rounding.

One kernel serves every arm agent, Baxter's two arms in one launch: the
hand's chain, the arm joints and their ranges come from the robot's
tables, within the kernel's ``MAX_ARMS`` arms, ``MAX_CHAIN`` bodies on a
hand's chain, ``MAX_NA`` joints an arm and ``MAX_NJ`` joints, which the
wrapper holds a robot to. ``ik`` and ``ik_quaternion`` differ only in how
the orientation target is formed: one argument of the launch.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from .. import transforms as T
from ..robots import kinematics as K
from ..robots.chain import CompiledRobot

SOURCE = Path(__file__).resolve().parent.parent / "physics" / "csrc" / "arm_ik.cu"

# the DLS solve's iterations, damping and step scale (also the kernel's)
ITERS, DAMPING, STEP_SCALE = 20, 1e-3, 1.0
# the .cu file's limits and table widths (checked when the library loads)
MAX_ARMS, MAX_CHAIN, MAX_NA, MAX_NJ = 2, 32, 8, 32
CHAIN_F, CHAIN_I, ARM_F, ARM_I, ARM_N = 16, 3, 8, 3, 2
IK_TYPES = ("ik", "ik_quaternion")


def _pose_error(cur_pos, cur_quat, target_pos, target_quat):
    """6-vector twist moving (cur) toward (target); leading dims batch."""
    e_pos = target_pos - cur_pos
    # orientation error from the relative quaternion (axis * angle)
    dq = T.quat_mul(target_quat, T.quat_inv(cur_quat))
    dq = torch.where(dq[..., 0:1] < 0, -dq, dq)
    angle = 2.0 * torch.arccos(torch.clamp(dq[..., 0], -1.0, 1.0))
    axis = dq[..., 1:] / torch.clamp(
        torch.linalg.norm(dq[..., 1:], dim=-1, keepdim=True), min=1e-9
    )
    return torch.cat([e_pos, axis * angle[..., None]], dim=-1)


def dls_ik(
    robot,
    arm: str,
    qpos,
    target_pos,
    target_quat,
    iters: int = ITERS,
    damping: float = DAMPING,
    step_scale: float = STEP_SCALE,
):
    """Damped-least-squares IK for ``arm``'s hand body, batched.

    ``qpos`` [B,NJ], ``target_pos`` [B,3], ``target_quat`` [B,4]. Returns
    the full joint vectors with the arm's actuated joints moved to reach the
    target; other joints are untouched. The 6×6 system ``J Jᵀ + λI`` is
    symmetric positive definite: a Cholesky solve (``cholesky_ex``: no error
    check, so no host synchronisation; a NaN pose gives a NaN command, which
    the env's instability guard contains)."""
    t = K.robot_tables(robot, qpos.device)
    arm_j = torch.as_tensor(np.asarray(robot.arm_joints[arm], np.int64), device=qpos.device)
    body = robot.eef_body[arm]
    lo, hi = t["lo"][arm_j], t["hi"][arm_j]
    eye6 = damping * torch.eye(6, dtype=qpos.dtype, device=qpos.device)
    q = qpos
    for _ in range(iters):
        fk_out = K.fk(robot, q)
        cur_pos, cur_quat = K.eef_pose(robot, fk_out, arm)
        err = _pose_error(cur_pos, cur_quat, target_pos, target_quat)   # [B,6]
        J = K.point_jacobian(robot, fk_out, body, cur_pos)              # [B,6,NJ]
        Ja = J[:, :, arm_j]                                             # [B,6,na]
        JJt = Ja @ Ja.transpose(1, 2) + eye6
        sol = torch.cholesky_solve(err[..., None], torch.linalg.cholesky_ex(JJt).L)
        dq = (Ja.transpose(1, 2) @ sol)[..., 0]
        qa = torch.minimum(torch.maximum(q[:, arm_j] + step_scale * dq, lo), hi)
        q = q.clone()
        q[:, arm_j] = qa
    return q


def ik_velocities(qpos, q_cmd, arm_joints, gain: float = 5.0):
    """Joint-space P-controller to velocity commands, clipped to ±1."""
    delta = qpos[:, arm_joints] - q_cmd[:, arm_joints]
    return torch.clamp(-gain * delta, -1.0, 1.0)


def ik_prepare(robot: CompiledRobot, control_type: str, move_speed: float, rotate_speed: float,
               box_lo, box_hi, qpos, ik_target_pos, hand_quat_init, action):
    """The IK control step of an arm env, batched: the IK target's update
    from ``action`` and the DLS solve toward it, for each arm in turn.

    ``qpos`` [B,NJ], ``ik_target_pos`` [B,A,3], ``hand_quat_init`` [B,A,4],
    ``action`` [B, >= aw·A] with per-arm blocks of width aw: ``ik`` =
    [dpos3, deuler3], ``ik_quaternion`` = [dpos3, dquat4] (a wxyz delta
    right-multiplied onto the hand quat); ``box_lo``, ``box_hi`` [3]: the
    gripper's workspace box. Returns ``(ik_target_pos [B,A,3],
    hand_quat_init [B,A,4], q_cmd [B,NJ])``."""
    aw = 7 if control_type == "ik_quaternion" else 6
    new_tpos, new_hqi = [], []
    q_cmd = qpos
    fk_out = K.fk(robot, qpos)
    for i, arm in enumerate(robot.arms):
        a = action[:, aw * i : aw * i + aw]
        move = a[:, :3] * move_speed
        hand_pos, hand_quat = K.eef_pose(robot, fk_out, arm)
        dpos = torch.minimum(torch.maximum(move, box_lo - hand_pos), box_hi - hand_pos)
        if control_type == "ik_quaternion":
            dq_in = T.quat_normalize(a[:, 3:7])
            # keep w >= 0 (shortest arc)
            dq_in = torch.where(dq_in[:, 0:1] < 0, -dq_in, dq_in)
            hqi = T.quat_normalize(T.quat_mul(hand_quat, dq_in))
        else:
            # hand-frame euler deltas, right-multiplied onto the
            # accumulated target, with the 0.3 sensitivity low-pass
            hqi = T.quat_mul(
                hand_quat_init[:, i],
                T.euler_to_quat(0.3 * a[:, 3:6] * rotate_speed),
            )
            hqi = T.quat_normalize(hqi)
        # anti-windup: the orientation target stays within 45° of the hand
        dq = T.quat_mul(hqi, T.quat_inv(hand_quat))
        dq = torch.where(dq[:, 0:1] < 0, -dq, dq)
        ang = 2.0 * torch.arccos(torch.clamp(dq[:, 0], -1.0, 1.0))
        frac = torch.clamp((math.pi / 4) / torch.clamp(ang, min=1e-6), max=1.0)
        hqi = T.quat_slerp(hand_quat, hqi, frac)
        # the target moves by 0.3 × dpos and stays within 15 cm of the hand
        tpos = ik_target_pos[:, i] + 0.3 * dpos
        err = tpos - hand_pos
        err_n = torch.linalg.norm(err, dim=-1, keepdim=True)
        tpos = hand_pos + err * torch.clamp(0.15 / torch.clamp(err_n, min=1e-6), max=1.0)
        q_cmd = dls_ik(robot, arm, q_cmd, tpos, hqi)
        new_tpos.append(tpos)
        new_hqi.append(hqi)
    return torch.stack(new_tpos, 1), torch.stack(new_hqi, 1), q_cmd


_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _cuda.load(SOURCE)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.arm_ik_prepare.argtypes = (
            [vp] * 12 + [ctypes.POINTER(f)] + [i] * 5 + [f] * 2 + [vp]
        )
        lib.arm_ik_prepare.restype = i
        lib.arm_ik_error_string.argtypes = [i]
        lib.arm_ik_error_string.restype = ctypes.c_char_p
        names = ("max_arms", "max_chain", "max_na", "max_nj", "chain_f", "chain_i", "arm_f",
                 "arm_i", "arm_n", "iters")
        for n in names:
            getattr(lib, f"arm_ik_{n}").argtypes = []
            getattr(lib, f"arm_ik_{n}").restype = i
        for n in ("damping", "step_scale"):
            getattr(lib, f"arm_ik_{n}").argtypes = []
            getattr(lib, f"arm_ik_{n}").restype = f
        layout = tuple(getattr(lib, f"arm_ik_{n}")() for n in names)
        want = (MAX_ARMS, MAX_CHAIN, MAX_NA, MAX_NJ, CHAIN_F, CHAIN_I, ARM_F, ARM_I, ARM_N, ITERS)
        solve = (lib.arm_ik_damping(), lib.arm_ik_step_scale())
        if layout != want or solve != (float(np.float32(DAMPING)), STEP_SCALE):
            raise RuntimeError(f"arm_ik.cu limits, table layout or solve changed: {layout}, {solve}")
        lib.arm_ik_smem_bytes.argtypes = [i, i]
        lib.arm_ik_smem_bytes.restype = i
        _lib = lib
    return _lib


def hand_chain(robot: CompiledRobot, arm: str) -> list:
    """The bodies from the root to ``arm``'s hand body, root first."""
    chain, b = [], int(robot.eef_body[arm])
    while b >= 0:
        chain.append(b)
        b = int(robot.parent[b])
    return chain[::-1]


def pack_tables(robot: CompiledRobot) -> dict:
    """The kernel's tables of ``robot`` (numpy), per arm in the robot's arm
    order, each padded to the kernel's limits:

    * ``chain_f`` [A, MAX_CHAIN, 16]: each body of the hand's chain, root
      first: local pos, local quat, the unit joint axis (the hinge's
      rotation axis, as ``quat_from_axis_angle`` normalises it), the joint's
      axis and anchor (zeros without a joint);
    * ``chain_i`` [A, MAX_CHAIN, 3]: body, joint (-1: none), joint type
      (-1: none); -1 past the chain;
    * ``arm_f`` [A, MAX_NA, 8]: each arm joint's axis and anchor, its lower
      and upper limit (``robot_tables``' ``lo``, ``hi``);
    * ``arm_i`` [A, MAX_NA, 3]: the joint (``robot.arm_joints``, the
      columns ``dls_ik`` moves), the chain position of its body (-1: the
      joint does not move the hand, a zero Jacobian column), its type;
    * ``arm_n`` [A, 2]: the chain's length, the arm's joint count."""
    f32, i32 = np.float32, np.int32
    A = len(robot.arms)
    axis = np.asarray(robot.jnt_axis, f32)
    unit = axis / np.sqrt(np.sum(axis * axis, -1, keepdims=True) + f32(1e-24))
    jpos = np.asarray(robot.jnt_pos, f32)
    chain_f = np.zeros((A, MAX_CHAIN, CHAIN_F), f32)
    chain_i = np.full((A, MAX_CHAIN, CHAIN_I), -1, i32)
    arm_f = np.zeros((A, MAX_NA, ARM_F), f32)
    arm_i = np.full((A, MAX_NA, ARM_I), -1, i32)
    arm_n = np.zeros((A, ARM_N), i32)
    for i, arm in enumerate(robot.arms):
        chain = hand_chain(robot, arm)
        for c, b in enumerate(chain):
            j = int(robot.body_joint[b])
            chain_f[i, c, 0:3] = robot.body_pos[b]
            chain_f[i, c, 3:7] = robot.body_quat[b]
            if j >= 0:
                chain_f[i, c, 7:10] = unit[j]
                chain_f[i, c, 10:13] = axis[j]
                chain_f[i, c, 13:16] = jpos[j]
            chain_i[i, c] = (b, j, int(robot.jnt_type[j]) if j >= 0 else -1)
        joints = np.asarray(robot.arm_joints[arm], np.int64)
        for k, j in enumerate(joints):
            jb = int(robot.jnt_body[j])
            moves = bool(robot.ancestor[robot.eef_body[arm]][j])
            if moves != (jb in chain):
                raise ValueError(f"{robot.agent}: joint {j}'s body {jb} and the ancestor table disagree")
            arm_f[i, k, 0:3] = axis[j]
            arm_f[i, k, 3:6] = jpos[j]
            arm_f[i, k, 6:8] = np.asarray(robot.jnt_range[j], f32)
            arm_i[i, k] = (j, chain.index(jb) if moves else -1, int(robot.jnt_type[j]))
        arm_n[i] = (len(chain), len(joints))
    return dict(chain_f=chain_f, chain_i=chain_i, arm_f=arm_f, arm_i=arm_i, arm_n=arm_n)


TABLES = ("chain_f", "chain_i", "arm_f", "arm_i", "arm_n")


class ArmIK:
    """The IK control step of one robot under one IK control type on one
    device: ``prepare(qpos, ik_target_pos, hand_quat_init, action) ->
    (ik_target_pos, hand_quat_init, q_cmd)``."""

    def __init__(self, robot: CompiledRobot, control_type: str, move_speed: float,
                 rotate_speed: float, box_lo, box_hi, device):
        if control_type not in IK_TYPES:
            raise ValueError(f"no IK for control_type {control_type!r}")
        chains = [hand_chain(robot, arm) for arm in robot.arms]
        too_long = [len(c) for c in chains if len(c) > MAX_CHAIN]
        too_many = [len(robot.arm_joints[a]) for a in robot.arms if len(robot.arm_joints[a]) > MAX_NA]
        if len(robot.arms) > MAX_ARMS or robot.nj > MAX_NJ or too_long or too_many:
            raise ValueError(
                f"{robot.agent} has {len(robot.arms)} arms, {robot.nj} joints, hand chains of "
                f"{[len(c) for c in chains]} bodies and {[len(robot.arm_joints[a]) for a in robot.arms]} "
                f"arm joints: the IK kernel takes at most MAX_ARMS = {MAX_ARMS} arms, MAX_NJ = "
                f"{MAX_NJ} joints, MAX_CHAIN = {MAX_CHAIN} bodies on a chain and MAX_NA = {MAX_NA} "
                f"joints an arm"
            )
        self.robot = robot
        self.control_type = control_type
        self.move_speed = float(move_speed)
        self.rotate_speed = float(rotate_speed)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # tensors report a concrete index; compare against the same
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.width = 7 if control_type == "ik_quaternion" else 6
        self.launches = 0
        self.tables = pack_tables(robot)
        lo, hi = np.asarray(box_lo, np.float32), np.asarray(box_hi, np.float32)
        self.box = (torch.as_tensor(lo, device=self.device), torch.as_tensor(hi, device=self.device))
        self._box_host = (ctypes.c_float * 6)(*lo.tolist(), *hi.tolist())
        self._dev = (
            {n: torch.as_tensor(self.tables[n], device=self.device) for n in TABLES}
            if self.device.type == "cuda"
            else None
        )

    def prepare(self, qpos, ik_target_pos, hand_quat_init, action):
        """The new IK targets and the joint commands of one control step:
        the kernel for CUDA tensors, the plain version for CPU tensors."""
        self._check(qpos, ik_target_pos, hand_quat_init, action)
        kind = qpos.device.type
        if kind == "cuda":
            return self._launch(qpos, ik_target_pos, hand_quat_init, action)
        if kind == "cpu":
            return ik_prepare(self.robot, self.control_type, self.move_speed, self.rotate_speed,
                              *self.box, qpos, ik_target_pos, hand_quat_init, action)
        raise RuntimeError(f"no IK for device {qpos.device}")

    def _check(self, qpos, ik_target_pos, hand_quat_init, action) -> None:
        """Raises on inputs of another device, type or shape."""
        nj, A = self.robot.nj, len(self.robot.arms)
        B = qpos.shape[0] if qpos.dim() == 2 else -1
        want = {
            "qpos": (qpos, (B, nj)),
            "ik_target_pos": (ik_target_pos, (B, A, 3)),
            "hand_quat_init": (hand_quat_init, (B, A, 4)),
        }
        for name, (x, shape) in want.items():
            if x.device != self.device:
                raise ValueError(f"tables live on {self.device}, {name} on {x.device}")
            if x.dtype != torch.float32 or tuple(x.shape) != shape or B < 0:
                raise ValueError(f"{name}: want {list(shape)} float32, got {tuple(x.shape)} {x.dtype}")
        if action.device != self.device:
            raise ValueError(f"tables live on {self.device}, action on {action.device}")
        if (action.dtype != torch.float32 or action.dim() != 2 or action.shape[0] != B
                or action.shape[1] < self.width * A):
            raise ValueError(f"action: want [{B}, >= {self.width * A}] float32, got "
                             f"{tuple(action.shape)} {action.dtype}")

    def _launch(self, qpos, ik_target_pos, hand_quat_init, action):
        """One launch of the CUDA kernel; raises on anything it cannot take."""
        ins = (qpos, ik_target_pos, hand_quat_init, action)
        if self._dev is None:
            raise ValueError(f"tables live on {self.device}, the inputs on {qpos.device}")
        if not all(x.is_contiguous() for x in ins):
            raise ValueError("qpos, ik_target_pos, hand_quat_init and action must be contiguous")
        B, nj, A = qpos.shape[0], self.robot.nj, len(self.robot.arms)
        tpos = torch.empty((B, A, 3), dtype=torch.float32, device=qpos.device)
        hqi = torch.empty((B, A, 4), dtype=torch.float32, device=qpos.device)
        q_cmd = torch.empty((B, nj), dtype=torch.float32, device=qpos.device)
        lib = library()
        t = self._dev
        with torch.cuda.device(qpos.device):
            stream = torch.cuda.current_stream(qpos.device).cuda_stream
            err = lib.arm_ik_prepare(
                *(x.data_ptr() for x in ins), tpos.data_ptr(), hqi.data_ptr(), q_cmd.data_ptr(),
                *(t[n].data_ptr() for n in TABLES), self._box_host,
                B, nj, A, int(self.control_type == "ik_quaternion"), action.shape[1],
                self.move_speed, self.rotate_speed, stream,
            )
        if err != 0:
            raise RuntimeError("IK kernel launch failed: " + lib.arm_ik_error_string(err).decode())
        self.launches += 1
        return tpos, hqi, q_cmd
