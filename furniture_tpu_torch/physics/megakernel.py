"""Whole-control-step free-part physics: the hand-written CUDA kernel.

The port's counterpart of ``furniture_tpu.physics.megakernel``. One launch
of ``csrc/megakernel.cu`` runs ``n`` substeps for every env of a batch, one
thread block per env, with the state, the group aggregates and the per-lane
contact working set kept on chip for the whole launch (see the note at the
top of the ``.cu`` file).

:class:`MegaPhysics` builds the kernel's constant tables (the same numpy
tables as the JAX package's ``MegaPhysics``, without the one-hot matrices
that existed only for the TPU's matrix unit) and wraps the launch:

* ``substeps(parts, group, gscale, n)`` launches the kernel for CUDA
  tensors and runs the plain PyTorch version (``engine.substeps``) for CPU
  tensors. There is no fallback: any other device, or a kernel that fails
  to build or launch, raises.
* ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from .collide import attach_betas
from .engine import make_substep, substeps as plain_substeps
from .state import PartState

SOURCE = Path(__file__).resolve().parent / "csrc" / "megakernel.cu"
THREADS = 256
# dynamic shared memory a block may opt into on Hopper (227 KB)
MAX_SMEM = 232448

_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)],
    np.float32,
)  # [8,3]

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _cuda.load(SOURCE)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mega_substeps.argtypes = (
            [vp] * 17 + [i] * 7 + [f] * 5 + [i, i, vp]
        )
        lib.mega_substeps.restype = i
        lib.mega_error_string.argtypes = [i]
        lib.mega_error_string.restype = ctypes.c_char_p
        for fn in ("mega_lane_floats", "mega_part_floats", "mega_lane_const_cols"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


def make_batched_substeps(tables, cfg_sim, device):
    """Batched-substeps entry ``f(parts[B], group[B,P], gscale[B,P], n)`` per
    ``SimConfig.use_pallas``: ``"lane"`` gives the :class:`LanePhysics`
    (plain narrow phase and integration, contacts solved cold by the lane
    solver); every other value (``"auto"``, ``"on"``, ``"off"``) gives the
    :class:`MegaPhysics`
    (the free-part kernel on CUDA tensors, its plain version on CPU
    tensors). Returns the object whose ``substeps`` it is."""
    if cfg_sim.use_pallas == "lane":
        return LanePhysics(tables, cfg_sim, device)
    return MegaPhysics(tables, cfg_sim, device)


class LanePhysics:
    """Free-part substeps on the lane-solver backend for one model: every
    substep runs the plain narrow phase and integration of ``engine.py`` and
    solves its contacts through ``lane_solver.solve_contacts_lane`` (its
    CUDA kernel on CUDA tensors, its plain version on CPU tensors), with no
    warm start carried across substeps. The kernel's launches are counted in
    ``lane_solver.launches``: one per substep."""

    def __init__(self, model_np, cfg_sim, device):
        self._substep = make_substep(model_np, cfg_sim, torch.device(device))

    def solver_args(self, parts: PartState, group, gscale):
        """The arguments ``solve_contacts_lane`` gets in a substep from
        this state."""
        return self._substep.solver_args(parts, group, gscale)[1]

    def substeps(self, parts: PartState, group, gscale, n: int) -> PartState:
        """Run ``n`` cold-started substeps for a batch."""
        kind = parts.pos.device.type
        if kind not in ("cuda", "cpu"):
            raise RuntimeError(f"no free-part physics for device {parts.pos.device}")
        return plain_substeps(self._substep, parts, group, gscale, n)


def lane_lists(part_a, part_b, Kf: int, P: int):
    """The kernels' static per-part lane lists: ``lane_part`` [K,2], and for
    each part its side-a lanes (floor lanes first) then its side-b lanes as
    ``(lane << 1) | side`` in ``part_ent`` with offsets ``part_off`` and the
    count of leading floor lanes ``part_nfloor``."""
    lane_part = np.stack([part_a, part_b], 1).astype(np.int32)
    ent, off, nfloor = [], [0], []
    for p in range(P):
        a = np.flatnonzero(part_a == p)
        b = np.flatnonzero(part_b == p)
        ent.extend((a << 1).tolist() + ((b << 1) | 1).tolist())
        off.append(len(ent))
        nfloor.append(int(np.sum(a < Kf)))
    return (
        lane_part,
        np.asarray(ent, np.int32),
        np.asarray(off, np.int32),
        np.asarray(nfloor, np.int32),
    )


class MegaPhysics:
    """Constant tables and wrapper of the free-part kernel for one model."""

    LANE_CONST_COLS = 22  # csrc/megakernel.cu LC

    def __init__(self, model_np, cfg_sim, device):
        self.cfg = cfg_sim
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # tensors report a concrete index; compare against the same
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.launches = 0

        gp = np.asarray(model_np["geom_part"])
        G = len(gp)
        P = len(model_np["part_mass"])  # a part may carry no geoms
        self.P = P
        sizes = np.asarray(model_np["_box_sizes"], np.float32)  # [G,3]
        gpos = np.asarray(model_np["geom_pos"], np.float32)
        gquat = np.asarray(model_np["geom_quat"], np.float32)

        # corner offsets in the *part* frame: gpos + R(gquat) (signs * size)
        def part_frame_corners(geoms):
            out = np.zeros((len(geoms) * 8, 3), np.float32)
            for i, g in enumerate(geoms):
                c = _CORNER_SIGNS * sizes[g]
                w, x, y, z = gquat[g]
                R = np.array(
                    [
                        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    ],
                    np.float32,
                )
                out[i * 8 : (i + 1) * 8] = gpos[g] + c @ R.T
            return out

        # floor lanes, geom-major (collide.floor_contacts order)
        lf_geom = np.repeat(np.arange(G), 8)
        self.Kf = G * 8
        self.lf_corner = part_frame_corners(np.arange(G))             # [Kf,3]
        self.lf_part = gp[lf_geom]
        self.lf_fric = np.asarray(model_np["_floor_friction"], np.float32)[lf_geom]

        # pair lanes: AB block then BA (collide.pair_contacts order)
        pairs = np.asarray(model_np["_pairs"]).reshape(-1, 2)
        NP_ = len(pairs)
        src = np.concatenate([pairs[:, 0], pairs[:, 1]]) if NP_ else np.zeros(0, int)
        dst = np.concatenate([pairs[:, 1], pairs[:, 0]]) if NP_ else np.zeros(0, int)
        lp_src = np.repeat(src, 8)
        lp_dst = np.repeat(dst, 8)
        self.Kp = len(lp_src)
        attach_betas(model_np, cfg_sim)
        lp_beta = (
            np.repeat(np.concatenate([model_np["_pair_beta"]] * 2), 8)
            if NP_
            else np.zeros(0, np.float32)
        )
        self.lane_beta = np.concatenate(
            [
                np.repeat(model_np["_floor_beta"], 8),
                lp_beta,
                np.asarray(model_np["_pair_beta"], np.float32),
            ]
        ).astype(np.float32)
        self.lp_corner = part_frame_corners(src) if NP_ else np.zeros((0, 3), np.float32)
        self.lp_part_a = gp[lp_src] if NP_ else np.zeros(0, int)
        self.lp_part_b = gp[lp_dst] if NP_ else np.zeros(0, int)
        fric = np.asarray(model_np["geom_friction"], np.float32)
        pair_fric = np.maximum(fric[src], fric[dst]) if NP_ else np.zeros(0, np.float32)
        self.lp_fric = np.repeat(pair_fric, 8)
        self.lp_dst_pos = gpos[lp_dst] if NP_ else np.zeros((0, 3), np.float32)
        self.lp_dst_quat = gquat[lp_dst] if NP_ else np.zeros((0, 4), np.float32)
        self.lp_dst_size = sizes[lp_dst] if NP_ else np.zeros((0, 3), np.float32)

        # one SAT edge lane per pair (collide.edge_contacts)
        self.Ke = NP_
        ga = pairs[:, 0] if NP_ else np.zeros(0, int)
        gb = pairs[:, 1] if NP_ else np.zeros(0, int)
        self.ep_a = (
            np.concatenate([gpos[ga], gquat[ga], sizes[ga]], axis=1).astype(np.float32)
            if NP_ else np.zeros((0, 10), np.float32)
        )
        self.ep_b = (
            np.concatenate([gpos[gb], gquat[gb], sizes[gb]], axis=1).astype(np.float32)
            if NP_ else np.zeros((0, 10), np.float32)
        )

        self.K = self.Kf + self.Kp + self.Ke
        self.part_a = np.concatenate([self.lf_part, self.lp_part_a, gp[ga]]).astype(int)
        self.part_b = np.concatenate(
            [np.full(self.Kf, -1), self.lp_part_b, gp[gb]]
        ).astype(int)
        edge_fric = np.maximum(fric[ga], fric[gb]) if NP_ else np.zeros(0, np.float32)
        self.lane_fric = np.concatenate(
            [self.lf_fric, self.lp_fric, edge_fric]
        ).astype(np.float32)

        self.mass = np.asarray(model_np["part_mass"], np.float32)          # [P]
        self.com_l = np.asarray(model_np["part_com"], np.float32)          # [P,3]
        self.inertia_l = np.asarray(model_np["part_inertia"], np.float32)  # [P,3,3]

        # -- packed kernel tables --------------------------------------------
        pc = np.zeros((P, 13), np.float32)
        pc[:, 0] = self.mass
        pc[:, 1:4] = self.com_l
        pc[:, 4:13] = self.inertia_l.reshape(P, 9)
        self.part_const = pc
        # [Kp,13]: src corner, dst geom pos, dst geom quat, dst size
        self.lp_const = np.concatenate(
            [self.lp_corner, self.lp_dst_pos, self.lp_dst_quat, self.lp_dst_size], axis=1
        ).astype(np.float32)
        lc = np.zeros((self.K, self.LANE_CONST_COLS), np.float32)
        lc[: self.Kf, 0:3] = self.lf_corner
        lc[self.Kf : self.Kf + self.Kp, 0:13] = self.lp_const
        lc[self.Kf + self.Kp :, 0:10] = self.ep_a
        lc[self.Kf + self.Kp :, 10:20] = self.ep_b
        lc[:, 20] = self.lane_fric
        lc[:, 21] = self.lane_beta
        self.lane_const = lc
        self.lane_part, self.part_ent, self.part_off, self.part_nfloor = lane_lists(
            self.part_a, self.part_b, self.Kf, P
        )
        self._dev = {
            name: torch.as_tensor(getattr(self, name), device=self.device)
            for name in (
                "part_const", "lane_const", "lane_part",
                "part_off", "part_nfloor", "part_ent",
            )
        }
        # the plain version of *this* kernel: warm-started in every mode
        self._plain = make_substep(
            model_np, dataclasses.replace(cfg_sim, use_pallas="off"), self.device
        )

    # -- the two versions ----------------------------------------------------

    def plain_substeps(self, parts: PartState, group, gscale, n: int) -> PartState:
        """The plain PyTorch version (``engine.substeps``), on any device."""
        return plain_substeps(self._plain, parts, group, gscale, n)

    def substeps(self, parts: PartState, group, gscale, n: int) -> PartState:
        """Run ``n`` substeps for a batch: kernel for CUDA tensors, plain
        version for CPU tensors."""
        kind = parts.pos.device.type
        if kind == "cuda":
            return self.kernel_substeps(parts, group, gscale, n)
        if kind == "cpu":
            return self.plain_substeps(parts, group, gscale, n)
        raise RuntimeError(f"no free-part physics for device {parts.pos.device}")

    def lane_buffer(self):
        """(floats per lane, shared bytes, lanes in shared memory?)."""
        lib = library()
        nf, pf = lib.mega_lane_floats(), lib.mega_part_floats()
        part_bytes = 4 * (pf * self.P + self.P)
        lane_bytes = 4 * nf * self.K
        in_smem = part_bytes + lane_bytes <= MAX_SMEM
        return nf, part_bytes + (lane_bytes if in_smem else 0), in_smem

    def kernel_substeps(self, parts: PartState, group, gscale, n: int) -> PartState:
        """One launch of the CUDA kernel; raises on anything it cannot take."""
        B, P = parts.pos.shape[:2]
        dev = parts.pos.device
        want = {
            "pos": (parts.pos, (B, P, 3), torch.float32),
            "quat": (parts.quat, (B, P, 4), torch.float32),
            "lin_vel": (parts.lin_vel, (B, P, 3), torch.float32),
            "ang_vel": (parts.ang_vel, (B, P, 3), torch.float32),
            "group": (group, (B, P), torch.int32),
            "gscale": (gscale, (B, P), torch.float32),
        }
        for name, (t, shape, dtype) in want.items():
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if P != self.P:
            raise ValueError(f"model has {self.P} parts, state has {P}")
        if dev != self.device:
            raise ValueError(f"tables live on {self.device}, state on {dev}")
        lib = library()
        if lib.mega_lane_const_cols() != self.LANE_CONST_COLS:
            raise RuntimeError("megakernel.cu lane-constant layout changed")
        nf, smem, in_smem = self.lane_buffer()
        out = PartState(
            pos=torch.empty_like(parts.pos),
            quat=torch.empty_like(parts.quat),
            lin_vel=torch.empty_like(parts.lin_vel),
            ang_vel=torch.empty_like(parts.ang_vel),
        )
        scratch = None if in_smem else torch.empty(
            (B, nf * self.K), dtype=torch.float32, device=dev
        )
        d = self._dev
        cfg = self.cfg
        ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mega_substeps(
                ptr(parts.pos), ptr(parts.quat), ptr(parts.lin_vel), ptr(parts.ang_vel),
                ptr(group), ptr(gscale),
                ptr(out.pos), ptr(out.quat), ptr(out.lin_vel), ptr(out.ang_vel),
                ptr(d["part_const"]), ptr(d["lane_const"]), ptr(d["lane_part"]),
                ptr(d["part_off"]), ptr(d["part_nfloor"]), ptr(d["part_ent"]),
                ptr(scratch),
                B, P, self.Kf, self.Kp, self.Ke, int(n), int(cfg.solver_iters),
                float(cfg.timestep), float(cfg.timestep * cfg.gravity),
                float(cfg.contact_slop), float(cfg.relaxation), float(cfg.max_velocity),
                THREADS, smem, ctypes.c_void_p(stream),
            )
        if err != 0:
            raise RuntimeError(
                "megakernel launch failed: " + lib.mega_error_string(err).decode()
            )
        self.launches += 1
        return out

    # -- work model (for the roofline bound) -----------------------------------

    def fp32_ops_per_env(self, n: int) -> int:
        """FP32 operations one env's block performs in a launch of ``n``
        substeps, counted from ``csrc/megakernel.cu`` (each add, multiply,
        min/max, compare, divide, square root, sin and cos counts one;
        index arithmetic does not). The count does not depend on the data:
        every lane runs every phase whatever its mask."""
        P, Kf, Kp, Ke, K = self.P, self.Kf, self.Kp, self.Ke, self.K
        E = len(self.part_ent)                   # (lane, side) entries
        Eb = E - K                               # side-b entries
        Kb = Kp + Ke                             # lanes with a b side
        iters = self.cfg.solver_iters
        parts = P * (QROT + 3 + QMAT + 2 * MAT3)            # 1. COM, R I R^T
        aggr = P * (P * 51 + 3 + INV3 + 3)                  # 2. group sums, inverse
        narrow = (                                          # 3. narrow phase
            Kf * (QROT + 4)
            + Kp * (4 * QROT + QMUL + 3 + 14 + 6 + 6)
            + Ke * (2 * QMUL + 2 * QROT + 6 + SAT)
        )
        prep = K * PREP_LANE                                # 3. solver prep
        counts = Ke * 16 + E + P * 5 + K * 12               # 4.-6.
        apply = E * APPLY_ENTRY + Eb * 3 + P * APPLY_PART   # 7. group velocities
        update = K * UPDATE_LANE + Kb * 15                  # 7. lambda update
        final = apply + P * INTEGRATE                       # 7. last pass
        floor = Kf * (QROT + 5) + P * P                     # 8. floor projection
        per_substep = parts + aggr + narrow + prep + counts + iters * (apply + update) + final + floor
        return int(n * per_substep)


# FP32 operations of the kernel's pieces, counted from csrc/megakernel.cu
CROSS = 9                     # 6 multiplies, 3 subtracts
QROT = 2 * CROSS + 3 * 4      # u x v, u x (u x v), v + 2 (w uv + uuv)
QMUL = 28
QMAT = 8 + 4 + 27             # norm, 4 divides, 9 entries
MAT3 = 45                     # 3x3 product: 27 multiplies, 18 adds
INV3 = 9 * 3 + 5 + 1 + 9      # cofactors, determinant, divide, scale
SAT = (
    2 * QMAT + 3 + 9 * 6      # axes, center offset, |a_i . b_j|
    + 6 * 17                  # 6 face axes: overlap, sign, normal
    + 9 * 71                  # 9 edge axes: cross, norm, radii, overlap
    + 3 * 16 + 40             # supporting-edge anchors, closest points
)
PREP_LANE = 6 + 26 + 3 * 65 + 5   # r_a, r_b; tangent basis; 3 effective masses; bias
APPLY_ENTRY = 18 + CROSS + 6      # impulse, torque, accumulation
APPLY_PART = 6 * 5 + 6 + 18       # warp sums; lv; av = ang + I^-1 tau
UPDATE_LANE = 12 + 15 + 10 + 6    # v_a; 3 projections; 3 lambda steps; cone clamp
INTEGRATE = 12 + 15 + 2 + 3 * 3 + QROT + 9 + QMUL + 12   # clamp; axis-angle; sin/cos; move; rotate
