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
* ``launches`` counts kernel launches, and nothing else;
  ``cluster_launches`` counts those of them that took the cluster route
  (the model's working set over the shared memory a block may have, spread
  over the shared memories of a thread-block cluster), so a caller can tell
  which route a model ran. ``layout`` says which route this model takes
  (:class:`KernelLayout`), from the model's bytes alone.

The kernel reads its lanes in *slot* order (:func:`slot_tables`): the lanes
sorted by their a-side part and dealt to the threads so that the lanes of a
segment of a warp share that part, padded with masked dummy slots. The
tables in lane order (``lane_const``, ``part_a``, ``part_ent`` ...) stay as
the description of the model; the permutation is built once, here, and for
the cluster route once more over the cluster's threads
(:func:`cluster_tables`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from .collide import attach_betas
from .engine import make_substep, substeps as plain_substeps
from .state import PartState

SOURCE = Path(__file__).resolve().parent / "csrc" / "megakernel.cu"
THREADS = 256
SEGMENT = 16   # csrc/megakernel.cu SEGW: threads of a warp that share a part
# dynamic shared memory a block may opt into on Hopper (227 KB)
MAX_SMEM = 232448
# the cluster route (csrc/megakernel.cu): threads a CTA, CTAs an env at most
CLUSTER_THREADS = 512
MAX_CLUSTER = 8
# csrc/physics_common.cuh: floats a part (PF), a partial sum or b entry (NCOL),
# a lane in memory (NF; NF_REGS with the rest in registers)
PART_FIELDS, SUM_COLUMNS, LANE_FLOATS, LANE_FLOATS_REGS = 60, 8, 24, 1
ROUTE_REGS, ROUTE_SMEM, ROUTE_CLUSTER = "regs", "smem", "cluster"

# lane kinds (csrc/physics_common.cuh LaneKind)
KIND_PAD, KIND_FLOOR, KIND_VERTEX, KIND_SAT, KIND_ROBOT1, KIND_ROBOT2 = range(6)
LANE_CONST_COLS = 24   # csrc/physics_common.cuh LC: 22 columns padded to 16-byte rows

_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)],
    np.float32,
)  # [8,3]

# slot-order tables handed to the kernels (:func:`slot_tables`)
SLOT_TABLES = (
    "slot_const", "slot_i", "seg_off", "b_off", "floor_off", "floor_slot", "sat_corner",
)

_libs = {}


def library(defines=()) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; with
    ``_cuda.PHASE_CLOCKS`` the phase-clock build of the same source."""
    if defines not in _libs:
        lib = _cuda.load(SOURCE, defines)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mega_substeps.argtypes = [vp] * 19 + [i] * 9 + [f] * 5 + [i, i, i, vp]
        lib.mega_substeps.restype = i
        lib.mega_cluster_substeps.argtypes = [vp] * 21 + [i] * 11 + [f] * 5 + [i, i, vp]
        lib.mega_cluster_substeps.restype = i
        lib.mega_error_string.argtypes = [i]
        lib.mega_error_string.restype = ctypes.c_char_p
        for fn in ("mega_lane_const_cols", "mega_segment_width", "mega_sum_columns",
                   "mega_part_fields", "mega_num_phases", "mega_max_b_entries",
                   "mega_max_cluster", "mega_cluster_threads"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.mega_lane_floats.argtypes = [i]
        lib.mega_lane_floats.restype = i
        lib.mega_resident_blocks.argtypes = [i] * 3
        lib.mega_resident_blocks.restype = i
        lib.mega_cluster_resident.argtypes = [i] * 3
        lib.mega_cluster_resident.restype = i
        lib.mega_barrier_probe.argtypes = [i, i, i, i, vp]
        lib.mega_barrier_probe.restype = i
        lib.mega_cluster_probe.argtypes = [i] * 6 + [vp]
        lib.mega_cluster_probe.restype = i
        got = (lib.mega_lane_const_cols(), lib.mega_segment_width(), lib.mega_max_b_entries(),
               lib.mega_part_fields(), lib.mega_sum_columns(), lib.mega_lane_floats(0),
               lib.mega_lane_floats(1), lib.mega_max_cluster(), lib.mega_cluster_threads())
        if got != (LANE_CONST_COLS, SEGMENT, MAX_B_ENTRIES, PART_FIELDS, SUM_COLUMNS,
                   LANE_FLOATS, LANE_FLOATS_REGS, MAX_CLUSTER, CLUSTER_THREADS):
            raise RuntimeError("megakernel.cu slot layout changed")
        _libs[defines] = lib
    return _libs[defines]


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
    ``lane_solver.launches``: one per substep. ``lane_tables`` are the
    kernel's static tables for this model (``lane_solver.LaneTables``), built
    once here."""

    def __init__(self, model_np, cfg_sim, device):
        self._substep = make_substep(model_np, cfg_sim, torch.device(device))
        self.lane_tables = self._substep.lane_tables

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
    """The static per-part lane lists in lane order: for each part its
    side-a lanes (floor lanes first) then its side-b lanes as
    ``(lane << 1) | side`` in ``part_ent`` with offsets ``part_off`` and the
    count of leading floor lanes ``part_nfloor``."""
    ent, off, nfloor = [], [0], []
    for p in range(P):
        a = np.flatnonzero(part_a == p)
        b = np.flatnonzero(part_b == p)
        ent.extend((a << 1).tolist() + ((b << 1) | 1).tolist())
        off.append(len(ent))
        nfloor.append(int(np.sum(a < Kf)))
    return (
        np.asarray(ent, np.int32),
        np.asarray(off, np.int32),
        np.asarray(nfloor, np.int32),
    )


MAX_B_ENTRIES = 8190   # csrc/physics_common.cuh: the b-buffer index has 13 bits


def pack_slot(part_a: int, part_b: int, kind: int, b_slot: int) -> int:
    """The packed word of a slot (csrc/physics_common.cuh ``pk_*``): a-side
    part, b-side part + 1, kind, b-buffer index + 1 (as an int32)."""
    word = (int(part_a) | ((int(part_b) + 1) << 8) | (int(kind) << 16)
            | ((int(b_slot) + 1) << 19))
    return word - (1 << 32) if word >= (1 << 31) else word


def slot_tables(part_a, part_b, kind, lane_const, aux0, aux1, n_floor, n_sat, P,
                threads: int, segw: int) -> dict:
    """The kernels' static tables in slot order.

    A block of ``threads`` threads has ``threads // segw`` segments; thread
    (warp ``w``, lane ``l``) belongs to segment ``w * (32 // segw) + l //
    segw`` and makes ``lpt`` rounds, round ``r`` on slot ``(w * lpt + r) * 32
    + l``. The lanes (given in lane order: floor lanes, vertex lanes pair
    block AB then BA, SAT lanes, then any robot lanes) are sorted by a-side
    part, stably, and each part gets whole segments, so every lane of a
    segment has the same ``part_a``; what is left of a part's last segment
    is padding (``lane_of_slot`` -1, kind ``KIND_PAD``). ``lpt`` is the
    least number of rounds with which the parts' segments fit the block.

    Returns ``lpt``, ``KS`` (slots), ``lane_of_slot`` [KS], ``slot_of_lane``
    [K], ``seg_off`` [P+1] (each part's range of segments), ``b_slot_of_lane``
    [K] (-1: no b side) and ``b_off`` [P+1] (the b-side buffer, ordered by
    b-side part), ``floor_slot`` [Kf] with ``floor_off`` [P+1], ``sat_corner``
    [Ke,16] (slots of each SAT lane's 16 vertex lanes: lanes ``Kf + e*8 + j``
    and ``Kf + (Ke+e)*8 + j``), ``slot_i`` [KS,4] int32 (the packed word of
    :func:`pack_slot`, ``aux0``, ``aux1``, 0) and ``slot_const`` [KS,24]."""
    part_a = np.asarray(part_a, int)
    part_b = np.asarray(part_b, int)
    K = len(part_a)
    if P > 254:
        raise ValueError(f"the kernels pack a part index into 8 bits, model has {P} parts")
    nseg = threads // segw
    counts = np.bincount(part_a, minlength=P)
    if np.count_nonzero(counts) > nseg:
        raise ValueError(
            f"{np.count_nonzero(counts)} parts with lanes need a segment each, a block of "
            f"{threads} threads has {nseg}"
        )
    lpt = 1
    while sum(-(-int(n) // (segw * lpt)) for n in counts) > nseg:
        lpt += 1
    KS = threads * lpt
    per_warp = 32 // segw

    def segment_slots(seg):
        w, h = divmod(seg, per_warp)
        return [(w * lpt + r) * 32 + h * segw + j for r in range(lpt) for j in range(segw)]

    lane_of_slot = np.full(KS, -1, int)
    seg_off = [0]
    seg = 0
    for p_ in range(P):
        lanes = np.flatnonzero(part_a == p_)
        for start in range(0, len(lanes), segw * lpt):
            chunk = lanes[start : start + segw * lpt]
            lane_of_slot[segment_slots(seg)[: len(chunk)]] = chunk
            seg += 1
        seg_off.append(seg)
    slot_of_lane = np.full(K, -1, int)
    used = np.flatnonzero(lane_of_slot >= 0)
    slot_of_lane[lane_of_slot[used]] = used

    b_lanes = np.flatnonzero(part_b >= 0)
    b_lanes = b_lanes[np.argsort(part_b[b_lanes], kind="stable")]
    b_slot_of_lane = np.full(K, -1, int)
    b_slot_of_lane[b_lanes] = np.arange(len(b_lanes))
    b_off = np.concatenate([[0], np.cumsum(np.bincount(part_b[b_lanes], minlength=P))])

    floor_lanes = np.arange(n_floor)
    floor_lanes = floor_lanes[np.argsort(part_a[:n_floor], kind="stable")]
    floor_off = np.concatenate([[0], np.cumsum(np.bincount(part_a[:n_floor], minlength=P))])
    corner_lanes = np.array(
        [[n_floor + e * 8 + j for j in range(8)] + [n_floor + (n_sat + e) * 8 + j for j in range(8)]
         for e in range(n_sat)], int,
    ).reshape(n_sat, 16)

    if len(b_lanes) > MAX_B_ENTRIES:
        raise ValueError(f"{len(b_lanes)} lanes with a b side, the kernels index {MAX_B_ENTRIES}")
    slot_i = np.zeros((KS, 4), np.int32)
    slot_i[:, 0] = pack_slot(0, -1, KIND_PAD, -1)
    slot_i[used, 0] = [
        pack_slot(part_a[k], part_b[k], kind[k], b_slot_of_lane[k]) for k in lane_of_slot[used]
    ]
    slot_i[used, 1] = np.asarray(aux0, int)[lane_of_slot[used]]
    slot_i[used, 2] = np.asarray(aux1, int)[lane_of_slot[used]]
    slot_const = np.zeros((KS, LANE_CONST_COLS), np.float32)
    slot_const[used, : lane_const.shape[1]] = lane_const[lane_of_slot[used]]
    return dict(
        lpt=lpt, KS=KS, lane_of_slot=lane_of_slot, slot_of_lane=slot_of_lane,
        seg_off=np.asarray(seg_off, np.int32), b_slot_of_lane=b_slot_of_lane,
        b_off=b_off.astype(np.int32), floor_slot=slot_of_lane[floor_lanes].astype(np.int32),
        floor_off=floor_off.astype(np.int32),
        sat_corner=slot_of_lane[corner_lanes].astype(np.int32).reshape(n_sat, 16),
        slot_i=slot_i, slot_const=slot_const,
    )


def _align4(words: int) -> int:
    return (words + 3) & ~3


def group_words(P: int, nseg: int, nbs: int) -> int:
    """Words of a block's group labels and lists (csrc/physics_common.cuh
    ``group_words``): labels, first members, offsets, members, count, entry
    offsets, and one entry a segment partial or b entry."""
    return _align4(5 * P + 3 + nseg + nbs)


def block_words(P: int, Kf: int, Ke: int, KS: int, NBS: int, regs: bool,
                threads: int = THREADS) -> int:
    """Words of dynamic shared memory the one-block kernel takes (the
    launcher in csrc/megakernel.cu refuses fewer): part fields, group lists,
    segment partials, the staged tables (``TableLayout``), the b buffer and
    the lanes' working set (only their masks with one lane a thread)."""
    nseg = threads // SEGMENT
    tables = _align4(3 * (P + 1) + 17 * Ke + (0 if regs else KS) + 3 * Kf)
    return (PART_FIELDS * P + group_words(P, nseg, NBS) + SUM_COLUMNS * nseg + tables
            + SUM_COLUMNS * NBS + (LANE_FLOATS_REGS if regs else LANE_FLOATS) * KS)


def cluster_words(P: int, Kf: int, KS: int, nseg: int, NBS: int, NJ: int, C: int) -> int:
    """Words of dynamic shared memory a CTA of the cluster route takes
    (csrc/megakernel.cu ``ClusterLayout``): part fields, the exchange's two
    mbarriers, group lists over the jobs, the double-buffered group partials
    of the cluster's ``C`` CTAs, the job results and their live entries, the
    staged tables (slot words, jobs, floor corners), the CTA's segment
    partials and b entries and its lanes' working set."""
    words = (PART_FIELDS * P + 4 + group_words(P, NJ, 0) + 2 * C * SUM_COLUMNS * P
             + SUM_COLUMNS * NJ + NJ + KS + NJ + 3 * (P + 1) + 3 * Kf)
    return _align4(words) + SUM_COLUMNS * (nseg + NBS) + LANE_FLOATS * KS


def _jobs(ranges, octets: int) -> tuple:
    """Split ``ranges`` (per part, a list of ``(first entry, count)``) into
    jobs of at most ``J`` entries, the least odd ``J`` that gives no more jobs
    than ``octets`` (or one a range, if there are more ranges): ``(jobs
    packed as first | count << 16, each part's range of jobs [P+1])``. The
    four octets of a warp take four jobs in a row; an odd ``J`` puts their
    entries (8 words each) on different banks of shared memory."""
    total = sum(n for part in ranges for _, n in part)
    J = max(1, -(-total // octets)) | 1
    count = lambda J: sum(-(-n // J) for part in ranges for _, n in part)
    while count(J) > octets and J < total:
        J += 2
    jobs, off = [], [0]
    for part in ranges:
        for first, n in part:
            for j in range(0, n, J):
                jobs.append((first + j) | (min(J, n - j) << 16))
        off.append(len(jobs))
    return jobs, off


def cluster_tables(part_a, part_b, kind, lane_const, aux0, aux1, n_floor, n_sat, P,
                   threads: int, C: int, segw: int) -> dict:
    """The tables of the cluster route: the lanes laid out as
    :func:`slot_tables` lays them for one block of ``C * threads`` threads,
    CTA ``r`` of the cluster taking its slots ``[r KS, (r+1) KS)`` (``KS`` =
    ``threads * lpt`` a CTA) and its segments ``[r NSEG, (r+1) NSEG)``
    (``NSEG = threads // segw``), with the b sides of those lanes.

    Returns slot_tables' ``lpt``, ``lane_of_slot``, ``slot_of_lane``,
    ``seg_off``, ``slot_const``, ``floor_off`` and ``floor_slot`` (over the
    env's ``C * KS`` slots), and: ``C``, ``KS`` (a CTA's slots); ``slot_i``
    whose packed words carry each lane's index in its CTA's own b buffer
    (the CTA's lanes with a b side, by b-side part; ``b_off`` [C,P+1] each
    part's range there, ``NBS`` the most entries of any CTA); ``sat_corner``
    [Ke,16] the corner lanes of each SAT lane as ``rank << 16 | slot in its
    CTA``; ``sat_off`` [C+1] and ``sat_list`` the SAT lanes' slots in their
    CTA, CTA by CTA; ``jobs`` [C,NJ] and ``job_off`` [C,P+1]: each CTA's
    entries (its segment partials ``0..NSEG-1``, then its b entries from
    ``NSEG`` on) cut into runs of one part each, of about equal length, no
    more than ``threads // 8`` a CTA where it can (packed ``first | count <<
    16``), ordered by part, each part's range of them."""
    part_a = np.asarray(part_a, int)
    part_b = np.asarray(part_b, int)
    kind = np.asarray(kind, int)
    K = len(part_a)
    sl = slot_tables(part_a, part_b, kind, lane_const, aux0, aux1, n_floor, n_sat, P,
                     threads * C, segw)
    KS, nseg = threads * sl["lpt"], threads // segw
    lane_of_slot = sl["lane_of_slot"]
    used = np.flatnonzero(lane_of_slot >= 0)
    rank = np.empty(K, int)
    rank[lane_of_slot[used]] = used // KS
    local_b = np.full(K, -1)
    b_off = np.zeros((C, P + 1), np.int32)
    for r in range(C):
        lanes = np.flatnonzero((part_b >= 0) & (rank == r))
        lanes = lanes[np.argsort(part_b[lanes], kind="stable")]
        local_b[lanes] = np.arange(len(lanes))
        b_off[r, 1:] = np.cumsum(np.bincount(part_b[lanes], minlength=P))
    NBS = int(b_off[:, -1].max())
    if NBS > MAX_B_ENTRIES:
        raise ValueError(f"{NBS} lanes with a b side in a CTA, the kernel indexes {MAX_B_ENTRIES}")
    slot_i = sl["slot_i"].copy()
    slot_i[used, 0] = [
        pack_slot(part_a[k], part_b[k], kind[k], local_b[k]) for k in lane_of_slot[used]
    ]
    sat_slots = np.sort(sl["slot_of_lane"][kind == KIND_SAT])
    sat_off = np.searchsorted(sat_slots // KS, np.arange(C + 1)).astype(np.int32)
    corner = sl["sat_corner"]
    seg_off = sl["seg_off"]
    jobs, job_off = [], []
    for r in range(C):
        ranges = []
        for q in range(P):
            s0, s1 = (int(np.clip(seg_off[x] - r * nseg, 0, nseg)) for x in (q, q + 1))
            ranges.append([(s0, s1 - s0), (nseg + int(b_off[r, q]), int(b_off[r, q + 1] - b_off[r, q]))])
        j, o = _jobs(ranges, threads // SUM_COLUMNS)
        jobs.append(j)
        job_off.append(o)
    NJ = max(len(j) for j in jobs)
    return dict(
        lpt=sl["lpt"], C=C, KS=KS, NBS=NBS, NJ=NJ, lane_of_slot=lane_of_slot,
        slot_of_lane=sl["slot_of_lane"], seg_off=seg_off, b_off=b_off,
        slot_const=sl["slot_const"], slot_i=slot_i, floor_off=sl["floor_off"],
        floor_slot=sl["floor_slot"],
        sat_corner=(((corner // KS) << 16) | (corner % KS)).astype(np.int32),
        sat_off=sat_off, sat_list=(sat_slots % KS).astype(np.int32),
        jobs=np.array([j + [0] * (NJ - len(j)) for j in jobs], np.int32),
        job_off=np.asarray(job_off, np.int32),
    )


class KernelLayout(NamedTuple):
    """How kernel 1 runs a model: ``route`` (``ROUTE_REGS``: one lane a
    thread, its working set in registers; ``ROUTE_SMEM``: lanes looped over,
    their working set in a block's shared memory; ``ROUTE_CLUSTER``: one env
    on a thread-block cluster whose CTAs' shared memories share the working
    set), ``threads`` a block (a CTA), ``cluster`` CTAs an env (1 but on the
    cluster route) and ``smem`` dynamic shared bytes a block."""

    route: str
    threads: int
    cluster: int
    smem: int


# tables of the cluster route handed to the kernel, beside part_const
CLUSTER_TABLES = (
    "slot_const", "slot_i", "floor_off", "floor_slot", "sat_corner", "sat_off", "sat_list",
    "jobs", "job_off",
)


def check_inputs(want: dict, dev) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` is a contiguous
    CUDA tensor of that shape and dtype on ``dev``."""
    for name, (t, shape, dtype) in want.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class MegaPhysics:
    """Constant tables and wrapper of the free-part kernel for one model."""

    LANE_GEOM_COLS = 22  # geometry (20), friction, beta; the kernel pads to LANE_CONST_COLS

    def __init__(self, model_np, cfg_sim, device):
        self.cfg = cfg_sim
        self.model_np = model_np   # to build plain versions under another SimConfig
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # tensors report a concrete index; compare against the same
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.launches = 0
        self.cluster_launches = 0

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
        lc = np.zeros((self.K, self.LANE_GEOM_COLS), np.float32)
        lc[: self.Kf, 0:3] = self.lf_corner
        lc[self.Kf : self.Kf + self.Kp, 0:13] = self.lp_const
        lc[self.Kf + self.Kp :, 0:10] = self.ep_a
        lc[self.Kf + self.Kp :, 10:20] = self.ep_b
        lc[:, 20] = self.lane_fric
        lc[:, 21] = self.lane_beta
        self.lane_const = lc
        self.part_ent, self.part_off, self.part_nfloor = lane_lists(
            self.part_a, self.part_b, self.Kf, P
        )
        # the same tables in slot order, for the kernel
        self.lane_kind = np.concatenate([
            np.full(self.Kf, KIND_FLOOR), np.full(self.Kp, KIND_VERTEX),
            np.full(self.Ke, KIND_SAT),
        ])
        self._aux0 = np.concatenate([np.zeros(self.Kf + self.Kp, int), np.arange(self.Ke)])
        self.slots = slot_tables(
            self.part_a, self.part_b, self.lane_kind, lc, self._aux0,
            np.zeros(self.K, int), self.Kf, self.Ke, P, THREADS, SEGMENT,
        )
        self.cluster = None   # the cluster route's tables (cluster_tables), if it takes it
        self.layout = self._choose_layout()
        tables = SLOT_TABLES if self.cluster is None else CLUSTER_TABLES
        source = self.slots if self.cluster is None else self.cluster
        self._dev = {"part_const": torch.as_tensor(pc, device=self.device)}
        self._dev.update(
            (name, torch.as_tensor(source[name], device=self.device).contiguous())
            for name in tables
        )
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

    def _choose_layout(self) -> KernelLayout:
        """The route from the model's bytes (nothing else decides it): one lane
        a thread where the lanes fit the block's threads; else the lanes'
        working set in the block's shared memory where it fits
        ``MAX_SMEM``; else the cluster route on the fewest CTAs (2 to
        ``MAX_CLUSTER``) whose share of the working set fits each CTA
        (sets ``self.cluster``)."""
        sl = self.slots
        regs = sl["lpt"] == 1
        smem = 4 * block_words(self.P, self.Kf, self.Ke, sl["KS"], int(sl["b_off"][-1]), regs)
        if regs or smem <= MAX_SMEM:
            return KernelLayout(ROUTE_REGS if regs else ROUTE_SMEM, THREADS, 1, smem)
        for C in range(2, MAX_CLUSTER + 1):
            ct = cluster_tables(
                self.part_a, self.part_b, self.lane_kind, self.lane_const, self._aux0,
                np.zeros(self.K, int), self.Kf, self.Ke, self.P, CLUSTER_THREADS, C, SEGMENT,
            )
            smem = 4 * cluster_words(self.P, self.Kf, ct["KS"], CLUSTER_THREADS // SEGMENT,
                                     ct["NBS"], ct["NJ"], C)
            if smem <= MAX_SMEM:
                self.cluster = ct
                return KernelLayout(ROUTE_CLUSTER, CLUSTER_THREADS, C, smem)
        raise ValueError(f"model's lanes ({self.K}) do not fit a cluster of {MAX_CLUSTER} CTAs")

    # -- what the latency floor is worked out from ------------------------------

    def resident_blocks(self) -> int:
        """Blocks of the one-block kernel an SM holds for this model (from the
        registers, the block size and the shared memory of the build); on the
        cluster route, the clusters the card holds at once."""
        lay = self.layout
        lib = library()
        if lay.route == ROUTE_CLUSTER:
            n = lib.mega_cluster_resident(lay.cluster, lay.threads, lay.smem)
        else:
            n = lib.mega_resident_blocks(int(lay.route == ROUTE_REGS), lay.threads, lay.smem)
        if n <= 0:
            raise RuntimeError("the occupancy query of megakernel.cu failed")
        return n

    def barrier_probe(self, blocks: int, n: int) -> None:
        """Launch ``blocks`` blocks of the kernel's size and shared memory
        that pass ``n`` bare block barriers: timed, a launch over ``n`` is a
        barrier's round trip at that occupancy. Not counted in ``launches``."""
        self._probe(lambda lib, stream: lib.mega_barrier_probe(
            int(blocks), self.layout.threads, self.layout.smem, int(n), stream))

    def cluster_probe(self, clusters: int, n: int, groups: int = 0) -> None:
        """Launch ``clusters`` clusters of the cluster route's shape (the
        cluster route only) that pass ``n`` bare cluster barriers, or with
        ``groups`` make ``n`` exchanges of that many group partials, a pass's
        exchange and nothing else: timed, a launch over ``n`` is one's round
        trip at that occupancy. Not counted in ``launches``."""
        lay = self.layout
        self._probe(lambda lib, stream: lib.mega_cluster_probe(
            int(clusters), lay.cluster, lay.threads, lay.smem, int(n), int(groups), stream))

    def _probe(self, launch) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = launch(library(), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError("barrier probe failed: " + library().mega_error_string(err).decode())

    def kernel_substeps(self, parts: PartState, group, gscale, n: int) -> PartState:
        """One launch of the CUDA kernel; raises on anything it cannot take."""
        out, _ = self._launch((), parts, group, gscale, n)
        self.launches += 1
        self.cluster_launches += int(self.cluster is not None)
        return out

    def phase_clocks(self, parts: PartState, group, gscale, n: int):
        """Clock cycles per phase of the substep loop, ``[B, phases]`` int64:
        one launch of the phase-clock build of the kernel (the same source
        with ``-DFT_PHASE_CLOCKS``), in which thread 0 of each block (of
        CTA 0 of each cluster) adds up the card's clock between barriers and,
        in the last column, counts the block barriers the loop passed (on the
        cluster route column 6 counts its cluster barriers). A measuring aid:
        its results are not used and it is not counted in ``launches``."""
        return self._launch(_cuda.PHASE_CLOCKS, parts, group, gscale, n)[1]

    def _launch(self, defines, parts: PartState, group, gscale, n: int):
        """Check the inputs, then launch the build of the kernel with
        ``defines``: ``(result, phase clocks or None)``."""
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
        check_inputs(want, dev)
        if P != self.P:
            raise ValueError(f"model has {self.P} parts, state has {P}")
        if dev != self.device:
            raise ValueError(f"tables live on {self.device}, state on {dev}")
        lib = library(defines)
        clocks = None
        if defines == _cuda.PHASE_CLOCKS:
            clocks = torch.zeros((B, lib.mega_num_phases()), dtype=torch.int64, device=dev)
        out = PartState(
            pos=torch.empty_like(parts.pos),
            quat=torch.empty_like(parts.quat),
            lin_vel=torch.empty_like(parts.lin_vel),
            ang_vel=torch.empty_like(parts.ang_vel),
        )
        d, cfg, lay = self._dev, self.cfg, self.layout
        ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
        state = [ptr(parts.pos), ptr(parts.quat), ptr(parts.lin_vel), ptr(parts.ang_vel),
                 ptr(group), ptr(gscale), ptr(out.pos), ptr(out.quat), ptr(out.lin_vel),
                 ptr(out.ang_vel), ptr(d["part_const"])]
        sim = [int(n), int(cfg.solver_iters), float(cfg.timestep),
               float(cfg.timestep * cfg.gravity), float(cfg.contact_slop),
               float(cfg.relaxation), float(cfg.max_velocity)]
        with torch.cuda.device(dev):
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
            if self.cluster is None:
                sl = self.slots
                err = lib.mega_substeps(
                    *state, *(ptr(d[name]) for name in SLOT_TABLES), ptr(clocks),
                    B, P, sl["KS"], sl["lpt"], int(sl["b_off"][-1]), self.Kf, self.Ke, *sim,
                    lay.threads, lay.smem, int(lay.route == ROUTE_REGS), stream,
                )
            else:
                ct = self.cluster
                err = lib.mega_cluster_substeps(
                    *state, *(ptr(d[name]) for name in CLUSTER_TABLES), ptr(clocks),
                    B, P, ct["KS"], ct["lpt"], self.Kf, self.Ke, ct["NBS"], ct["NJ"], ct["C"],
                    *sim, lay.threads, lay.smem, stream,
                )
        if err != 0:
            raise RuntimeError(
                "megakernel launch failed: " + lib.mega_error_string(err).decode()
            )
        return out, clocks

    # -- work model (for the roofline bound) -----------------------------------

    def fp32_ops_per_env(self, n: int) -> int:
        """FP32 operations of the *function* for one env in a launch of ``n``
        substeps, as ``engine.py`` does it: per solver pass one impulse
        application per (lane, side) entry of the per-part lists and one
        lambda update per lane (each add, multiply, min/max, compare, divide,
        square root, sin and cos counts one; index arithmetic does not).
        This is the yardstick of the roofline bound and does not follow the
        kernel's layout: a redesign of ``csrc/megakernel.cu`` that shares
        work between entries changes the kernel's time, not this count. The
        count does not depend on the data: every lane runs every phase
        whatever its mask."""
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


# FP32 operations of the function's pieces (see MegaPhysics.fp32_ops_per_env)
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
