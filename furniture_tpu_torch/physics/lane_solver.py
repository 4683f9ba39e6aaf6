"""The lane contact solver: the whole lane solve as one kernel launch.

The port's counterpart of ``furniture_tpu.physics.pallas_solver``
(``solve_contacts_pallas`` with its Pallas ``_kernel``), selected with
``SimConfig(use_pallas="lane")``. One launch of ``csrc/lane_solver.cu``
takes the raw contacts (point, normal, depth, mask, ``vel_b``) and the group
aggregates, does the per-lane preparation in registers and runs ``iters``
cold-started Jacobi sweeps, one thread block per env (see the note at the
top of the ``.cu`` file).

* :func:`solve_contacts_lane` launches the kernel for CUDA tensors and runs
  :func:`plain_solve_contacts_lane` for CPU tensors. There is no fallback:
  any other device, a call on the card without the model's tables, or a
  kernel that fails to build or launch, raises. On the card it makes one
  launch, runs no PyTorch around it and does not synchronise the host.
* :func:`plain_solve_contacts_lane` is the plain PyTorch version:
  ``engine.lane_prep``, then ``lambda`` from zero with the part velocities
  updated incrementally, sweep by sweep, by the masked increment
  ``(lambda_new - lambda) * fmask``. ``engine._solve_contacts``, the
  warm-started solver of the other two kernels, recomputes the velocities
  from all of ``lambda`` each sweep instead; cold-started, the two agree to
  summation order.
* :class:`LaneTables` are the kernel's static tables for one model's lanes:
  the lanes in *slot* order (sorted by a-side part, ``megakernel.slot_tables``),
  the b-side buffer order, friction and beta. ``engine.make_substep`` builds
  them once, when the model is set up, and passes them to every solve
  (``LanePhysics.lane_tables``), so the step path makes no host copy.
* ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from .. import transforms as T
from .collide import Contacts
from .engine import lane_prep
from .megakernel import KIND_VERTEX, slot_tables

SOURCE = Path(__file__).resolve().parent / "csrc" / "lane_solver.cu"
# csrc/lane_solver.cu Route: a lane a thread in registers, or the lanes in a
# global scratch buffer with rounds of slots a thread
ROUTE_REGS, ROUTE_MEMORY = 0, 1
ROUTE_NAMES = ("registers, 1 lane a thread", "global scratch")
THREADS = 256      # csrc/lane_solver.cu THREADS: a block, both routes
SEGMENT_WIDTH = 16  # slots of a segment
SEGMENTS = 16      # csrc/lane_solver.cu NSEG
MAX_ROUNDS = 64    # csrc/lane_solver.cu MAX_ROUNDS
MAX_PARTS = 32     # csrc/lane_solver.cu MAX_PARTS: one lane of a warp a part
MAX_ENTRIES = 32766   # csrc/lane_solver.cu MAX_ENTRIES: b entries
ENTRY_FOLDED = 1 << 30   # csrc/lane_solver.cu: the slot's octet folds its b sides
OCTET = 8

# kernel launches made by solve_contacts_lane since import (or since a
# caller last set it to 0)
launches = 0

_libs = {}


def library(defines=()) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; with
    ``_cuda.PHASE_CLOCKS`` the phase-clock build of the same source."""
    if defines not in _libs:
        lib = _cuda.load(SOURCE, defines)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lane_solve.argtypes = [vp] * 19 + [i] * 8 + [f] * 3 + [vp]
        lib.lane_solve.restype = i
        lib.lane_error_string.argtypes = [i]
        lib.lane_error_string.restype = ctypes.c_char_p
        for fn in ("lane_num_phases", "lane_segments", "lane_max_rounds", "lane_max_parts",
                   "lane_max_entries", "lane_threads"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        for fn, n in (("lane_smem_bytes", 3), ("lane_scratch_floats", 3),
                      ("lane_resident_blocks", 2)):
            getattr(lib, fn).argtypes = [i] * n
            getattr(lib, fn).restype = i
        lib.lane_barrier_probe.argtypes = [i, i, i, vp]
        lib.lane_barrier_probe.restype = i
        if (lib.lane_segments(), lib.lane_max_rounds(), lib.lane_max_parts(), lib.lane_max_entries(),
                lib.lane_threads()) != (SEGMENTS, MAX_ROUNDS, MAX_PARTS, MAX_ENTRIES, THREADS):
            raise RuntimeError("lane_solver.cu slot layout changed")
        _libs[defines] = lib
    return _libs[defines]


def plain_solve_contacts_lane(
    contacts: Contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
    dt: float, iters: int, relaxation: float, slop: float,
):
    """The plain PyTorch version of the kernel, on any device: ``iters``
    cold-started sweeps with incrementally updated velocities. Returns
    ``(lin_vel, ang_vel)`` [B,P,3]."""
    c = contacts
    pa, pb, hb, r_a, r_b, dirs, inv_w, bias, fmask, lane_scale, mem_a, mem_b = lane_prep(
        c, group, g_com, g_inv_mass, g_inv_inertia, dt, relaxation, slop
    )
    mem_ab_t = (mem_a - mem_b).transpose(1, 2)                      # [B,P,K]
    mem_a_t = mem_a.transpose(1, 2)
    mem_b_t = mem_b.transpose(1, 2)
    fric = c.friction
    lam = torch.zeros_like(inv_w)                                   # [B,K,3]
    lv, av = lin_vel, ang_vel
    for _ in range(iters):
        va = lv[:, pa] + T.cross(av[:, pa], r_a)
        vb = (lv[:, pb] + T.cross(av[:, pb], r_b)) * hb[:, None]
        if c.vel_b is not None:
            vb = vb + c.vel_b
        v_rel = va - vb
        vd = torch.sum(v_rel[:, :, None, :] * dirs, dim=-1)         # [B,K,3]
        target = torch.stack([vd[..., 0] + bias, vd[..., 1], vd[..., 2]], -1)
        lam_try = lam - target * inv_w * lane_scale[..., None]
        ln = torch.clamp(lam_try[..., 0], min=0.0)
        max_f = (fric * ln)[..., None]
        lt = torch.minimum(torch.maximum(lam_try[..., 1:], -max_f), max_f)
        lam_new = torch.cat([ln[..., None], lt], dim=-1)
        dlam = (lam_new - lam) * fmask[..., None]
        lam = lam_new
        # the increment's impulse on every part of both sides' groups
        imp = torch.sum(dlam[..., None] * dirs, dim=2)              # [B,K,3]
        tq_a = T.cross(r_a, imp)
        tq_b = T.cross(r_b, -imp)
        dlin = (mem_ab_t @ imp) * g_inv_mass[..., None]             # [B,P,3]
        ang_acc = mem_a_t @ tq_a + mem_b_t @ tq_b
        dang = torch.sum(g_inv_inertia * ang_acc[:, :, None, :], dim=-1)
        lv = lv + dlin
        av = av + dang
    return lv, av


class LaneTables:
    """The lane solver's static tables for one model's lanes and part count.

    ``route`` None takes ``ROUTE_REGS`` where the lanes fit one a thread,
    else the global-scratch route; ``ROUTE_MEMORY`` forces the latter, so
    that the checks run it on a small model too. The lanes are sorted by
    a-side part into slots (``megakernel.slot_tables``: 16 segments a
    block, every slot of a segment on one part, padded with empty slots). The b sides go to
    entries of the b buffer ordered by b-side part: an octet (8 consecutive
    slots) whose lanes with a side b (at least two) all have it on one part
    folds them into one entry, every other lane with a side b has its own.

    Host tables: ``lane_of_slot`` [KS] (-1: padding), ``seg_off`` [P+1],
    ``b_off`` [P+1], ``b_entry_of_lane`` [K] (-1: no b side),
    ``entry_folded`` [NBE]; on ``device``: ``slot_i`` [KS,4] int32 (lane,
    part a, part b, b entry word: the entry, with ``ENTRY_FOLDED`` set on
    every slot of a folded octet, -1 none) and ``slot_f`` [KS,2] float32
    (friction, beta) in slot order, ``seg_off``, ``b_off``."""

    def __init__(self, part_a, part_b, friction, beta, P: int, route=None, device="cpu"):
        part_a = np.asarray(part_a, np.int64)
        part_b = np.asarray(part_b, np.int64)
        K = len(part_a)
        if P > MAX_PARTS:
            raise ValueError(f"the lane solver takes at most {MAX_PARTS} parts, got {P}")
        st = slot_tables(part_a, part_b, np.full(K, KIND_VERTEX), np.zeros((K, 0), np.float32),
                         np.zeros(K, int), np.zeros(K, int), 0, 0, P, THREADS, SEGMENT_WIDTH)
        if route is None:
            route = ROUTE_REGS if st["lpt"] == 1 else ROUTE_MEMORY
        if route == ROUTE_REGS and st["lpt"] != 1:
            raise ValueError(f"{K} lanes do not fit route {ROUTE_NAMES[route]}")
        if st["lpt"] > MAX_ROUNDS:
            raise ValueError(f"{K} lanes need {st['lpt']} rounds a thread, at most {MAX_ROUNDS}")
        self.route, self.K, self.P = route, K, P
        self.lpt, self.KS = st["lpt"], st["KS"]
        self.lane_of_slot = lanes = st["lane_of_slot"]
        self.seg_off_np = st["seg_off"]
        used = lanes >= 0
        # the b entries: (b part, first slot, slots), ordered by b part
        pb_slot = np.where(used, part_b[np.maximum(lanes, 0)], -1)
        entries = []
        for o in range(self.KS // OCTET):
            slots = np.arange(o * OCTET, (o + 1) * OCTET)
            with_b = slots[pb_slot[slots] >= 0]
            if len(with_b) >= 2 and np.all(pb_slot[with_b] == pb_slot[with_b[0]]):
                entries.append((pb_slot[with_b[0]], slots[0], slots, True))
            else:
                entries.extend((pb_slot[k], k, [k], False) for k in with_b)
        entries.sort(key=lambda e: (e[0], e[1]))
        self.NBE = len(entries)
        if self.NBE > MAX_ENTRIES:
            raise ValueError(f"{self.NBE} b entries, the kernel takes {MAX_ENTRIES}")
        word = np.full(self.KS, -1, np.int64)
        self.entry_folded = np.array([e[3] for e in entries], bool)
        for i, (_, _, slots, folded) in enumerate(entries):
            word[slots] = i | (ENTRY_FOLDED if folded else 0)
        self.b_entry_of_lane = np.full(K, -1, np.int64)
        with_b = used & (pb_slot >= 0)
        self.b_entry_of_lane[lanes[with_b]] = word[with_b] & (ENTRY_FOLDED - 1)
        self.b_off_np = np.concatenate(
            [[0], np.cumsum(np.bincount([e[0] for e in entries], minlength=P))]
        ).astype(np.int32)
        si = np.zeros((self.KS, 4), np.int32)
        si[:, 0] = lanes
        si[:, 2] = -1
        si[used, 1] = part_a[lanes[used]]
        si[used, 2] = part_b[lanes[used]]
        si[:, 3] = word
        sf = np.zeros((self.KS, 2), np.float32)
        sf[used, 0] = np.asarray(friction, np.float32)[lanes[used]]
        sf[used, 1] = np.asarray(beta, np.float32)[lanes[used]]
        self.slot_i_np, self.slot_f_np = si, sf
        dev = torch.device(device)
        self.device = dev
        self.slot_i = torch.as_tensor(si, device=dev)
        self.slot_f = torch.as_tensor(sf, device=dev)
        self.seg_off = torch.as_tensor(self.seg_off_np, device=dev)
        self.b_off = torch.as_tensor(self.b_off_np, device=dev)

    @classmethod
    def of(cls, contacts: Contacts, P: int, route=None) -> "LaneTables":
        """The tables of these contacts' static fields (``part_a``,
        ``part_b``, ``friction``, ``beta``) on their device: one host copy,
        so a set-up step, not a step-path one."""
        c = contacts
        return cls(*(t.detach().cpu().numpy() for t in (c.part_a, c.part_b, c.friction, c.beta)),
                   P, route, device=c.part_a.device)

    def table_bytes(self) -> int:
        """Bytes of the static tables a launch reads (shared by all envs)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.slot_i, self.slot_f, self.seg_off, self.b_off))

    def smem_bytes(self) -> int:
        return library().lane_smem_bytes(self.P, self.NBE, self.route)

    def resident_blocks(self) -> int:
        """Blocks of this route's kernel an SM holds (registers, block size
        and shared memory of the build)."""
        n = library().lane_resident_blocks(self.route, self.smem_bytes())
        if n <= 0:
            raise RuntimeError("the occupancy query of lane_solver.cu failed")
        return n

    def barrier_probe(self, blocks: int, n: int) -> None:
        """Launch ``blocks`` blocks of the kernel's size with this route's
        shared memory that pass ``n`` bare block barriers: timed, a launch
        over ``n`` is a barrier's round trip at that occupancy. Not counted
        in ``launches``."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = library().lane_barrier_probe(int(blocks), self.smem_bytes(), int(n),
                                               ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError("barrier probe failed: " + library().lane_error_string(err).decode())


def launch(tables: LaneTables, contacts: Contacts, group, g_com, g_inv_mass, g_inv_inertia,
           lin_vel, ang_vel, dt: float, iters: int, relaxation: float, slop: float,
           defines=()):
    """One launch of the kernel (the build with ``defines``); raises on
    anything it cannot take. Returns ``(lin_vel, ang_vel, clocks)``, clocks
    [B, phases + 1] int64 from the phase-clock build, else None. Only the
    plain build is counted in ``launches``."""
    global launches
    c = contacts
    B, P = group.shape
    K = c.depth.shape[1]
    dev = lin_vel.device
    if tables.K != K or tables.P != P or tables.device != dev:
        raise ValueError(f"tables for K={tables.K} P={tables.P} on {tables.device}, "
                         f"got K={K} P={P} on {dev}")
    want = {
        "point": (c.point, (B, K, 3), torch.float32),
        "normal": (c.normal, (B, K, 3), torch.float32),
        "depth": (c.depth, (B, K), torch.float32),
        "mask": (c.mask, (B, K), torch.bool),
        "group": (group, (B, P), torch.int32),
        "g_com": (g_com, (B, P, 3), torch.float32),
        "g_inv_mass": (g_inv_mass, (B, P), torch.float32),
        "g_inv_inertia": (g_inv_inertia, (B, P, 3, 3), torch.float32),
        "lin_vel": (lin_vel, (B, P, 3), torch.float32),
        "ang_vel": (ang_vel, (B, P, 3), torch.float32),
    }
    if c.vel_b is not None:
        want["vel_b"] = (c.vel_b, (B, K, 3), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = library(defines)
    clocks = None
    if defines == _cuda.PHASE_CLOCKS:
        clocks = torch.zeros((B, lib.lane_num_phases()), dtype=torch.int64, device=dev)
    per_env = lib.lane_scratch_floats(tables.KS, tables.NBE, tables.route)
    scratch = torch.empty((B, per_env), dtype=torch.float32, device=dev) if per_env else None
    lv = torch.empty_like(lin_vel)
    av = torch.empty_like(ang_vel)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lane_solve(
            ptr(c.point), ptr(c.normal), ptr(c.depth), ptr(c.mask), ptr(c.vel_b),
            ptr(tables.slot_i), ptr(tables.slot_f), ptr(tables.seg_off), ptr(tables.b_off),
            ptr(group), ptr(g_com), ptr(g_inv_mass), ptr(g_inv_inertia), ptr(lin_vel),
            ptr(ang_vel), ptr(lv), ptr(av), ptr(scratch), ptr(clocks),
            B, P, K, tables.KS, tables.lpt, tables.NBE, int(iters), tables.route,
            float(dt), float(relaxation), float(slop), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError("lane solver launch failed: " + lib.lane_error_string(err).decode())
    if not defines:
        launches += 1
    return lv, av, clocks


def phase_clocks(tables: LaneTables, *args):
    """Clock cycles per phase of a launch on ``solve_contacts_lane``'s
    arguments ``args``, ``[B, phases + 1]`` int64 (loads, preparation and
    counts, lane half and group half of the sweeps; the last column: block
    barriers passed): one launch of the phase-clock build (the same source
    with ``-DFT_PHASE_CLOCKS``). A measuring aid, not counted in
    ``launches``."""
    return launch(tables, *args, defines=_cuda.PHASE_CLOCKS)[2]


def solve_contacts_lane(
    contacts: Contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
    dt: float, iters: int, relaxation: float, slop: float, tables: LaneTables | None = None,
):
    """``iters`` cold-started Jacobi sweeps for a batch: the kernel for CUDA
    tensors (one launch with the model's ``tables``, which it needs), the
    plain version for CPU tensors (``tables`` unused). Returns ``(lin_vel,
    ang_vel)`` [B,P,3]."""
    args = (contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
            dt, iters, relaxation, slop)
    kind = lin_vel.device.type
    if kind == "cuda":
        if tables is None:
            raise ValueError("the lane kernel needs the model's LaneTables "
                             "(LanePhysics.lane_tables, or LaneTables.of at set-up)")
        return launch(tables, *args)[:2]
    if kind == "cpu":
        return plain_solve_contacts_lane(*args)
    raise RuntimeError(f"no lane solver for device {lin_vel.device}")


# -- work model (for the roofline bound) ---------------------------------------

CROSS = 9                     # 6 multiplies, 3 subtracts
DOT = 5
# counted from csrc/lane_solver.cu (each float add, multiply, min/max,
# negation, compare, divide and square root counts one)
# prep_lane, a lane with a contact: r_a (3); |n_z| test (2); n x ref,
# its norm (+eps, sqrt) and 3 divides, t2; per direction r_a x d, the
# quadratic form (21), the mass sum, the floor and the reciprocal; the bias
PREP_LANE = 3 + 2 + CROSS + (DOT + 2) + 3 + CROSS + 3 * (CROSS + 21 + 1 + 2) + 6
# ... its b side: r_b (3), the b mass (1), per direction r_b x d and its form (+1)
PREP_LANE_B = 3 + 1 + 3 * (CROSS + 21 + 1)
PREP_VEL_B = 3 * DOT + 1 + 2  # vel_b's projections into the offsets
SCALE_LANE = 5                # floor at 1, divide, 3 multiplies (the max is of integers)
# sweep_lane: v_a (cross, 3 adds); t2; 3 projections with offset, times
# inv_w, from lambda (8 each); clamp, cone limit, tangent clamps (7); 3
# increments; impulse (15) and its negation (3); r_a x imp; 6 sums
SWEEP_LANE = (CROSS + 3) + CROSS + 3 * (DOT + 3) + 7 + 3 + 15 + 3 + CROSS + 6
# ... its b side: v_b (cross, 3 adds, 3 subtracts), r_b x -imp, its 6 sums
SWEEP_LANE_B = (CROSS + 6) + CROSS + 6
SWEEP_PART = 6 + 18           # a member's velocities: lin += s * m^-1, ang += I^-1 tau


def fp32_ops_per_env(K: int, K_b: int, P: int, iters: int, active: int | None = None,
                     active_b: int | None = None, vel_b: bool = False) -> int:
    """FP32 operations of the fused function for one env, counted from
    ``csrc/lane_solver.cu``: the contact test of every lane, the preparation
    and lane scale of every lane with a contact, and per sweep the update
    of each such lane, the b side of those with a part on side b and every
    part's velocity update (the counts are integer). ``active`` and
    ``active_b`` are this input's lanes with a contact (with a side b);
    they default to all ``K`` (``K_b``)."""
    a = K if active is None else active
    ab = K_b if active_b is None else active_b
    prep = K + a * (PREP_LANE + SCALE_LANE + (PREP_VEL_B if vel_b else 0)) + ab * PREP_LANE_B
    return int(prep + iters * (a * SWEEP_LANE + ab * SWEEP_LANE_B + P * SWEEP_PART))


def bytes_per_env(K: int, P: int, masked: int | None = None, active: int | None = None,
                  vel_b: bool = False) -> int:
    """Bytes one env's solve needs to read and write, counted as the
    operations are: the mask of every lane, the depth of each of the
    ``masked`` lanes whose mask is set, the point and normal (and ``vel_b``)
    of each of the ``active`` lanes with a contact; the group label, COM,
    inverse mass, inverse inertia and both velocities of every part in, both
    velocities out. ``masked`` and ``active`` default to all ``K``. The
    static tables, shared by all envs, are :meth:`LaneTables.table_bytes`."""
    m = K if masked is None else masked
    a = K if active is None else active
    return K + 4 * m + a * (24 + (12 if vel_b else 0)) + P * (4 + 12 + 4 + 36 + 12 + 12) + P * 24
