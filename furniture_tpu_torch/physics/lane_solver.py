"""The lane contact solver: the Jacobi contact solve alone, as one kernel.

The port's counterpart of ``furniture_tpu.physics.pallas_solver``
(``solve_contacts_pallas`` and its Pallas ``_kernel``), selected with
``SimConfig(use_pallas="lane")``. One launch of ``csrc/lane_solver.cu`` runs
``iters`` cold-started Jacobi sweeps over all contact lanes of every env of a
batch, one thread block per env (see the note at the top of the ``.cu``
file).

* :func:`solve_contacts_lane` launches the kernel for CUDA tensors and runs
  :func:`plain_solve_contacts_lane` for CPU tensors. There is no fallback:
  any other device, or a kernel that fails to build or launch, raises.
* :func:`plain_solve_contacts_lane` is the plain PyTorch version of the
  kernel's arithmetic: ``lambda`` starts at zero and the part velocities
  are updated incrementally, sweep by sweep, by the masked increment
  ``(lambda_new - lambda) * fmask``. ``engine._solve_contacts``, the
  warm-started solver of the other two kernels, recomputes the velocities
  from all of ``lambda`` each sweep instead; cold-started, the two agree to
  summation order.
* ``launches`` counts kernel launches, and nothing else.

The per-lane preparation (lever arms, tangent basis, effective masses, bias,
lane scale) is ``engine.lane_prep``, plain PyTorch shared with
``engine._solve_contacts``; the kernel receives it packed field-major as
``[B,25,K]``. The JAX package's kernel unrolls at most 8 parts; this one
takes any number of parts below 32768 (group labels are packed in 16 bits).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _cuda
from .. import transforms as T
from .collide import Contacts
from .engine import LanePrep, lane_prep

SOURCE = Path(__file__).resolve().parent / "csrc" / "lane_solver.cu"
THREADS = 256
# dynamic shared memory a block may opt into on Hopper (227 KB)
MAX_SMEM = 232448
LANE_FIELDS = 25   # csrc/lane_solver.cu NLF
MAX_PARTS = 32767

# kernel launches made by solve_contacts_lane since import (or since a
# caller last set it to 0)
launches = 0

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _cuda.load(SOURCE)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lane_solve.argtypes = [vp] * 11 + [i] * 6 + [vp]
        lib.lane_solve.restype = i
        lib.lane_error_string.argtypes = [i]
        lib.lane_error_string.restype = ctypes.c_char_p
        for fn in ("lane_fields", "lane_work_floats", "lane_part_floats"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


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


def pack_lanes(prep: LanePrep, c: Contacts) -> torch.Tensor:
    """The kernel's lane input [B,25,K], field-major: normal, tangent 1,
    tangent 2, r_a, r_b, inv_w (3 each), bias, friction, lane scale, mask,
    vel_b (3)."""
    B, K = prep.fmask.shape
    t = lambda x: x.transpose(1, 2)                                 # [B,K,3] -> [B,3,K]
    vel_b = c.vel_b if c.vel_b is not None else torch.zeros_like(prep.r_a)
    return torch.cat(
        [
            t(prep.dirs.reshape(B, K, 9)), t(prep.r_a), t(prep.r_b), t(prep.inv_w),
            prep.bias[:, None], c.friction.expand(B, K)[:, None],
            prep.lane_scale[:, None], prep.fmask[:, None], t(vel_b),
        ],
        dim=1,
    ).contiguous()


def work_buffer(P: int, K: int):
    """(shared bytes per block, lane work buffer in shared memory?)."""
    lib = library()
    part_bytes = 4 * (lib.lane_part_floats() * P + P)
    work_bytes = 4 * lib.lane_work_floats() * K
    in_smem = part_bytes + work_bytes <= MAX_SMEM
    return part_bytes + (work_bytes if in_smem else 0), in_smem


def launch_packed(lanes, part_a, part_b, group, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
                  iters: int):
    """One launch of the CUDA kernel on packed lanes (:func:`pack_lanes`)
    and int32 part indices [K]; raises on anything it cannot take. This is
    the only place that launches the kernel and counts it."""
    global launches
    B, P = group.shape
    K = lanes.shape[-1]
    dev = lin_vel.device
    if P > MAX_PARTS:
        raise ValueError(f"the lane solver takes at most {MAX_PARTS} parts, got {P}")
    want = {
        "lanes": (lanes, (B, LANE_FIELDS, K), torch.float32),
        "part_a": (part_a, (K,), torch.int32),
        "part_b": (part_b, (K,), torch.int32),
        "group": (group, (B, P), torch.int32),
        "g_inv_mass": (g_inv_mass, (B, P), torch.float32),
        "g_inv_inertia": (g_inv_inertia, (B, P, 3, 3), torch.float32),
        "lin_vel": (lin_vel, (B, P, 3), torch.float32),
        "ang_vel": (ang_vel, (B, P, 3), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = library()
    if lib.lane_fields() != LANE_FIELDS:
        raise RuntimeError("lane_solver.cu lane layout changed")
    smem, in_smem = work_buffer(P, K)
    scratch = None if in_smem else torch.empty(
        (B, lib.lane_work_floats() * K), dtype=torch.float32, device=dev
    )
    lv = torch.empty_like(lin_vel)
    av = torch.empty_like(ang_vel)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lane_solve(
            ptr(lanes), ptr(part_a), ptr(part_b), ptr(group), ptr(lin_vel), ptr(ang_vel),
            ptr(g_inv_mass), ptr(g_inv_inertia), ptr(lv), ptr(av), ptr(scratch),
            B, P, K, int(iters), THREADS, smem, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError("lane solver launch failed: " + lib.lane_error_string(err).decode())
    launches += 1
    return lv, av


def kernel_inputs(contacts: Contacts, group, g_com, g_inv_mass, g_inv_inertia, dt: float,
                  relaxation: float, slop: float):
    """What the wrapper hands the kernel besides the part tensors: the
    packed lanes [B,25,K] and the int32 part indices of both sides."""
    prep = lane_prep(contacts, group, g_com, g_inv_mass, g_inv_inertia, dt, relaxation, slop)
    return (
        pack_lanes(prep, contacts),
        contacts.part_a.to(torch.int32).contiguous(),
        contacts.part_b.to(torch.int32).contiguous(),
    )


def kernel_solve_contacts_lane(
    contacts: Contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
    dt: float, iters: int, relaxation: float, slop: float,
):
    """The kernel path: per-lane preparation in PyTorch, then one launch."""
    lanes, part_a, part_b = kernel_inputs(
        contacts, group, g_com, g_inv_mass, g_inv_inertia, dt, relaxation, slop
    )
    return launch_packed(
        lanes, part_a, part_b, group, g_inv_mass, g_inv_inertia, lin_vel, ang_vel, iters
    )


def solve_contacts_lane(
    contacts: Contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
    dt: float, iters: int, relaxation: float, slop: float,
):
    """``iters`` cold-started Jacobi sweeps for a batch: the kernel for CUDA
    tensors, the plain version for CPU tensors. Returns ``(lin_vel,
    ang_vel)`` [B,P,3]."""
    args = (contacts, group, g_com, g_inv_mass, g_inv_inertia, lin_vel, ang_vel,
            dt, iters, relaxation, slop)
    kind = lin_vel.device.type
    if kind == "cuda":
        return kernel_solve_contacts_lane(*args)
    if kind == "cpu":
        return plain_solve_contacts_lane(*args)
    raise RuntimeError(f"no lane solver for device {lin_vel.device}")


# -- work model (for the roofline bound) ---------------------------------------

CROSS = 9                     # 6 multiplies, 3 subtracts
# phase A of one lane, counted from csrc/lane_solver.cu lane_sweep: v_a
# (cross, 3 adds); v_rel (3); 3 projections (5 each); bias (1); 3 lambda
# steps (3 each); normal clamp, cone limit, 2 tangent clamps (2 each); 3
# masked increments (2 each); impulse (3 x 5); two torques and a negation
SWEEP_LANE = (CROSS + 3) + 3 + 15 + 1 + 9 + 6 + 6 + 15 + 2 * CROSS + 3
SWEEP_LANE_B = CROSS + 6      # v_b of a lane with a side b
SWEEP_ENTRY = 9               # phase B, one (lane side, member part): 3 fma + 3 adds
SWEEP_PART = 6 * 5 + 3 + 15 + 6   # warp sums; dlin; I^-1 tau; two velocity updates


def fp32_ops_per_env(K: int, K_b: int, P: int, iters: int, entries: float | None = None) -> float:
    """FP32 operations one env's block performs in a launch, counted from
    ``csrc/lane_solver.cu`` (each add, multiply, min/max and negation counts
    one; index arithmetic and comparisons of integers do not). ``K_b`` lanes
    have a side b. ``entries`` is the number of (lane side, part of that
    side's group) pairs phase B adds up, which depends on the groups: K +
    K_b when every part is its own group (the default)."""
    if entries is None:
        entries = K + K_b
    per_sweep = K * SWEEP_LANE + K_b * SWEEP_LANE_B + entries * SWEEP_ENTRY + P * SWEEP_PART
    return iters * per_sweep


def bytes_per_env(K: int, P: int) -> int:
    """Bytes the kernel reads and writes per env: the packed lanes, the
    group labels, velocities, inverse masses and inertias in, the velocities
    out (the two [K] part-index tables are shared by all envs)."""
    return 4 * (LANE_FIELDS * K + P * (1 + 3 + 3 + 1 + 9) + P * 6)
