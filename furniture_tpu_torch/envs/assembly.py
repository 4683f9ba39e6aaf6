"""Shared assembly machinery: alignment predicate, connect state machine,
weld bookkeeping, rigid-group moves.

The port's counterpart of ``furniture_tpu.envs.assembly``. Every method
works on a batch of envs: state fields lead with the env dimension B, and a
per-env index (a part or a connector site) is a ``[B]`` tensor read by plain
indexing. Where the JAX package branches per env with ``lax.cond`` (a select
under vmap), this module computes both sides and selects with
:func:`tree_where`.

The state is any NamedTuple carrying the assembly fields::

    parts: PartState            free furniture parts [B,P,...]
    group: [B,P] int32          rigid-group label (union-find flattened)
    conn_connected: [B,C] bool  connector site already used
    weld_active: [B,W] bool     weld equality rows activated
    num_connected: [B] int32
    subtask: [B,2] int32        next weld's part pair (-1,-1 when done)
    connect_step: [B] int32     consecutive aligned connect-steps counter
    connected_body1: [B] int32  part idx for the post-settle pose snap-back
    connected_body1_pos: [B,3]
    connected_body1_quat: [B,4]

The envs' connect attempt goes through :meth:`AssemblyOps.attempt` and the
cursor's post-connect snap-back move through :meth:`AssemblyOps.snap_move`.
For CUDA tensors each is one launch of ``physics/csrc/assembly.cu`` (see the
note at the top of the ``.cu`` file), with no host synchronisation; for CPU
tensors each runs its plain version (:meth:`AssemblyOps.plain_attempt`,
:meth:`AssemblyOps.plain_snap_move`, around :meth:`AssemblyOps.try_connect`),
which the kernel is held against; another device raises. The kernel takes
every furniture model, within ``MAX_P`` parts, ``MAX_C`` connector sites,
``MAX_W`` weld rows and ``MAX_A`` table angles a site, which an
``AssemblyOps`` on the card holds its model to. ``AssemblyOps.launches``
counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from .. import transforms as T
from ..physics.state import PartState, zero_vel
from ..utils.init_pool import stack_pool

SOURCE = Path(__file__).resolve().parent.parent / "physics" / "csrc" / "assembly.cu"

# the .cu file's limits (checked when the library loads)
MAX_P, MAX_C, MAX_W, MAX_A = 32, 64, 64, 8
ATTEMPT, SNAP_MOVE = 0, 1

# the kernel's argument block (``Args`` in the .cu file), field by field
_STATE = ("pos", "quat", "lin_vel", "ang_vel", "group", "conn_connected", "weld_active",
          "num_connected", "subtask", "connect_step", "body1", "body1_pos", "body1_quat")
_TABLES = ("conn_pos", "conn_part", "compl_", "cos_a", "sin_a", "angle_mask", "has_angles",
           "site_pos", "site_part", "weld_part1", "weld_part2", "weld_lookup")
_INTS = ("B", "P", "C", "W", "A", "S", "connect_stride", "touch_sb", "touch_sa", "arms",
         "n_try", "n_interp", "snap_back")
_FLOATS = ("pos_dist", "half_pos_dist", "rot_up", "rot_fwd", "project_dist")


class _Args(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_void_p) for n in _STATE]
        + [(n, ctypes.c_void_p) for n in ("connect", "held", "touch_l", "touch_r")]
        + [(n + "_out", ctypes.c_void_p) for n in _STATE]
        + [("held_out", ctypes.c_void_p)]
        + [(n, ctypes.c_void_p) for n in _TABLES]
        + [(n, ctypes.c_int) for n in _INTS]
        + [(n, ctypes.c_float) for n in _FLOATS]
    )


_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _cuda.load(SOURCE)
        i = ctypes.c_int
        lib.connect_step.argtypes = [i, ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.connect_step.restype = i
        lib.connect_error_string.argtypes = [i]
        lib.connect_error_string.restype = ctypes.c_char_p
        names = ("max_p", "max_c", "max_w", "max_a", "args_bytes")
        for n in names:
            getattr(lib, f"connect_{n}").argtypes = []
            getattr(lib, f"connect_{n}").restype = i
        layout = tuple(getattr(lib, f"connect_{n}")() for n in names)
        if layout != (MAX_P, MAX_C, MAX_W, MAX_A, ctypes.sizeof(_Args)):
            raise RuntimeError(f"assembly.cu limits or argument block changed: {layout}")
        lib.connect_smem_bytes.argtypes = [i, i, i]
        lib.connect_smem_bytes.restype = i
        _lib = lib
    return _lib


def check_limits(model) -> None:
    """Raises where ``model`` is beyond the connect kernel's limits."""
    P, C, W = model.n_parts, model.n_conn, model.n_welds
    A = np.asarray(model.conn_angles).shape[-1]
    if P > MAX_P or C > MAX_C or W > MAX_W or A > MAX_A:
        raise ValueError(
            f"the model has {P} parts, {C} connector sites, {W} weld rows and {A} table angles a "
            f"site: the connect kernel takes at most MAX_P = {MAX_P}, MAX_C = {MAX_C}, MAX_W = "
            f"{MAX_W} and MAX_A = {MAX_A}"
        )


def tree_where(mask, new, old):
    """Per-env select over (nested) NamedTuples of batch-leading tensors."""
    if isinstance(new, tuple):
        return type(new)(*(tree_where(mask, a, b) for a, b in zip(new, old)))
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


def rows(arr, idx):
    """``arr[b, idx[b]]`` for every env b."""
    return arr[torch.arange(arr.shape[0], device=arr.device), idx.long()]


class AssemblyOps:
    """Batched assembly helpers closed over one compiled model."""

    def __init__(self, model, config, device):
        self.model = model
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_limits(model)
            if self.device.index is None:
                # tensors report a concrete index; compare against the same
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.launches = 0
        self._P = model.n_parts
        self._C = model.n_conn
        self._W = model.n_welds
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        m = model
        self.conn_pos = f32(m.conn_pos)
        self.conn_part = i64(m.conn_part)
        self.site_pos = f32(m.site_pos)
        self.site_part = i64(m.site_part)
        pa = np.asarray(m.conn_pair_a)
        pb = np.asarray(m.conn_pair_b)
        self.compl = torch.as_tensor(
            (pa[:, None] == pb[None, :]) & (pb[:, None] == pa[None, :]), device=dev
        )
        self.conn_angles = f32(m.conn_angles)
        self.conn_angle_mask = torch.as_tensor(np.asarray(m.conn_angle_mask), device=dev)
        self.conn_has_angles = torch.as_tensor(np.asarray(m.conn_has_angles), device=dev)
        # [P,C]: connector c sits on part p
        self.conn_of_part = torch.as_tensor(
            np.asarray(m.conn_part)[None, :] == np.arange(self._P)[:, None], device=dev
        )
        self.weld_part1 = i64(m.weld_part1)
        self.weld_part2 = i64(m.weld_part2)
        self.weld_lookup = i64(m.weld_lookup)
        self.part_labels = torch.arange(self._P, device=dev)
        self._args = self._kernel_args() if dev.type == "cuda" else None

    def _kernel_args(self) -> _Args:
        """The kernel's argument block with the model's tables and the
        alignment thresholds filled in; the tables, kept on the device, are
        those of the plain version (the table angles' cosines and sines as
        ``T.rotate_vector`` computes them)."""
        i32 = lambda t: t.to(torch.int32).contiguous()
        rad = torch.deg2rad(self.conn_angles)
        self._tables = {
            "conn_pos": self.conn_pos, "conn_part": i32(self.conn_part),
            "compl_": self.compl.contiguous(), "cos_a": torch.cos(rad), "sin_a": torch.sin(rad),
            "angle_mask": self.conn_angle_mask.contiguous(), "has_angles": self.conn_has_angles,
            "site_pos": self.site_pos, "site_part": i32(self.site_part),
            "weld_part1": i32(self.weld_part1), "weld_part2": i32(self.weld_part2),
            "weld_lookup": i32(self.weld_lookup),
        }
        a = _Args()
        for n, t in self._tables.items():
            setattr(a, n, t.data_ptr())
        a.P, a.C, a.W, a.S = self._P, self._C, self._W, len(self.site_pos)
        a.A = self.conn_angles.shape[1]
        a.n_interp = self.config.num_connect_steps
        cfg = self.config.align
        a.pos_dist, a.half_pos_dist = cfg.pos_dist, cfg.pos_dist / 2
        a.rot_up, a.rot_fwd, a.project_dist = cfg.rot_dist_up, cfg.rot_dist_forward, cfg.project_dist
        return a

    # -- geometry helpers ----------------------------------------------------

    def conn_world(self, parts: PartState):
        """World pose of every connector site ([B,C,3], [B,C,4])."""
        part = self.conn_part
        pos = parts.pos[:, part] + T.quat_rotate(parts.quat[:, part], self.conn_pos)
        quat = parts.quat[:, part]  # conn sites carry identity site quat
        return pos, quat

    def site_world(self, parts: PartState):
        part = self.site_part
        return parts.pos[:, part] + T.quat_rotate(parts.quat[:, part], self.site_pos)

    def group_bbox(self, parts: PartState, group, ref_part):
        """Bounding box over all sites of ``ref_part``'s group, including the
        origin (the reference's min/max zero-init)."""
        site_w = self.site_world(parts)                          # [B,S,3]
        ref_g = rows(group, ref_part)
        in_group = (group[:, self.site_part] == ref_g[:, None])[..., None]
        big = torch.full_like(site_w, 1e9)
        lo = torch.amin(torch.where(in_group, site_w, big), dim=1)
        hi = torch.amax(torch.where(in_group, site_w, -big), dim=1)
        return torch.clamp(lo, max=0.0), torch.clamp(hi, min=0.0)

    def move_group(self, parts: PartState, group, base_part, move_offset, target_quat):
        """Rigidly rotate ``base_part``'s group about the base part's origin to
        ``target_quat`` and translate by ``move_offset``."""
        in_group = (group == rows(group, base_part)[:, None])[..., None]
        base_pose = torch.cat([rows(parts.pos, base_part), rows(parts.quat, base_part)], -1)
        qpos = torch.cat([parts.pos, parts.quat], dim=-1)         # [B,P,7]
        new_pos, new_quat = T.transform_to_target_quat(
            base_pose[:, None], qpos, target_quat[:, None]
        )
        new_pos = new_pos + move_offset[:, None]
        return parts._replace(
            pos=torch.where(in_group, new_pos, parts.pos),
            quat=torch.where(in_group, new_quat, parts.quat),
        )

    # -- alignment predicate ---------------------------------------------------

    def alignment(self, parts: PartState):
        """All C×C conn-site pairs: (aligned [B,C,C] bool, target_quat
        [B,C,C,4]), the world quat the first site's frame should take."""
        cfg = self.config.align
        pos, quat = self.conn_world(parts)                       # [B,C,3],[B,C,4]
        up = T.up_vector_from_quat(quat)
        fwd = T.forward_vector_from_quat(quat)
        B, C = pos.shape[:2]

        d12 = pos[:, None, :, :] - pos[:, :, None, :]            # pos_j - pos_i
        pos_dist = torch.linalg.norm(d12, dim=-1)                # [B,C,C]
        u12 = d12 / torch.clamp(pos_dist[..., None], min=1e-12)
        nup = torch.linalg.norm(up, dim=-1)
        rot_dist_up = torch.einsum("bid,bjd->bij", up, up) / (
            nup[:, :, None] * nup[:, None, :]
        )
        project1_2 = torch.sum(up[:, :, None, :] * u12, -1)
        project2_1 = torch.sum(up[:, None, :, :] * -u12, -1)

        # allowed-angle case: rotate fwd_i about up_i by each table angle
        f_rot = T.rotate_vector(
            fwd[:, :, None, :], up[:, :, None, :], self.conn_angles
        )                                                        # [B,C,A,3]
        cos_fa = torch.einsum("biad,bjd->bija", f_rot, fwd)      # [B,C,C,A]
        ok_a = (cos_fa > cfg.rot_dist_forward) & self.conn_angle_mask[None, :, None, :]
        any_ok = torch.any(ok_a, dim=-1)
        first_a = torch.argmax(ok_a.to(torch.uint8), dim=-1)      # first True, else 0
        A = f_rot.shape[2]
        f_rot_ij = f_rot[:, :, None].expand(B, C, C, A, 3)
        f_ang = torch.gather(
            f_rot_ij, 3, first_a[..., None, None].expand(B, C, C, 1, 3)
        )[:, :, :, 0]                                            # [B,C,C,3]

        # free-angle case
        cos_ff = torch.einsum("bid,bjd->bij", fwd, fwd)
        f_pos = T.rotate_vector_cos_siml(fwd[:, :, None], up[:, :, None], cos_ff, 1.0)
        f_neg = T.rotate_vector_cos_siml(fwd[:, :, None], up[:, :, None], cos_ff, -1.0)
        cp = torch.sum(f_pos * fwd[:, None, :, :], -1)
        cn = torch.sum(f_neg * fwd[:, None, :, :], -1)
        f_free = torch.where((cp > cn)[..., None], f_pos, f_neg)

        has_ang = self.conn_has_angles[None, :, None]            # [1,C,1]
        fwd_aligned = torch.where(has_ang, any_ok, torch.ones_like(any_ok))
        f_chosen = torch.where(has_ang[..., None], f_ang, f_free)
        target_quat = T.lookat_to_quat(up[:, :, None].expand_as(f_chosen), f_chosen)

        up_ok = rot_dist_up > cfg.rot_dist_up
        proj_ok = (torch.abs(project1_2) > cfg.project_dist) & (
            torch.abs(project2_1) > cfg.project_dist
        )
        aligned = (
            (pos_dist < cfg.pos_dist) & up_ok & fwd_aligned & proj_ok
        ) | ((pos_dist < cfg.pos_dist / 2) & up_ok & fwd_aligned)
        return aligned, target_quat

    # -- connect machinery ------------------------------------------------------

    def find_connectable(self, state, in1, in2):
        """First eligible aligned conn-site pair with site1 ∈ ``in1`` and
        site2 ∈ ``in2`` ([B,C] bool masks), in site iteration order.
        Returns (found [B], s1 [B], s2 [B], target_quat [B,4])."""
        C, P = self._C, self._P
        B = state.group.shape[0]
        free = ~state.conn_connected
        conn_group = state.group[:, self.conn_part]               # [B,C]
        diff_group = conn_group[:, :, None] != conn_group[:, None, :]
        elig = (
            in1[:, :, None]
            & in2[:, None, :]
            & self.compl[None]
            & free[:, :, None]
            & free[:, None, :]
            & diff_group
        )
        # weld-row existence gate: a weld row must exist whose two parts
        # both lie in the candidate body sets
        if self._W:
            cop = self.conn_of_part[None]                         # [1,P,C]
            part_in1 = torch.any(cop & in1[:, None, :], -1)        # [B,P]
            part_in2 = torch.any(cop & in2[:, None, :], -1)
            g = state.group.long()
            label = g[:, :, None] == self.part_labels[None, None, :]  # [B,P,labels]
            gset1 = torch.any(label & part_in1[:, :, None], 1)
            gset2 = torch.any(label & part_in2[:, :, None], 1)
            either = gset1 | gset2
            e1 = torch.gather(either, 1, g[:, self.weld_part1])
            e2 = torch.gather(either, 1, g[:, self.weld_part2])
            gate = torch.any(e1 & e2, -1)
        else:
            gate = torch.zeros(B, dtype=torch.bool, device=state.group.device)

        aligned, target_quat = self.alignment(state.parts)
        ok = elig & aligned & gate[:, None, None]
        flat = ok.reshape(B, C * C)
        found = torch.any(flat, -1)
        idx = torch.argmax(flat.to(torch.uint8), -1)              # first True, else 0
        s1 = torch.div(idx, C, rounding_mode="floor")
        s2 = idx % C
        tq = rows(target_quat.reshape(B, C * C, 4), idx)
        return found, s1, s2, tq

    def snap_connect(self, state, s1, s2, target_quat):
        """Final connect: snap site2's group onto site1, weld, merge groups."""
        p1 = self.conn_part[s1]
        p2 = self.conn_part[s2]
        cpos, _ = self.conn_world(state.parts)
        site1_pos = rows(cpos, s1)
        site2_pos = rows(cpos, s2)

        # rigid map x -> A(x - site2) + site1 with A = target ∘ q(part2)^-1
        q_p2 = rows(state.parts.quat, p2)
        g_p2 = rows(state.group, p2)
        A = T.quat_mul(target_quat, T.quat_inv(q_p2))
        in2 = state.group == g_p2[:, None]
        new_pos = T.quat_rotate(
            A[:, None], state.parts.pos - site2_pos[:, None]
        ) + site1_pos[:, None]
        new_quat = T.quat_mul(A[:, None], state.parts.quat)
        parts = zero_vel(state.parts._replace(
            pos=torch.where(in2[..., None], new_pos, state.parts.pos),
            quat=torch.where(in2[..., None], new_quat, state.parts.quat),
        ))

        # floor lift: union bbox of both groups must have min z >= 0
        lo1, _ = self.group_bbox(parts, state.group, p1)
        lo2, _ = self.group_bbox(parts, state.group, p2)
        min_z = torch.minimum(lo1[:, 2], lo2[:, 2])
        lift = torch.where(min_z < 0, -min_z, torch.zeros_like(min_z))
        g_p1 = rows(state.group, p1)
        in_either = (state.group == g_p1[:, None]) | in2
        pos = parts.pos.clone()
        pos[..., 2] = pos[..., 2] + torch.where(
            in_either, lift[:, None], torch.zeros_like(pos[..., 2])
        )
        parts = parts._replace(pos=pos)

        # weld bookkeeping + group merge (g(p1) label <- g(p2))
        weld_idx = self.weld_lookup[p1, p2]                      # [B]
        W = state.weld_active.shape[1]
        hit = (torch.arange(W, device=pos.device)[None] == weld_idx[:, None]) & (
            weld_idx >= 0
        )[:, None]
        weld_active = state.weld_active | hit
        group = torch.where(state.group == g_p1[:, None], g_p2[:, None], state.group)
        cidx = torch.arange(self._C, device=pos.device)[None]
        conn_connected = (
            state.conn_connected | (cidx == s1[:, None]) | (cidx == s2[:, None])
        )
        return state._replace(
            parts=parts,
            group=group,
            weld_active=weld_active,
            conn_connected=conn_connected,
            num_connected=state.num_connected + 1,
            connect_step=torch.zeros_like(state.connect_step),
            connected_body1=p1.to(torch.int32),
            connected_body1_pos=rows(parts.pos, p1),
            connected_body1_quat=rows(parts.quat, p1),
            subtask=self.next_subtask(group),
        )

    def next_subtask(self, group):
        """First weld whose parts are in different groups ([B,2] int32)."""
        B = group.shape[0]
        if not self._W:
            return torch.full((B, 2), -1, dtype=torch.int32, device=group.device)
        open_w = group[:, self.weld_part1] != group[:, self.weld_part2]  # [B,W]
        any_open = torch.any(open_w, -1)
        w = torch.argmax(open_w.to(torch.uint8), -1)
        pair = torch.stack([self.weld_part1[w], self.weld_part2[w]], -1)
        return torch.where(any_open[:, None], pair, torch.full_like(pair, -1)).to(torch.int32)

    def interp_connect(self, state, s1, s2, target_quat):
        """Intermediate connect step: ease site2's group toward the snap
        target (per-step recomputation; the terminal snap is identical)."""
        p2 = self.conn_part[s2]
        cpos, _ = self.conn_world(state.parts)
        site1_pos = rows(cpos, s1)
        site2_pos = rows(cpos, s2)
        cur_pos = rows(state.parts.pos, p2)
        cur_quat = rows(state.parts.quat, p2)
        A = T.quat_mul(target_quat, T.quat_inv(cur_quat))
        body_target_pos = T.quat_rotate(A, cur_pos - site2_pos) + site1_pos
        body_target_quat = T.quat_mul(A, cur_quat)

        N = self.config.num_connect_steps
        k = state.connect_step
        den = torch.clamp(N - k, min=1).to(torch.float32)
        frac = torch.full_like(den, 0.9) / den
        step_pos = cur_pos + frac[:, None] * (body_target_pos - cur_pos)
        step_quat = T.quat_slerp(cur_quat, body_target_quat, frac)
        parts = zero_vel(self.move_group(
            state.parts, state.group, p2, step_pos - cur_pos, step_quat
        ))
        return state._replace(parts=parts, connect_step=state.connect_step + 1)

    def try_connect(self, state, in1, in2, num_connect_steps=None):
        """One connect attempt for every env: where an aligned eligible pair
        exists, interpolate toward it or (after ``num_connect_steps``
        consecutive attempts) snap + weld; elsewhere reset the counter."""
        N = self.config.num_connect_steps if num_connect_steps is None else num_connect_steps
        found, s1, s2, tq = self.find_connectable(state, in1, in2)
        interp = self.interp_connect(state, s1, s2, tq)
        snap = self.snap_connect(state, s1, s2, tq)
        on_found = tree_where(state.connect_step < N, interp, snap)
        on_missing = state._replace(connect_step=torch.zeros_like(state.connect_step))
        return tree_where(found, on_found, on_missing)

    # -- the envs' connect attempt: the kernel on the card, plain on the CPU ----

    def attempt(self, state, connect, held=None, touch=None, num_connect_steps=None,
                snap_back=False):
        """One connect attempt of an env step, where the press ``connect``
        [B] is positive; returns ``(state, held)``.

        The candidate sites come from ``held`` [B,2] int32, the parts two
        cursors hold (site1 on cursor 0's group, site2 on cursor 1's; both
        must hold, and a snap lets go of cursor 1's part: the new ``held``),
        or from ``touch`` = (touch_l, touch_r) [B,arms,P] bool (site1 on the
        group of the first part both fingers of an arm touch, site2
        anywhere; ``held`` comes back None). With ``snap_back`` the
        post-connect snap-back move of ``connected_body1``'s group follows.
        The kernel for CUDA tensors, :meth:`plain_attempt` for CPU tensors."""
        if self._on_card(state.group):
            return self._launch_attempt(state, connect, held, touch, num_connect_steps, snap_back)
        return self.plain_attempt(state, connect, held, touch, num_connect_steps, snap_back)

    def snap_move(self, state) -> PartState:
        """The cursor's post-connect snap-back move of every env, velocities
        zeroed (the caller runs the one settle substep and keeps it where
        ``connected_body1 >= 0``): the kernel for CUDA tensors,
        :meth:`plain_snap_move` for CPU tensors."""
        if self._on_card(state.group):
            return self._launch_snap_move(state)
        return self.plain_snap_move(state)

    def plain_attempt(self, state, connect, held=None, touch=None, num_connect_steps=None,
                      snap_back=False):
        """:meth:`attempt` in plain PyTorch around :meth:`try_connect`."""
        conn_group = state.group[:, self.conn_part]                         # [B,C]
        if held is not None:
            g1 = rows(state.group, torch.clamp(held[:, 0], min=0))
            g2 = rows(state.group, torch.clamp(held[:, 1], min=0))
            in1, in2 = conn_group == g1[:, None], conn_group == g2[:, None]
            gate = (connect > 0) & (held[:, 0] >= 0) & (held[:, 1] >= 0)
        else:
            both = torch.any(touch[0] & touch[1], dim=1)                    # [B,P]
            target_part = torch.argmax(both.to(torch.uint8), -1)
            in1 = conn_group == rows(state.group, target_part)[:, None]
            in2 = torch.ones_like(in1)
            gate = (connect > 0) & torch.any(both, -1)
        prev = state.num_connected
        connected = self.try_connect(state, in1, in2, num_connect_steps)
        missed = state._replace(connect_step=torch.zeros_like(state.connect_step))
        state = tree_where(gate, connected, missed)
        if held is not None:
            held = held.clone()
            held[:, 1] = torch.where(
                state.num_connected > prev, torch.full_like(prev, -1), held[:, 1]
            )
        if snap_back:
            snap = state.connected_body1 >= 0
            state = state._replace(
                parts=tree_where(snap, self.plain_snap_move(state), state.parts),
                connected_body1=torch.where(
                    snap, torch.full_like(state.connected_body1, -1), state.connected_body1
                ),
            )
        return state, held

    def plain_snap_move(self, state) -> PartState:
        """:meth:`snap_move` in plain PyTorch."""
        p1 = torch.clamp(state.connected_body1, min=0)
        move = state.connected_body1_pos - rows(state.parts.pos, p1)
        return zero_vel(
            self.move_group(state.parts, state.group, p1, move, state.connected_body1_quat)
        )

    def _on_card(self, x) -> bool:
        kind = x.device.type
        if kind not in ("cuda", "cpu"):
            raise RuntimeError(f"no connect attempt for device {x.device}")
        return kind == "cuda"

    def _state_in(self, state) -> dict:
        """The kernel's state inputs, checked and contiguous (no copy where
        they already are)."""
        if self._args is None or state.group.device != self.device:
            raise ValueError(f"tables live on {self.device}, the state on {state.group.device}")
        B, P, C, W = state.group.shape[0], self._P, self._C, self._W
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        want = {
            "pos": (state.parts.pos, (B, P, 3), f32), "quat": (state.parts.quat, (B, P, 4), f32),
            "lin_vel": (state.parts.lin_vel, (B, P, 3), f32),
            "ang_vel": (state.parts.ang_vel, (B, P, 3), f32),
            "group": (state.group, (B, P), i32),
            "conn_connected": (state.conn_connected, (B, C), b8),
            "weld_active": (state.weld_active, (B, W), b8),
            "num_connected": (state.num_connected, (B,), i32),
            "subtask": (state.subtask, (B, 2), i32),
            "connect_step": (state.connect_step, (B,), i32),
            "body1": (state.connected_body1, (B,), i32),
            "body1_pos": (state.connected_body1_pos, (B, 3), f32),
            "body1_quat": (state.connected_body1_quat, (B, 4), f32),
        }
        out = {}
        for name, (x, shape, dtype) in want.items():
            if x.dtype != dtype or tuple(x.shape) != shape or x.device != self.device:
                raise ValueError(f"{name}: want {list(shape)} {dtype} on {self.device}, got "
                                 f"{tuple(x.shape)} {x.dtype} on {x.device}")
            out[name] = x.contiguous()
        return out

    def _run(self, mode: int, a: _Args, device) -> None:
        lib = library()
        with torch.cuda.device(device):
            err = lib.connect_step(mode, ctypes.byref(a), torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError("connect kernel launch failed: " + lib.connect_error_string(err).decode())
        self.launches += 1

    def _launch_attempt(self, state, connect, held, touch, num_connect_steps, snap_back):
        """One launch of the connect kernel; raises on anything it cannot take."""
        ins = self._state_in(state)
        B = state.group.shape[0]
        if (connect.dtype != torch.float32 or connect.dim() != 1 or connect.shape[0] != B
                or connect.device != self.device):
            raise ValueError(f"connect: want [{B}] float32 on {self.device}, got "
                             f"{tuple(connect.shape)} {connect.dtype} on {connect.device}")
        if (held is None) == (touch is None):
            raise ValueError("give the candidates by exactly one of held and touch")
        a = self._args
        for n, x in ins.items():
            setattr(a, n, x.data_ptr())
        outs = {n: torch.empty_like(x) for n, x in ins.items()}
        for n, x in outs.items():
            setattr(a, n + "_out", x.data_ptr())
        a.connect, a.connect_stride = connect.data_ptr(), connect.stride(0)
        held_out = None
        if held is not None:
            if held.dtype != torch.int32 or tuple(held.shape) != (B, 2) or held.device != self.device:
                raise ValueError(f"held: want [{B}, 2] int32 on {self.device}, got "
                                 f"{tuple(held.shape)} {held.dtype} on {held.device}")
            held = held.contiguous()
            held_out = torch.empty_like(held)
            a.held, a.held_out, a.touch_l, a.touch_r = held.data_ptr(), held_out.data_ptr(), None, None
            a.touch_sb = a.touch_sa = a.arms = 0
        else:
            tl, tr = touch
            for x in (tl, tr):
                if (x.dtype != torch.bool or x.dim() != 3 or x.shape[0] != B or x.shape[2] != self._P
                        or x.device != self.device):
                    raise ValueError(f"touch: want [{B}, arms, {self._P}] bool on {self.device}, "
                                     f"got {tuple(x.shape)} {x.dtype} on {x.device}")
            if tl.stride() != tr.stride() or tl.stride(2) != 1:
                tl, tr = tl.contiguous(), tr.contiguous()
            a.held = a.held_out = None
            a.touch_l, a.touch_r = tl.data_ptr(), tr.data_ptr()
            a.touch_sb, a.touch_sa, a.arms = tl.stride(0), tl.stride(1), tl.shape[1]
        a.B = B
        a.n_try = self.config.num_connect_steps if num_connect_steps is None else num_connect_steps
        a.snap_back = int(bool(snap_back))
        self._run(ATTEMPT, a, state.group.device)
        parts = PartState(outs["pos"], outs["quat"], outs["lin_vel"], outs["ang_vel"])
        state = state._replace(
            parts=parts, group=outs["group"], conn_connected=outs["conn_connected"],
            weld_active=outs["weld_active"], num_connected=outs["num_connected"],
            subtask=outs["subtask"], connect_step=outs["connect_step"],
            connected_body1=outs["body1"], connected_body1_pos=outs["body1_pos"],
            connected_body1_quat=outs["body1_quat"],
        )
        return state, held_out

    def _launch_snap_move(self, state) -> PartState:
        """One launch of the kernel's snap-back instance."""
        ins = self._state_in(state)
        a = self._args
        for n, x in ins.items():
            setattr(a, n, x.data_ptr())
        outs = {n: torch.empty_like(ins[n]) for n in ("pos", "quat", "lin_vel", "ang_vel")}
        for n in _STATE:
            setattr(a, n + "_out", outs[n].data_ptr() if n in outs else None)
        a.connect = a.held = a.held_out = a.touch_l = a.touch_r = None
        a.B = state.group.shape[0]
        self._run(SNAP_MOVE, a, state.group.device)
        return PartState(outs["pos"], outs["quat"], outs["lin_vel"], outs["ang_vel"])

    def initial_subtask(self, B: int):
        if self._W:
            pair = torch.stack([self.weld_part1[0], self.weld_part2[0]]).to(torch.int32)
            return pair[None].expand(B, 2).clone()
        return torch.full((B, 2), -1, dtype=torch.int32, device=self.device)

    def preassemble(self, state, subtasks):
        """Start with the given recipe subtasks already connected: each snap
        reuses :meth:`snap_connect` with the leg site moved onto the table
        site at the recipe angle."""
        m = self.model
        B = state.group.shape[0]
        dev = state.group.device
        for i in subtasks:
            s_leg = int(np.asarray(m.recipe_site1)[i])
            s_tab = int(np.asarray(m.recipe_site2)[i])
            ang = float(np.asarray(m.recipe_angle)[i])
            _, cquat = self.conn_world(state.parts)
            up1 = T.up_vector_from_quat(cquat[:, s_tab])
            fwd1 = T.forward_vector_from_quat(cquat[:, s_tab])
            if np.isnan(ang):
                # free-angle connector: nearest of the two in-plane
                # projections of the leg forward
                fwd2 = T.forward_vector_from_quat(cquat[:, s_leg])
                cos = T.cos_siml(fwd1, fwd2)
                fp = T.rotate_vector_cos_siml(fwd1, up1, cos, 1.0)
                fn = T.rotate_vector_cos_siml(fwd1, up1, cos, -1.0)
                fwd_r = torch.where(
                    (T.cos_siml(fp, fwd2) > T.cos_siml(fn, fwd2))[:, None], fp, fn
                )
            else:
                fwd_r = T.rotate_vector(fwd1, up1, ang)
            target = T.lookat_to_quat(up1, fwd_r)
            full = lambda v: torch.full((B,), v, dtype=torch.long, device=dev)
            state = self.snap_connect(state, full(s_tab), full(s_leg), target)
        # preassembly is not a live connect event: clear the snap-back
        # bookkeeping the env step reacts to
        return state._replace(
            connected_body1=torch.full_like(state.connected_body1, -1),
            connect_step=torch.zeros_like(state.connect_step),
        )


# dtypes of the pool's fields on the device (those of the state's fields)
_POOL_DTYPES = {
    "pos": torch.float32, "quat": torch.float32, "group": torch.int32,
    "weld_active": torch.bool, "conn_connected": torch.bool,
    "num_connected": torch.int32, "qpos": torch.float32, "qvel": torch.float32,
}


def pool_to_device(pool, device) -> dict:
    """An initial-state pool (a dict of stacked numpy arrays or a list of
    snapshots, see ``utils.init_pool``) as tensors on ``device``, built once
    so that a reset gathers from it without a host copy."""
    if isinstance(pool, list):
        pool = stack_pool(pool)
    return {
        k: torch.as_tensor(np.asarray(v), device=device).to(_POOL_DTYPES.get(k, torch.float32))
        for k, v in pool.items()
    }


def pool_draw(n: int, num_envs: int, generator: torch.Generator, device):
    """Per env, a pool index in [0, n) and whether the pool entry is used
    (a uniform draw above 0.2, the reference's probability of 0.8): two
    draws from ``generator``, the indices first."""
    idx = torch.randint(0, n, (num_envs,), generator=generator, device=device)
    use = torch.rand((num_envs,), generator=generator, device=device) > 0.2
    return idx, use


def apply_reset_variants(ops: AssemblyOps, config, pool, state, generator=None):
    """Recipe preassembly and initial-state-pool sampling for a freshly
    placed batch. ``pool`` is a dict of tensors on the state's device
    (:func:`pool_to_device`) or None. With a pool, each env takes the entry
    :func:`pool_draw` gives it where the draw says so and keeps the sampled
    placement elsewhere; velocities are zeroed and ``subtask`` is recomputed
    from the groups."""
    if config.preassembled:
        state = ops.preassemble(state, config.preassembled)
    if pool is not None:
        if generator is None:
            raise ValueError("a reset with an initial-state pool needs the generator")
        B = state.group.shape[0]
        idx, use = pool_draw(len(pool["pos"]), B, generator, state.group.device)

        def pick(name, cur):
            if name not in pool:
                return cur
            m = use.reshape((B,) + (1,) * (cur.dim() - 1))
            return torch.where(m, pool[name][idx], cur)

        state = state._replace(
            parts=zero_vel(state.parts._replace(
                pos=pick("pos", state.parts.pos), quat=pick("quat", state.parts.quat)
            )),
            group=pick("group", state.group),
            weld_active=pick("weld_active", state.weld_active),
            conn_connected=pick("conn_connected", state.conn_connected),
            num_connected=pick("num_connected", state.num_connected),
        )
        if hasattr(state, "qpos") and "qpos" in pool:
            state = state._replace(
                qpos=pick("qpos", state.qpos), qvel=pick("qvel", state.qvel)
            )
        state = state._replace(subtask=ops.next_subtask(state.group))
    return state


def sample_placement(model, cfg, num_envs: int, generator: torch.Generator, device):
    """Randomized initial part placement with overlap rejection for
    ``num_envs`` envs: XML-init-pose anchored xy noise, a constant rotation
    offset of ``furn_rot_rand`` degrees about x, and horizontal-radius
    circle rejection re-sampled in part order over 10 rounds. The first
    draw from ``generator`` is the initial xy noise [B,P,2]. Returns
    (pos [B,P,3], quat [B,P,4])."""
    P = model.n_parts
    B = num_envs
    dev = torch.device(device)
    base_pos = torch.as_tensor(np.asarray(model.part_init_pos, np.float32), device=dev)
    base_quat = torch.as_tensor(np.asarray(model.part_init_quat, np.float32), device=dev)
    r = cfg.furn_xyz_rand

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return -r + u * (2 * r)

    xy = uniform((B, P, 2))
    pos = base_pos + torch.cat([xy, torch.full((B, P, 1), 0.01, device=dev)], -1)
    rot = torch.zeros((B, P, 3), device=dev)
    rot[..., 0] = cfg.furn_rot_rand
    quat = T.euler_to_quat(rot, base_quat)

    radius = torch.as_tensor(np.asarray(model.part_horiz_radius, np.float32), device=dev)
    rr = radius[:, None] + radius[None, :]
    lower = torch.tril(torch.ones((P, P), dtype=torch.bool, device=dev), diagonal=-1)
    for _ in range(10):
        d = torch.linalg.norm(pos[:, :, None, :2] - pos[:, None, :, :2], dim=-1)
        bad = torch.any((d <= rr) & lower, dim=-1)                # part i overlaps earlier part
        new_xy = base_pos[:, :2] + uniform((B, P, 2))
        pos = torch.cat(
            [torch.where(bad[..., None], new_xy, pos[..., :2]), pos[..., 2:]], -1
        )
    return pos, quat


def settle_parts(physics, parts: PartState, group, cfg_sim) -> PartState:
    """Part stabilization at reset: 10 × (stop objects, 10 substeps
    with gravity compensation, clip velocities) through ``physics`` (the
    kernel's wrapper), then stop."""
    gscale = torch.zeros(group.shape, dtype=torch.float32, device=group.device)
    clip = cfg_sim.slow_clip
    for _ in range(10):
        parts = physics(zero_vel(parts), group, gscale, 10)
        parts = parts._replace(
            lin_vel=torch.clamp(parts.lin_vel, -clip, clip),
            ang_vel=torch.clamp(parts.ang_vel, -clip, clip),
        )
    return zero_vel(parts)


def instability_guard(parts: PartState, pos_bound: float = 10.0):
    """Divergence containment per env: a lane with a non-finite pose or
    velocity, or a part flung outside ``pos_bound`` meters, is sanitized to
    finite values and flagged (the caller marks it done). Returns
    ``(sanitized_parts, unstable [B] bool)``."""
    B = parts.pos.shape[0]
    fin = lambda x: torch.isfinite(x).reshape(B, -1).all(-1)
    unstable = ~(
        fin(parts.pos) & fin(parts.quat) & fin(parts.lin_vel) & fin(parts.ang_vel)
    ) | torch.any(torch.abs(parts.pos).reshape(B, -1) > pos_bound, -1)

    pos = torch.clamp(
        torch.nan_to_num(parts.pos, nan=0.0, posinf=pos_bound, neginf=-pos_bound),
        -pos_bound,
        pos_bound,
    )
    quat = torch.nan_to_num(parts.quat, nan=0.0, posinf=0.0, neginf=0.0)
    norm = torch.linalg.norm(quat, dim=-1, keepdim=True)
    unit = torch.zeros_like(quat)
    unit[..., 0] = 1.0
    quat = torch.where(norm > 1e-6, quat / torch.clamp(norm, min=1e-6), unit)
    sane = zero_vel(PartState(pos, quat, parts.lin_vel, parts.ang_vel))
    return tree_where(unstable, sane, parts), unstable

