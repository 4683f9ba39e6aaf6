"""Batched Cursor environment: two cursors that select, carry, rotate and
connect furniture parts.

The port's counterpart of ``furniture_tpu.envs.cursor``, written for a batch
of envs at once. The action layout is 15-dim: 2 cursors × (move3, rotate3,
select1) + connect1. Each control step zeroes all part velocities,
gravity-compensates held groups and runs ``n_substeps`` physics substeps
through the free-part kernel (``physics/megakernel.py``) or, with
``SimConfig(use_pallas="lane")``, through the lane-solver backend
(``physics/lane_solver.py``); a connect snaps
site2's group onto site1 after ``num_connect_steps`` aligned attempts and
welds the two groups. The connect attempt and the post-connect snap-back
move are one launch each of the connect kernel (``AssemblyOps.attempt`` and
``AssemblyOps.snap_move``, ``envs/assembly.py``). The reward is sparse:
``success_reward`` per new connect, minus ``unstable_penalty_coef`` for a
lane the instability guard had to sanitize.

Entry points run on CUDA by default (``device=None``); only an explicit
``device="cpu"`` runs on the CPU, where the physics is the kernel's plain
PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import transforms as T
from ..config import EnvConfig
from ..models import CompiledModel, compile_from_config
from ..physics.engine import physics_tables
from ..physics.megakernel import make_batched_substeps
from ..physics.state import PartState, init_state, zero_vel
from ..utils.init_pool import load_pool
from ..utils.trace import span
from .assembly import (
    AssemblyOps,
    apply_reset_variants,
    instability_guard,
    pool_to_device,
    rows,
    sample_placement,
    settle_parts,
    tree_where,
)

_CURSOR_MARGIN = 0.06  # cursor box half 0.01 + geom margin 0.05


class CursorState(NamedTuple):
    """Complete state of a batch of envs (every field leads with B)."""

    parts: PartState
    group: torch.Tensor                 # [B,P] int32 rigid-group label
    cursor_pos: torch.Tensor            # [B,2,3]
    selected: torch.Tensor              # [B,2] int32 part index or -1
    connect_step: torch.Tensor          # [B] int32
    num_connected: torch.Tensor         # [B] int32
    conn_connected: torch.Tensor        # [B,C] bool: site already used
    weld_active: torch.Tensor           # [B,W] bool
    subtask: torch.Tensor               # [B,2] int32 (-1,-1 if done)
    connected_body1: torch.Tensor       # [B] int32 (-1: none) post-settle snap
    connected_body1_pos: torch.Tensor   # [B,3]
    connected_body1_quat: torch.Tensor  # [B,4]
    t: torch.Tensor                     # [B] int32 episode step


def resolve_device(device) -> torch.device:
    """``None`` means the card; the CPU only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: furniture_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch version on "
            "the CPU"
        )
    return dev


class CursorEnv:
    """Batched reset/step of one furniture model on one device.

    ``reset_batch``/``step_batch`` are the entry points; ``reset``/``step``
    are their B=1 views without the batch dimension."""

    def __init__(
        self,
        config: EnvConfig | None = None,
        model: CompiledModel | None = None,
        device=None,
    ):
        self.config = config or EnvConfig()
        self.device = resolve_device(device)
        self.model = model or compile_from_config(self.config)
        self.tables = physics_tables(self.model)
        m = self.model
        self._P = m.n_parts
        self._C = m.n_conn
        self._W = m.n_welds
        nc = self.config.num_connects
        if nc is not None:
            self.success_num_connects = int(nc) + len(self.config.preassembled)
        else:
            self.success_num_connects = int(m.num_connects)
        self.dof = 15
        self.ops = AssemblyOps(m, self.config, self.device)
        # the batched substeps per SimConfig.use_pallas: the free-part
        # kernel's wrapper (kernel on CUDA, plain on CPU) or the lane backend
        self.physics = make_batched_substeps(self.tables, self.config.sim, self.device)

        dev = self.device
        tb = self.tables
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self._gpart = torch.as_tensor(np.asarray(tb["geom_part"], np.int64), device=dev)
        self._gpos = f32(tb["geom_pos"])
        self._gquat = f32(tb["geom_quat"])
        self._gsize = f32(tb["_box_sizes"])
        self._part_of = torch.as_tensor(
            np.asarray(tb["geom_part"])[None, :] == np.arange(self._P)[:, None], device=dev
        )                                                        # [P,G]
        # constants of the step, made once (a tensor built from a Python
        # list per step would be a blocking host-to-device copy)
        b = self.config.cursor_boundary
        ms = self.config.move_speed
        self._lo_bound = f32([-b, -b, -0.05])
        self._hi_bound = f32([b, b, b])
        self._cursor_start = f32([[-0.2, 0.0, ms / 2], [0.2, 0.0, ms / 2]])
        self._identity_quat = f32([1.0, 0.0, 0.0, 0.0])
        # initial-state pool (utils/init_pool), as tensors on the device
        self._init_pool = None
        if self.config.load_init_states:
            self.set_init_state_pool(load_pool(self.config.load_init_states))

    def set_init_state_pool(self, pool) -> None:
        """Install an initial-state pool (a dict of stacked arrays or a list
        of snapshots, see ``utils.init_pool``); None removes it."""
        self._init_pool = None if pool is None else pool_to_device(pool, self.device)

    def _physics(self, parts: PartState, group, gscale, n: int) -> PartState:
        with span("ft.env.physics"):
            parts = PartState(*(t.contiguous() for t in parts))
            return self.physics.substeps(parts, group.contiguous(), gscale.contiguous(), n)

    # -- cursor-specific helpers --------------------------------------------

    def _part_overlaps_cursor(self, parts: PartState, cursor_pos):
        """[B,P]: does the cursor point-with-margin touch any geom of the part?"""
        g = self._gpart
        wpos = parts.pos[:, g] + T.quat_rotate(parts.quat[:, g], self._gpos)
        wquat = T.quat_mul(parts.quat[:, g], self._gquat)
        local = T.quat_rotate(T.quat_inv(wquat), cursor_pos[:, None] - wpos)  # [B,G,3]
        d = torch.clamp(torch.abs(local) - self._gsize, min=0.0)
        touch = torch.linalg.norm(d, dim=-1) <= _CURSOR_MARGIN              # [B,G]
        return torch.any(self._part_of[None] & touch[:, None, :], -1)

    # -- cursor sub-actions ------------------------------------------------

    def _cursor_update(self, state: CursorState, idx: int, act7) -> CursorState:
        cfg = self.config
        move = act7[:, 0:3] * cfg.move_speed
        rot = act7[:, 3:6] * cfg.rotate_speed
        select = act7[:, 6] > 0

        selected = state.selected.clone()
        selected[:, idx] = torch.where(
            select, state.selected[:, idx], torch.full_like(state.selected[:, idx], -1)
        )
        state = state._replace(selected=selected)

        # move cursor with boundary check
        cur = state.cursor_pos[:, idx]
        new_cpos = cur + move
        b = cfg.cursor_boundary
        move_ok = torch.all(torch.abs(new_cpos) < b, -1) & (
            new_cpos[:, 2] >= cfg.move_speed * 0.45
        )
        cursor_pos = state.cursor_pos.clone()
        cursor_pos[:, idx] = torch.where(move_ok[:, None], new_cpos, cur)
        state = state._replace(cursor_pos=cursor_pos)

        # move the held group (reverted when it would leave the bounds)
        holding = state.selected[:, idx] >= 0
        sel = torch.clamp(state.selected[:, idx], min=0)
        target_quat = T.euler_to_quat(rot, rows(state.parts.quat, sel))
        moved = self.ops.move_group(state.parts, state.group, sel, move, target_quat)
        lo, hi = self.ops.group_bbox(moved, state.group, sel)
        inside = torch.all(lo >= self._lo_bound, -1) & torch.all(hi <= self._hi_bound, -1)
        cp = state.cursor_pos.clone()
        cp[:, idx] = torch.where(
            inside[:, None], state.cursor_pos[:, idx], state.cursor_pos[:, idx] - move
        )
        moved_state = state._replace(
            parts=tree_where(inside, moved, state.parts), cursor_pos=cp
        )
        state = tree_where(move_ok & holding, moved_state, state)

        # acquire selection: the first part that the cursor touches whose
        # group neither cursor holds
        overlap = self._part_overlaps_cursor(state.parts, state.cursor_pos[:, idx])
        sel0 = state.selected[:, 0]
        sel1 = state.selected[:, 1]
        g = state.group
        g0 = rows(g, torch.clamp(sel0, min=0))
        g1 = rows(g, torch.clamp(sel1, min=0))
        taken = (sel0 >= 0)[:, None] & (g == g0[:, None])
        taken = torch.where((sel1 >= 0)[:, None], taken | (g == g1[:, None]), taken)
        cand = overlap & ~taken
        any_c = torch.any(cand, -1)
        first = torch.argmax(cand.to(torch.uint8), -1).to(torch.int32)
        new_sel = torch.where(any_c, first, torch.full_like(first, -1))
        do_select = move_ok & select & ~holding
        selected = state.selected.clone()
        selected[:, idx] = torch.where(do_select, new_sel, state.selected[:, idx])
        return state._replace(selected=selected)

    # -- reset ----------------------------------------------------------------

    def sample_parts(self, num_envs: int, generator: torch.Generator) -> PartState:
        """Randomized placement with overlap rejection (zero velocities)."""
        pos, quat = sample_placement(
            self.model, self.config, num_envs, generator, self.device
        )
        return init_state(pos, quat)

    def _initial_state(self, parts: PartState) -> CursorState:
        """The post-settle state: every part its own group, cursors at their
        start poses, the first weld as subtask."""
        B = parts.pos.shape[0]
        dev = self.device
        i32 = lambda v, shape: torch.full(shape, v, dtype=torch.int32, device=dev)
        return CursorState(
            parts=parts,
            group=torch.arange(self._P, dtype=torch.int32, device=dev)[None].repeat(B, 1),
            cursor_pos=self._cursor_start[None].repeat(B, 1, 1),
            selected=i32(-1, (B, 2)),
            connect_step=i32(0, (B,)),
            num_connected=i32(0, (B,)),
            conn_connected=torch.zeros((B, self._C), dtype=torch.bool, device=dev),
            weld_active=torch.zeros((B, self._W), dtype=torch.bool, device=dev),
            subtask=self.ops.initial_subtask(B),
            connected_body1=i32(-1, (B,)),
            connected_body1_pos=torch.zeros((B, 3), device=dev),
            connected_body1_quat=self._identity_quat[None].repeat(B, 1),
            t=i32(0, (B,)),
        )

    def reset_from_parts(self, parts: PartState, generator=None) -> CursorState:
        """Settle sampled parts (10 rounds of 10 gravity-compensated substeps,
        each one kernel launch) and build the initial state. ``generator``
        gives the pool draws when an initial-state pool is installed."""
        B = parts.pos.shape[0]
        group = torch.arange(self._P, dtype=torch.int32, device=self.device)[None].repeat(B, 1)
        parts = settle_parts(self._physics, parts, group, self.config.sim)
        return apply_reset_variants(
            self.ops, self.config, self._init_pool, self._initial_state(parts), generator
        )

    def reset_batch(self, num_envs: int, generator: torch.Generator) -> CursorState:
        """Batched reset: placement sampled on ``generator``, then settle."""
        return self.reset_from_parts(self.sample_parts(num_envs, generator), generator)

    def observe(self, state: CursorState) -> dict:
        """Observation dict (batched): object_ob [B,7P], robot_ob [B,8],
        subtask_ob [B,2]."""
        with span("ft.env.observe"):
            obs = {}
            B = state.group.shape[0]
            if self.config.object_ob:
                obs["object_ob"] = torch.cat(
                    [state.parts.pos, state.parts.quat], dim=-1
                ).reshape(B, -1)
            if self.config.robot_ob:
                obs["robot_ob"] = torch.cat(
                    [state.cursor_pos.reshape(B, -1), (state.selected >= 0).to(torch.float32)],
                    -1,
                )
            if self.config.subtask_ob:
                obs["subtask_ob"] = state.subtask + 1
            return obs

    # -- step -----------------------------------------------------------------

    def _pre_physics(self, state: CursorState, action):
        """Cursor sub-actions + connect attempt; returns the updated state and
        the held-part mask [B,P] for the physics step."""
        state = self._cursor_update(state, 0, action[:, 0:7])
        state = self._cursor_update(state, 1, action[:, 7:14])

        # the connect attempt: both held groups' conn sites are the
        # candidates; a snap lets go of cursor 1's part
        with span("ft.env.connect"):
            state, selected = self.ops.attempt(state, action[:, 14], held=state.selected)
        state = state._replace(selected=selected)

        held = torch.zeros(state.group.shape, dtype=torch.bool, device=self.device)
        for i in range(2):
            sel = state.selected[:, i]
            g_sel = rows(state.group, torch.clamp(sel, min=0))
            held = torch.where(
                (sel >= 0)[:, None], held | (state.group == g_sel[:, None]), held
            )
        return state, held

    def _finish(self, state: CursorState, prev_connected):
        """Instability guard + reward + termination."""
        cfg = self.config
        state = state._replace(t=state.t + 1)
        parts, unstable = instability_guard(state.parts)
        state = state._replace(parts=parts)
        newly = (state.num_connected - prev_connected).to(torch.float32)
        reward = (
            cfg.reward.success_reward * newly
            - cfg.reward.unstable_penalty_coef * unstable.to(torch.float32)
        )
        success = state.num_connected >= self.success_num_connects
        done = success | (state.t >= cfg.max_episode_steps) | unstable
        info = {
            "success": success,
            "num_connected": state.num_connected,
            "success_reward": cfg.reward.success_reward * newly,
            "unstable": unstable,
        }
        return state, self.observe(state), reward, done, info

    def step_batch(self, states: CursorState, actions):
        """One control step for a batch. Returns (state, obs, reward [B],
        done [B], info)."""
        with span("ft.env.step"):
            actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
            prev_connected = states.num_connected
            with span("ft.env.control"):
                states, held = self._pre_physics(states, actions)

            gscale = torch.where(held, 0.0, 1.0)
            parts = self._physics(
                zero_vel(states.parts), states.group, gscale, self.config.n_substeps
            )
            hold3 = held[..., None]
            parts = parts._replace(
                lin_vel=torch.where(hold3, 0.0, parts.lin_vel),
                ang_vel=torch.where(hold3, 0.0, parts.ang_vel),
            )
            states = states._replace(parts=parts)

            # post-connect snap-back + one substep. The gate is a per-env
            # select after an unconditional 1-substep launch, not a host-side
            # `if snap.any()`: the branch would synchronise the host with the
            # card every step, while the extra launch costs about 1/50 of the
            # step's physics.
            with span("ft.env.connect"):
                snap = states.connected_body1 >= 0
                settled = self._physics(self.ops.snap_move(states), states.group, gscale, 1)
                states = states._replace(
                    parts=tree_where(snap, settled, states.parts),
                    connected_body1=torch.where(
                        snap, torch.full_like(states.connected_body1, -1),
                        states.connected_body1,
                    ),
                )
            with span("ft.env.finish"):
                return self._finish(states, prev_connected)

    # -- single-env views ------------------------------------------------------

    def reset(self, generator: torch.Generator) -> CursorState:
        """Single-env reset: the B=1 batch without its batch dimension."""
        return _squeeze(self.reset_batch(1, generator))

    def step(self, state: CursorState, action):
        """Single-env step: (state, obs, reward, done, info) without the batch
        dimension."""
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        s, obs, rew, done, info = self.step_batch(_unsqueeze(state), action[None])
        squeeze = lambda d: {k: v[0] for k, v in d.items()}
        return _squeeze(s), squeeze(obs), rew[0], done[0], squeeze(info)


def _squeeze(state):
    if isinstance(state, tuple):
        return type(state)(*(_squeeze(x) for x in state))
    return state[0]


def _unsqueeze(state):
    if isinstance(state, tuple):
        return type(state)(*(_unsqueeze(x) for x in state))
    return state[None]
