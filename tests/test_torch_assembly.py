"""PyTorch port: the connect kernel's wrapper (``envs/assembly.py::
AssemblyOps.attempt`` and ``snap_move``) on the CPU (numpy and torch only;
no JAX).

The kernel itself runs only on the card (``test_torch_assembly_gpu.py``).
Here: the wrapper's CPU route, which is the plain version and must return,
bit for bit, what the envs' connect glue returned before the kernel existed
(frozen copies of that glue below) on staged connects and misses; and its
refusal of a model beyond the kernel's limits and of another device.
"""

import types
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch_gpu_holds import ConnectState, staged_connects

from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.envs.assembly import MAX_C, AssemblyOps, rows, tree_where
from furniture_tpu_torch.physics.state import zero_vel

torch.set_num_threads(1)

B = 4


class HeldState(NamedTuple):
    """A cursor-like state: the assembly fields and the cursors' parts."""

    parts: object
    group: torch.Tensor
    conn_connected: torch.Tensor
    weld_active: torch.Tensor
    num_connected: torch.Tensor
    subtask: torch.Tensor
    connect_step: torch.Tensor
    connected_body1: torch.Tensor
    connected_body1_pos: torch.Tensor
    connected_body1_quat: torch.Tensor
    selected: torch.Tensor


class TouchState(NamedTuple):
    """An arm-like state: the assembly fields and the fingers' touches."""

    parts: object
    group: torch.Tensor
    conn_connected: torch.Tensor
    weld_active: torch.Tensor
    num_connected: torch.Tensor
    subtask: torch.Tensor
    connect_step: torch.Tensor
    connected_body1: torch.Tensor
    connected_body1_pos: torch.Tensor
    connected_body1_quat: torch.Tensor
    touch_l: torch.Tensor
    touch_r: torch.Tensor


def frozen_cursor_connect(ops, state, connect):
    """``CursorEnv._pre_physics``'s connect half with ``_try_connect`` as
    they stood before the connect kernel, word for word."""
    both = (state.selected[:, 0] >= 0) & (state.selected[:, 1] >= 0)
    do_connect = (connect > 0) & both
    conn_group = state.group[:, ops.conn_part]
    g1 = rows(state.group, torch.clamp(state.selected[:, 0], min=0))
    g2 = rows(state.group, torch.clamp(state.selected[:, 1], min=0))
    prev = state.num_connected
    connected = ops.try_connect(state, conn_group == g1[:, None], conn_group == g2[:, None])
    selected = connected.selected.clone()
    selected[:, 1] = torch.where(
        connected.num_connected > prev, torch.full_like(prev, -1), connected.selected[:, 1]
    )
    connected = connected._replace(selected=selected)
    missed = state._replace(connect_step=torch.zeros_like(state.connect_step))
    return tree_where(do_connect, connected, missed)


def frozen_snap_move(ops, state):
    """``CursorEnv._snap_move`` as it stood before the connect kernel."""
    p1 = torch.clamp(state.connected_body1, min=0)
    move = state.connected_body1_pos - rows(state.parts.pos, p1)
    moved = ops.move_group(state.parts, state.group, p1, move, state.connected_body1_quat)
    return zero_vel(moved)


def frozen_arm_connect(ops, state, connect):
    """``ArmEnv._connect_phase`` as it stood before the connect kernel."""
    both = torch.any(state.touch_l & state.touch_r, dim=1)
    any_touch = torch.any(both, -1)
    target_part = torch.argmax(both.to(torch.uint8), -1)
    conn_group = state.group[:, ops.conn_part]
    g1 = rows(state.group, target_part)
    in1 = conn_group == g1[:, None]
    in2 = torch.ones_like(in1)
    connected = ops.try_connect(state, in1, in2, num_connect_steps=0)
    missed = state._replace(connect_step=torch.zeros_like(state.connect_step))
    state = tree_where((connect > 0) & any_touch, connected, missed)
    snap = state.connected_body1 >= 0
    p1 = torch.clamp(state.connected_body1, min=0)
    move = state.connected_body1_pos - rows(state.parts.pos, p1)
    moved = zero_vel(
        ops.move_group(state.parts, state.group, p1, move, state.connected_body1_quat)
    )
    return state._replace(
        parts=tree_where(snap, moved, state.parts),
        connected_body1=torch.where(
            snap, torch.full_like(state.connected_body1, -1), state.connected_body1
        ),
    )


def leaves(x):
    return [t for f in x for t in leaves(f)] if isinstance(x, tuple) else [x]


def assert_same(got, want):
    assert len(leaves(got)) == len(leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


# (furniture, cursor or arms, seed): each seed stages a connect and a miss
CASES = {"cursor": ("table_lack_0825", 0, 11), "arm": ("swivel_chair_0700", 2, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_route_matches_frozen_glue(case):
    """On CPU tensors ``attempt`` is the plain version: equal, bit for bit,
    to the envs' connect glue before the kernel, on B = 4 staged envs among
    which one connects and one misses; it launches nothing."""
    name, arms, seed = CASES[case]
    ops, st, connect, held, touch, _ = staged_connects(name, B, seed, arms)
    if arms:
        state = TouchState(*st, *touch)
        got, got_held = ops.attempt(state, connect, touch=touch, num_connect_steps=0,
                                    snap_back=True)
        want = frozen_arm_connect(ops, state, connect)
        assert got_held is None
    else:
        state = HeldState(*st, held)
        got, got_held = ops.attempt(state, connect, held=held)
        got = got._replace(selected=got_held)
        want = frozen_cursor_connect(ops, state, connect)
    assert_same(got, want)
    assert ops.launches == 0
    connected = want.num_connected > st.num_connected
    assert bool(connected.any()) and not bool(connected.all()), connected


def test_plain_snap_move_matches_frozen():
    """``snap_move`` on CPU tensors is the cursor's snap-back move before the
    kernel, bit for bit, with and without a snap-back in the env."""
    ops, st, *_ = staged_connects("table_lack_0825", B, 5)
    st = st._replace(connected_body1=torch.tensor([2, -1, 0, 4], dtype=torch.int32))
    assert_same(ops.snap_move(st), frozen_snap_move(ops, st))
    assert ops.launches == 0


def test_limits_and_devices():
    """An ``AssemblyOps`` on the card refuses a model beyond the kernel's
    limits before it touches the card; a state on another device than the
    CPU or the card is refused."""
    C = MAX_C + 1
    big = types.SimpleNamespace(n_parts=5, n_conn=C, n_welds=4, conn_angles=np.zeros((C, 6)))
    with pytest.raises(ValueError, match="MAX_C"):
        AssemblyOps(big, EnvConfig(), "cuda")
    ops, st, connect, held, *_ = staged_connects("table_lack_0825", 2, 1)
    meta = ConnectState(*(t.to("meta") if torch.is_tensor(t) else type(t)(*(x.to("meta") for x in t))
                          for t in st))
    with pytest.raises(RuntimeError, match="no connect attempt"):
        ops.attempt(meta, connect.to("meta"), held=held.to("meta"))
    with pytest.raises(RuntimeError, match="no connect attempt"):
        ops.snap_move(meta)
