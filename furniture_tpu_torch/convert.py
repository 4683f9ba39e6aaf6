"""State carried across between the two packages, as numpy.

The system has no weights: what crosses from the JAX package is state. A
:class:`CursorState` or an :class:`ArmState` travels as a flat dict of numpy
arrays keyed by field name, with the part fields under ``pos``, ``quat``,
``lin_vel`` and ``ang_vel``. Batched states lead with the env dimension. The caller turns a
JAX pytree into such a dict on its side (``np.asarray`` per field), so this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .envs.arm import ArmState
from .envs.cursor import CursorState
from .physics.state import PartState

PART_FIELDS = PartState._fields
STATE_FIELDS = tuple(f for f in CursorState._fields if f != "parts")
ARM_STATE_FIELDS = tuple(f for f in ArmState._fields if f != "parts")

# numpy dtypes of the discrete fields; everything else is float32
DTYPES = {
    "group": np.int32,
    "selected": np.int32,
    "connect_step": np.int32,
    "num_connected": np.int32,
    "subtask": np.int32,
    "connected_body1": np.int32,
    "t": np.int32,
    "conn_connected": np.bool_,
    "weld_active": np.bool_,
    "touched": np.bool_,
    "picked": np.bool_,
    "touch_l": np.bool_,
    "touch_r": np.bool_,
}


def _from_numpy(cls, fields, d: dict, device):
    def tensor(name):
        a = np.array(d[name], DTYPES.get(name, np.float32))  # a writable copy
        return torch.from_numpy(a).to(device)

    parts = PartState(*(tensor(f) for f in PART_FIELDS))
    return cls(parts, *(tensor(f) for f in fields))


def _to_numpy(state, fields) -> dict:
    out = {}
    for f in PART_FIELDS:
        out[f] = getattr(state.parts, f).detach().cpu().numpy().astype(np.float32)
    for f in fields:
        out[f] = getattr(state, f).detach().cpu().numpy().astype(
            DTYPES.get(f, np.float32)
        )
    return out


def cursor_state_from_numpy(d: dict, device) -> CursorState:
    """A dict of numpy arrays (see module doc) → the port's CursorState."""
    return _from_numpy(CursorState, STATE_FIELDS, d, device)


def cursor_state_to_numpy(state: CursorState) -> dict:
    """The port's CursorState → a dict of numpy arrays, keeping the dtypes:
    int32 groups, selections and counters, bool flags, float32 poses."""
    return _to_numpy(state, STATE_FIELDS)


def arm_state_from_numpy(d: dict, device) -> ArmState:
    """A dict of numpy arrays (see module doc) → the port's ArmState."""
    return _from_numpy(ArmState, ARM_STATE_FIELDS, d, device)


def arm_state_to_numpy(state: ArmState) -> dict:
    """The port's ArmState → a dict of numpy arrays, keeping the dtypes:
    int32 groups and counters, bool flags and touches, float32 poses and
    joint state."""
    return _to_numpy(state, ARM_STATE_FIELDS)
