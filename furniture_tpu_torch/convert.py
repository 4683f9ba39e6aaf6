"""State carried across between the two packages, as numpy.

The system has no weights: what crosses from the JAX package is state. A
:class:`CursorState`, an :class:`ArmState` or a :class:`DenseState` travels
as a flat dict of numpy arrays keyed by field name, with the part fields
under ``pos``, ``quat``, ``lin_vel`` and ``ang_vel`` and a dense state's
potential-difference trackers under ``prev_<name>``; a scripted-policy state
(:class:`GenPolicyState`) as a dict keyed by its field names. Batched states
lead with the env dimension. The caller turns a JAX pytree into such a dict
on its side (``np.asarray`` per field), so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .envs.arm import ArmState
from .envs.cursor import CursorState
from .envs.sawyer_dense import DenseState, Prev
from .envs.sawyer_gen import GenPolicyState
from .physics.state import PartState

PART_FIELDS = PartState._fields
STATE_FIELDS = tuple(f for f in CursorState._fields if f != "parts")
ARM_STATE_FIELDS = tuple(f for f in ArmState._fields if f != "parts")
DENSE_STATE_FIELDS = tuple(f for f in DenseState._fields if f not in ("parts", "prev"))
PREV_FIELDS = tuple(f"prev_{f}" for f in Prev._fields)

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
    "phase_i": np.int32,
    "subtask_step": np.int32,
    "leg_dropped": np.bool_,
    "table_moved": np.bool_,
    "leg_lift": np.bool_,
    "leg_fine_aligned": np.int32,
}
GEN_DTYPES = {
    "phase": np.int32,
    "part": np.int32,
    "safepos_len": np.int32,
    "safepos_idx": np.int32,
    "drop_count": np.int32,
    "phase_steps": np.int32,
}


def _tensor(d: dict, name: str, device, dtypes=DTYPES):
    a = np.array(d[name], dtypes.get(name, np.float32))  # a writable copy
    return torch.from_numpy(a).to(device)


def _numpy(x: torch.Tensor, name: str, dtypes=DTYPES) -> np.ndarray:
    return x.detach().cpu().numpy().astype(dtypes.get(name, np.float32))


def _from_numpy(cls, fields, d: dict, device):
    tensor = lambda name: _tensor(d, name, device)

    parts = PartState(*(tensor(f) for f in PART_FIELDS))
    return cls(parts, *(tensor(f) for f in fields))


def _to_numpy(state, fields) -> dict:
    out = {f: _numpy(getattr(state.parts, f), f) for f in PART_FIELDS}
    out.update({f: _numpy(getattr(state, f), f) for f in fields})
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


def dense_state_from_numpy(d: dict, device) -> DenseState:
    """A dict of numpy arrays (see module doc) → the port's DenseState."""
    parts = PartState(*(_tensor(d, f, device) for f in PART_FIELDS))
    prev = Prev(*(_tensor(d, f, device) for f in PREV_FIELDS))
    rest = {f: _tensor(d, f, device) for f in DENSE_STATE_FIELDS}
    return DenseState(parts=parts, prev=prev, **rest)


def dense_state_to_numpy(state: DenseState) -> dict:
    """The port's DenseState → a dict of numpy arrays, keeping the dtypes:
    int32 phases, steps and counters, bool flags, float32 poses and
    trackers."""
    out = _to_numpy(state, DENSE_STATE_FIELDS)
    out.update({f"prev_{f}": _numpy(getattr(state.prev, f), f) for f in Prev._fields})
    return out


def gen_policy_state_from_numpy(d: dict, device) -> GenPolicyState:
    """A dict of numpy arrays keyed by field name → the port's
    GenPolicyState."""
    return GenPolicyState(*(_tensor(d, f, device, GEN_DTYPES) for f in GenPolicyState._fields))


def gen_policy_state_to_numpy(gen: GenPolicyState) -> dict:
    """The port's GenPolicyState → a dict of numpy arrays (int32 phase,
    part, indices and counters; float32 targets and noises)."""
    return {f: _numpy(getattr(gen, f), f, GEN_DTYPES) for f in GenPolicyState._fields}
