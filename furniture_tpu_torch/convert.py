"""State and parameters carried across between the two packages, as numpy.

What crosses from the JAX package is env state, the iLQR flat state and
the RL stack's parameters (the last two at the end of this module). A
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


# -- the iLQR flat state -------------------------------------------------------
#
# The reference flattens the continuous fields with ``ravel_pytree`` of a
# dict, which orders them by key; the port's ``flatten_env_dynamics`` keeps
# its own order, ``unravel.layout`` (a tuple of ``(name, shape)``).


def _jax_flat_slices(layout):
    """Where each field of ``layout`` lies in the reference's flat vector."""
    sizes = {name: int(np.prod(shape)) for name, shape in layout}
    out, o = {}, 0
    for name in sorted(sizes):
        out[name] = slice(o, o + sizes[name])
        o += sizes[name]
    return out


def ilqr_flat_from_jax(x, layout) -> np.ndarray:
    """The reference's flat iLQR state (or a batch of them, ``[..., n]``)
    in the port's order ``layout``."""
    x = np.asarray(x, np.float32)
    where = _jax_flat_slices(layout)
    return np.concatenate([x[..., where[name]] for name, _ in layout], -1)


def ilqr_flat_to_jax(x, layout) -> np.ndarray:
    """The port's flat iLQR state (``[..., n]``, order ``layout``) in the
    reference's order."""
    x = np.asarray(x, np.float32)
    offs, o = {}, 0
    for name, shape in layout:
        size = int(np.prod(shape))
        offs[name] = slice(o, o + size)
        o += size
    return np.concatenate([x[..., offs[name]] for name in sorted(offs)], -1)


# -- RL parameters ----------------------------------------------------------------
#
# The reference's RL parameters are pytrees of arrays: an MLP is a list of
# ``{"w": [in, out], "b": [out]}`` layers, a policy ``{"trunk": mlp,
# "log_std": ...}``, and a training state's ``params`` a dict of those
# (``{"pi", "vf"}`` for PPO; ``{"pi", "q1", "q2", "q1_t", "q2_t",
# "log_alpha"}`` for SAC). The port's modules (``rl.networks``) name the
# same things ``<path>.layers.<i>.weight`` (``wᵀ``), ``<path>.layers.<i>.bias``
# and ``<path>.log_std``; a head that is an MLP in the reference is an MLP
# module in the port, so the paths match key for key.


def rl_params_to_state_dict(tree) -> dict:
    """A reference parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) → a state dict for the port's module."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, (list, tuple)):
            for i, layer in enumerate(node):
                out[f"{prefix}layers.{i}.weight"] = torch.from_numpy(
                    np.array(np.asarray(layer["w"], np.float32).T))
                out[f"{prefix}layers.{i}.bias"] = torch.from_numpy(
                    np.array(layer["b"], np.float32))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, np.float32))

    walk(tree, "")
    return out


def state_dict_to_rl_params(sd: dict):
    """The port's state dict → the reference's parameter pytree (numpy)."""
    root: dict = {}
    for key, value in sd.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()

    def build(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"layers"}:
            layers = node["layers"]
            return [{"w": layers[str(i)]["weight"].T.copy(), "b": layers[str(i)]["bias"]}
                    for i in range(len(layers))]
        return {k: build(v) for k, v in node.items()}

    return build(root)
