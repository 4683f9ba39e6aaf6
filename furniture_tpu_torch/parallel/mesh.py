"""The device mesh over ``torch.distributed``, and its collectives.

The port's counterpart of ``furniture_tpu.parallel.mesh``. JAX drives a
mesh of devices from one process (``Mesh`` plus ``shard_map``); here each
device has a process of its own, and a :class:`Mesh` is this process's
place in the group: its rank, the world size, the process group and its
device. A batch sharded over the mesh (JAX's ``P(axis)``) is, on rank r,
the rows ``[r*B/n, (r+1)*B/n)`` of its leading axis.

``mpi_average``, ``mpi_sum`` and ``mpi_min`` are the counterparts of
``pmean``, ``psum`` and ``pmin`` (the reference's MPI helpers,
``util/mpi.py:5-38``). Each is one ``all_reduce`` and returns a new
tensor; every rank receives the same bits.

Backends: ``nccl`` on the card, ``gloo`` when the caller asks for it or
passes ``device="cpu"``. Gloo takes CUDA tensors for ``broadcast`` and
``all_reduce`` only, so every collective here is built on those two
(``gather_batch`` too), and a gloo group over CUDA tensors works: that is
how two ranks share one card for checking (NCCL refuses two ranks on one
device).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# what torchrun sets for every process it starts
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """One process's place in a 1-D mesh of ``world_size`` devices."""

    rank: int
    world_size: int
    group: Any                  # the torch.distributed process group
    device: torch.device
    axis: str = "env"


def make_mesh(n_devices: int | None = None, backend: str | None = None, axis: str = "env",
              device=None) -> Mesh:
    """This process's :class:`Mesh` over the default process group.

    The group must be initialised already, or the variables that
    ``torchrun`` sets must be there, and then the group is initialised from
    them (``init_method="env://"``). Without either this raises, also for
    one device: the mesh never quietly runs alone. ``n_devices``, where
    given, must be the world size. The backend is ``nccl`` unless
    ``backend="gloo"`` is asked for or ``device="cpu"`` is passed; a group
    initialised with another backend raises. ``device`` defaults to the
    card ``cuda:LOCAL_RANK`` (torchrun's local rank; the rank without it),
    which becomes the current device."""
    dev = None if device is None else torch.device(device)
    want = backend or ("gloo" if dev is not None and dev.type == "cpu" else "nccl")
    if not dist.is_initialized():
        missing = [v for v in _TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(
                "make_mesh needs an initialised torch.distributed process group or the "
                f"variables torchrun sets (missing: {', '.join(missing)}); run under "
                "torchrun --nproc_per_node N"
            )
        dist.init_process_group(want, init_method="env://")
    got = dist.get_backend()
    if got != want:
        raise ValueError(f"the process group runs {got!r}, the mesh wants {want!r}")
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks")
    if dev is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return Mesh(rank, world, dist.group.WORLD, dev, axis)


def fold_seed(seed: int, rank: int) -> int:
    """A seed for ``rank``, decorrelated from every other rank's and drawn
    from one ``seed`` (the counterpart of ``jax.random.fold_in(key,
    axis_index)``): the first word of numpy's ``SeedSequence((seed,
    rank))``."""
    return int(np.random.SeedSequence((seed, rank)).generate_state(1)[0])


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def _rows(mesh: Mesh, b: int) -> int:
    if b % mesh.world_size:
        raise ValueError(f"a batch of {b} does not divide over {mesh.world_size} ranks")
    return b // mesh.world_size


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous rows of the leading axis of every leaf of
    ``tree`` (tensors in any nesting of NamedTuples, tuples, lists and
    dicts): rows ``[r*B/n, (r+1)*B/n)`` on rank r. A view, no copy."""

    def take(x):
        b = _rows(mesh, x.shape[0])
        return x[mesh.rank * b:(mesh.rank + 1) * b]

    return _tree_map(take, tree)


def gather_batch(mesh: Mesh, tree):
    """The reverse of :func:`shard_batch`: every leaf with the rows of all
    ranks along its leading axis, rank order, on every rank. Built on
    ``all_reduce`` (each rank writes its rows into zeros, then a SUM), which
    gloo takes for CUDA tensors as well; booleans travel as ``uint8``. For
    tests and logging: it moves world_size times the batch."""

    def gather(x):
        b = x.shape[0]
        full = torch.zeros((b * mesh.world_size,) + tuple(x.shape[1:]),
                           dtype=torch.uint8 if x.dtype == torch.bool else x.dtype,
                           device=x.device)
        full[mesh.rank * b:(mesh.rank + 1) * b] = x
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
        return full.bool() if x.dtype == torch.bool else full

    return _tree_map(gather, tree)


def _all_reduce(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


def mpi_average(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks (``pmean``): a SUM ``all_reduce`` divided by the
    world size (gloo has no AVG)."""
    return _all_reduce(mesh, x, dist.ReduceOp.SUM) / mesh.world_size


def mpi_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``psum``)."""
    return _all_reduce(mesh, x, dist.ReduceOp.SUM)


def mpi_min(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the ranks (``pmin``)."""
    return _all_reduce(mesh, x, dist.ReduceOp.MIN)


def broadcast_module(mesh: Mesh, module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into ``module`` on every rank, in
    place."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.group)
