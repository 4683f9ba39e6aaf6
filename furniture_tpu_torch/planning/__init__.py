"""Planners over the batched env step: MPPI, CEM and iLQR.

The port's counterpart of ``furniture_tpu.planning``; ``make_sharded_mppi``
splits MPPI's samples over the ranks of a ``parallel.Mesh``.
"""

from .cem import CEMConfig, make_cem
from .ilqr import ILQRConfig, flatten_env_dynamics, make_ilqr
from .mppi import MPPIConfig, assembly_cost, make_mppi, make_sharded_mppi, rollout_costs

__all__ = [
    "CEMConfig",
    "ILQRConfig",
    "MPPIConfig",
    "assembly_cost",
    "flatten_env_dynamics",
    "make_cem",
    "make_ilqr",
    "make_mppi",
    "make_sharded_mppi",
    "rollout_costs",
]
