"""Sampling planners over the batched env step: MPPI and CEM.

The port's counterpart of ``furniture_tpu.planning`` without ``ilqr`` (it
needs the physics differentiable) and ``make_sharded_mppi`` (it needs the
multi-device layer), which are not ported yet.
"""

from .cem import CEMConfig, make_cem
from .mppi import MPPIConfig, assembly_cost, make_mppi, rollout_costs

__all__ = [
    "CEMConfig",
    "MPPIConfig",
    "assembly_cost",
    "make_cem",
    "make_mppi",
    "rollout_costs",
]
