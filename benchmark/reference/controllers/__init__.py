"""Controllers of the port: batched damped-least-squares IK (``ik``) and
the torque-space controllers (``osc``)."""

from .ik import dls_ik, ik_velocities
from .osc import (
    joint_impedance_torques,
    joint_velocity_torques,
    load_controller_config,
    osc_torques,
)

__all__ = [
    "dls_ik",
    "ik_velocities",
    "joint_impedance_torques",
    "joint_velocity_torques",
    "load_controller_config",
    "osc_torques",
]
