"""Controllers of the port: batched damped-least-squares IK. The
torque-space controllers (``furniture_tpu.controllers.osc``) are not ported
yet."""

from .ik import dls_ik, ik_velocities

__all__ = ["dls_ik", "ik_velocities"]
