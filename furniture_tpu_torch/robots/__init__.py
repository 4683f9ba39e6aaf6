"""Articulated robot arms: chain compiler + batched kinematics/dynamics.

The port's counterpart of ``furniture_tpu.robots``: the robot is a static
array description (``CompiledRobot``) and the per-step computation (FK,
Jacobians, mass matrix, joint-space integration) is batched PyTorch.
"""

from .chain import AGENT_SPECS, CompiledRobot, compile_robot
from . import kinematics

__all__ = ["CompiledRobot", "compile_robot", "kinematics", "AGENT_SPECS"]
