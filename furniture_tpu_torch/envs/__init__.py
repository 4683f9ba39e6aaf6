"""Environments of the port: the batched Cursor env and the batched arm envs."""

from .arm import ArmEnv, ArmState  # noqa: F401
from .cursor import CursorEnv, CursorState  # noqa: F401
