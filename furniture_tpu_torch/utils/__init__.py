"""Host-side utilities of the port: the initial-state pool, demo recording
and loading, the native trajectory store, the logger and training
checkpoints."""

from . import checkpoint, demo, init_pool, logger, traj_store

__all__ = ["checkpoint", "demo", "init_pool", "logger", "traj_store"]
