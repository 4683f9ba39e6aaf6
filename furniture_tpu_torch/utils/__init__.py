"""Host-side utilities of the port (numpy only): the initial-state pool,
demo recording and loading, the native trajectory store and the logger."""

from . import demo, init_pool, logger, traj_store

__all__ = ["demo", "init_pool", "logger", "traj_store"]
