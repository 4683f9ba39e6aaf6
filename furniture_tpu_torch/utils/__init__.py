"""Host-side utilities of the port: the initial-state pool, demo recording
and loading, the native trajectory store, the logger, training
checkpoints, per-step info aggregation, the video recorder and the
profiler spans of the env step."""

from . import (checkpoint, demo, info_dict, init_pool, logger, trace, traj_store,
               video_recorder)

__all__ = ["checkpoint", "demo", "info_dict", "init_pool", "logger", "trace", "traj_store",
           "video_recorder"]
