"""Environments of the port: the batched Cursor env, the batched arm envs
and the task envs on the arm (dense-reward Sawyer, the scripted demo
generator, the Baxter toy-table flip)."""

from .arm import ArmEnv, ArmState  # noqa: F401
from .baxter_toytable import FurnitureBaxterToyTableEnv  # noqa: F401
from .cursor import CursorEnv, CursorState  # noqa: F401
from .sawyer_dense import DenseState, FurnitureSawyerDenseRewardEnv  # noqa: F401
from .sawyer_gen import FurnitureSawyerGenEnv, GenPolicyState  # noqa: F401
