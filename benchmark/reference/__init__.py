"""The benchmark's plain reference: plain PyTorch, float32, no kernels.

A frozen copy of the port's plain path (the transforms, the model and robot
compilers, the narrow phase and the Jacobi engine, the cursor, assembly and
arm env glue, kinematics, controllers and MPPI), taken when the benchmark
was defined. It imports nothing of ``furniture_tpu_torch``, ``furniture_tpu``
or JAX, compiles each model from the asset JSON itself, and runs the plain
versions of the two physics kernels (``physics/plain.py``) on any device.
Later changes to the port do not reach it: it is the yardstick ``correct``
is judged by. ``make(env_id, config, device, state_dtype)`` builds an env;
``state_dtype`` gives the control, the same env with its state rounded
through a lower precision after every substep.
"""

from __future__ import annotations

from .config import EnvConfig
from .envs.arm import make_arm_env
from .envs.cursor import CursorEnv

_ARM_IDS = {f"IKEA{a}-v0": a for a in ("Sawyer", "Panda", "Jaco", "Fetch", "Baxter")}


def make(env_id: str, config: EnvConfig, device, state_dtype=None):
    """The reference env of a gym id of the port's registry."""
    if env_id == "IKEACursor-v0":
        return CursorEnv(config.replace(agent_type="Cursor"), device=device,
                         state_dtype=state_dtype)
    if env_id in _ARM_IDS:
        return make_arm_env(_ARM_IDS[env_id])(config, device=device, state_dtype=state_dtype)
    raise ValueError(f"the reference has no env {env_id!r}")
