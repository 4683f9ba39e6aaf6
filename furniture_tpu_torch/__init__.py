"""furniture_tpu_torch: the PyTorch/CUDA port of furniture_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports
``torch`` and numpy, never ``jax`` and nothing of ``furniture_tpu`` (it
reads that package's JSON assets in place). Its entry points run on the card
by default; ``device="cpu"`` runs the plain PyTorch versions of its kernels
on the CPU.

Ported so far: the batched cursor control step (``CursorEnv.reset_batch``
and ``step_batch``, ``make_vec_env("IKEACursor-v0", ...)``) with the
free-part physics kernel written in CUDA (``physics/csrc/megakernel.cu``),
and the batched arm control step for Sawyer, Panda, Jaco, Fetch and Baxter
(``ArmEnv.reset_batch`` and ``step_batch``, ``make_vec_env("IKEASawyer-v0",
...)``; ik, ik_quaternion, impedance and torque control) with the arm
physics kernel written in CUDA (``physics/csrc/arm_megakernel.cu``).
"""

from .api import make_vec_env  # noqa: F401
from .config import EnvConfig  # noqa: F401
from .envs.arm import ArmEnv  # noqa: F401
from .envs.cursor import CursorEnv  # noqa: F401
