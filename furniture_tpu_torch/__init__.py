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
...)``; all nine control types, the five torque-space controllers through
``controllers/osc.py``) with the arm physics kernel written in CUDA
(``physics/csrc/arm_megakernel.cu``); the lane-solver backend
(``SimConfig(use_pallas="lane")``, ``physics/lane_solver.py``) with its
kernel in CUDA (``physics/csrc/lane_solver.cu``); the sampling planners
MPPI and CEM over ``step_batch`` (``planning``); the initial-state pool
(``utils.init_pool``, ``set_init_state_pool``); and the task envs on the arm
kernel: the dense-reward Sawyer env (``envs.sawyer_dense``,
``make_vec_env("IKEASawyerDense-v0", ...)``), the scripted demo generator
with batched ``generate_demos`` (``envs.sawyer_gen``, ``IKEASawyerGen-v0``,
the CLI ``furniture_tpu_torch/tools/generate_demos.py``) and the Baxter
toy-table flip (``envs.baxter_toytable``), with the demo recorder and loader
(``utils.demo``) and the native trajectory store (``utils.traj_store``); the
iLQR planner (``planning.ilqr``) and the single-device RL/IL stack (``rl``:
BC, PPO, SAC, GAIL, evaluation; ``utils.checkpoint``; the CLI
``python -m furniture_tpu_torch.tools.train_rl``); data parallelism over
several devices with ``torch.distributed`` (``parallel``: sharded PPO and
GAIL through ``make_ppo(..., mesh=)``, ``make_sharded_mppi``, ``train_rl
--mesh``); the ray-cast renderer (``render``, camera observations) and the
single-env wrapper ``make_env``; ``utils.info_dict`` and
``utils.video_recorder``.
"""

from .api import make_env, make_vec_env  # noqa: F401
from .config import EnvConfig  # noqa: F401
from .envs.arm import ArmEnv  # noqa: F401
from .envs.cursor import CursorEnv  # noqa: F401
