"""RL and IL training stack (BC, PPO, SAC, GAIL) on the batched env step.

The port's counterpart of ``furniture_tpu.rl``: the algorithms roll out
through ``step_batch`` (so the physics kernels carry the env steps), the
networks are ``nn.Module``s, and the optimizer is optax's Adam rule
(``networks.ClippedAdam``). PPO and GAIL take a ``parallel.Mesh`` for data
parallelism over several devices (``make_ppo(..., mesh=)``).

Entry point: ``python -m furniture_tpu_torch.tools.train_rl``.
"""

from .bc import BCConfig, BCState, demos_to_dataset, make_bc
from .eval import make_evaluate, ppo_act, sac_act
from .gail import DiscState, GAILConfig, make_gail
from .networks import flatten_obs, obs_dim
from .ppo import PPOConfig, PPOState, make_ppo
from .sac import SACConfig, SACState, make_sac

__all__ = [
    "BCConfig",
    "BCState",
    "DiscState",
    "GAILConfig",
    "PPOConfig",
    "PPOState",
    "SACConfig",
    "SACState",
    "demos_to_dataset",
    "flatten_obs",
    "make_bc",
    "make_evaluate",
    "make_gail",
    "make_ppo",
    "make_sac",
    "obs_dim",
    "ppo_act",
    "sac_act",
]
