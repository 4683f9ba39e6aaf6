"""Baxter toy-table flip task, batched.

The port's counterpart of ``furniture_tpu.envs.baxter_toytable`` (reference
``furniture_baxter_toytable.py``): the bimanual Baxter must grasp the
upside-down table top with both hands, flip it upright, and bring it near
the target position.

* the furniture is pinned to ``toy_table_flip`` (:21);
* fixed initial placement with noise (``_place_objects`` :61-86);
* two-stage reward (``_compute_reward`` :100-165): grip-hand distances while
  the top's connector up-vector points down, flip/lift shaping, success at
  ``rot_dist_up > 0.98`` with the table within 0.2 m of the target.

The JAX package gives these semantics to its single-env ``reset`` and
``step`` only; its inherited batched ``reset_batch``/``step_batch`` keep the
generic settled placement and the sparse reward. The port's batched entry
points follow the single-env path: ``reset_batch`` places the parts at the
fixed poses after the arm reset, and the flip reward is the ``_finish_step``
hook of the inherited ``step_batch``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import transforms as T
from ..config import EnvConfig
from ..physics.state import zero_vel
from ..robots import kinematics as K
from .arm import ArmEnv, ArmState

_TARGET_TABLE_POS = np.array([0.2, -0.1, 0.15], np.float32)  # :58

# fixed initial placement (:70-84)
_POS_INIT = {
    "4_part4": [-0.1968, -0.0288, 0.03878],
    "2_part2": [0.2, 0.16578, 0.02379],
}
_QUAT_INIT = {
    "4_part4": [0.099711762, 0.00028753, 0.00037843, 0.07586979],
    "2_part2": [-0.6725, 0.6417, -0.2970, -0.2186],
}


class FurnitureBaxterToyTableEnv(ArmEnv):
    def __init__(self, config: EnvConfig | None = None, model=None, device=None):
        config = (config or EnvConfig()).replace(
            agent_type="Baxter", furniture_name="toy_table_flip"
        )
        super().__init__(config, model, device)
        m = self.model
        self._table_idx = m.part_names.index("4_part4")
        site2id = {n: i for i, n in enumerate(m.site_names)}
        self._r_site = site2id["4_part4_right_site"]
        self._l_site = site2id["4_part4_left_site"]
        conn2id = {n: i for i, n in enumerate(m.conn_names)}
        self._top_conn = conn2id["top-leg,,conn_site4"]
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self._pos_init = f32([_POS_INIT[n] for n in m.part_names])
        self._quat_init = T.quat_normalize(f32([_QUAT_INIT[n] for n in m.part_names]))
        self._target = f32(_TARGET_TABLE_POS)
        self._ez = f32([0.0, 0.0, 1.0])

    def reset_batch(self, num_envs: int, generator: torch.Generator, noise=None) -> ArmState:
        """``ArmEnv.reset_batch``, then the fixed placement at rest, offset
        by uniform noise in ±furn_xyz_rand [B, 3P] (three per part, in part
        order), drawn from ``generator`` after the reset's own draws unless
        ``noise`` is given."""
        state = super().reset_batch(num_envs, generator)
        if noise is None:
            u = torch.rand((num_envs, 3 * self._P), generator=generator, device=self.device)
            noise = self.config.furn_xyz_rand * (2.0 * u - 1.0)
        pos = self._pos_init + noise.reshape(num_envs, -1, 3)
        quat = self._quat_init.expand(num_envs, -1, -1).clone()
        return state._replace(parts=zero_vel(state.parts._replace(pos=pos, quat=quat)))

    def _finish_step(self, state: ArmState, action, prev_connected):
        """Guard and the two-stage flip reward (furniture_baxter_toytable.py
        :100-165), as the JAX package's single-env ``step`` computes them;
        the touch and pick bookkeeping of the sparse reward is not kept."""
        cfg = self.config
        state, unstable = self._guard(state)
        state = state._replace(t=state.t + 1)
        parts = state.parts

        cp = int(self.model.conn_part[self._top_conn])
        up = T.up_vector_from_quat(parts.quat[:, cp])
        rot_dist_up = T.cos_siml(up, self._ez)
        table_dist = torch.linalg.norm(parts.pos[:, self._table_idx] - self._target, dim=-1)
        table_rot_rew = 0.1 * (rot_dist_up - 1.0)

        fk_out = K.fk(self.robot, state.qpos)
        r_hand, _ = K.site_world(self.robot, fk_out, "right")
        l_hand, _ = K.site_world(self.robot, fk_out, "left")
        site_w = self.ops.site_world(parts)
        r_tgt, l_tgt = site_w[:, self._r_site], site_w[:, self._l_site]
        r_gh_dist = torch.linalg.norm(r_hand - r_tgt, dim=-1)
        l_gh_dist = torch.linalg.norm(l_hand - l_tgt, dim=-1)
        flipped_down = rot_dist_up < 0
        zero = torch.zeros_like(rot_dist_up)
        r_gh_rew = -torch.where(flipped_down, r_gh_dist, zero)
        l_gh_rew = -torch.where(flipped_down, l_gh_dist, zero)

        dz = r_tgt[:, 2] - l_tgt[:, 2]
        lift_rew = torch.where(
            flipped_down,
            dz,
            torch.where(table_dist < 0.4, 2.0 * (0.5 - torch.clamp(dz, min=0.0)), zero),
        )
        ctrl_rew = -cfg.reward.ctrl_penalty_coef * torch.linalg.norm(action[:, :12], dim=-1)

        success = (rot_dist_up > 0.98) & (table_dist < 0.2)
        success_rew = torch.where(success, torch.full_like(zero, 100.0), zero)
        reward = (
            success_rew + ctrl_rew + table_rot_rew + r_gh_rew + l_gh_rew + lift_rew
            - cfg.reward.unstable_penalty_coef * unstable.to(torch.float32)
        )
        done = success | (state.t >= cfg.max_episode_steps) | unstable
        info = {
            "success": success,
            "unstable": unstable,
            "table_rot_rew": table_rot_rew,
            "lift_rew": lift_rew,
            "r_gh_dist": r_gh_dist,
            "l_gh_dist": l_gh_dist,
            "table_dist": table_dist,
            "ctrl_rew": ctrl_rew,
        }
        return state, self.observe(state), reward, done, info
