"""Physics state of the furniture parts, batch-leading."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PartState(NamedTuple):
    """Pose + velocity of every furniture part of a batch of envs.

    ``pos``/``quat`` is the part *body-origin* pose. ``lin_vel``/``ang_vel``
    are **group** velocities replicated onto every member part (world frame;
    angular about the group COM).
    """

    pos: torch.Tensor       # [B,P,3]
    quat: torch.Tensor      # [B,P,4] wxyz
    lin_vel: torch.Tensor   # [B,P,3]
    ang_vel: torch.Tensor   # [B,P,3]


def init_state(pos: torch.Tensor, quat: torch.Tensor) -> PartState:
    pos = pos.to(torch.float32)
    quat = quat.to(torch.float32)
    return PartState(
        pos=pos,
        quat=quat,
        lin_vel=torch.zeros_like(pos),
        ang_vel=torch.zeros_like(pos),
    )


def zero_vel(parts: PartState) -> PartState:
    return parts._replace(
        lin_vel=torch.zeros_like(parts.lin_vel),
        ang_vel=torch.zeros_like(parts.ang_vel),
    )
