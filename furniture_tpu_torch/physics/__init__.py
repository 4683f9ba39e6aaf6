"""Batched rigid-body physics for furniture parts.

Welded parts are merged into composite rigid bodies selected by the per-env
``group`` label array. ``engine`` is the plain PyTorch version of the
substep; ``megakernel`` wraps the CUDA kernel that runs whole control steps
of free parts on the card, ``arm_megakernel`` the one that runs whole
control steps of arm and parts coupled, ``arm_dynamics`` the one that
computes an arm's joint-dynamics matrices for a control step.
"""

from .state import PartState, init_state  # noqa: F401
from .engine import substeps, control_step  # noqa: F401
