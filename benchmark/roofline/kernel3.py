"""Kernel 3, the lane solver (``lane_solve_kernel``): its work per launch,
frozen from ``lane_solver.fp32_ops_per_env`` and ``bytes_per_env`` as the
benchmark was defined. No cell drives it yet; a cell of the lane backend
(``SimConfig(use_pallas="lane")``) reads it.

The work depends on the data: the contact test of every lane, then the
preparation, lane scale and each sweep's update only of the lanes with a
contact (``active``; ``active_b`` of them with a part on side b), and the
bytes of what those lanes need.
"""

from __future__ import annotations

PATTERN = "lane_solve_kernel"

CROSS = 9
DOT = 5
PREP_LANE = 3 + 2 + CROSS + (DOT + 2) + 3 + CROSS + 3 * (CROSS + 21 + 1 + 2) + 6
PREP_LANE_B = 3 + 1 + 3 * (CROSS + 21 + 1)
PREP_VEL_B = 3 * DOT + 1 + 2
SCALE_LANE = 5
SWEEP_LANE = (CROSS + 3) + CROSS + 3 * (DOT + 3) + 7 + 3 + 15 + 3 + CROSS + 6
SWEEP_LANE_B = (CROSS + 6) + CROSS + 6
SWEEP_PART = 6 + 18


def ops_per_env(K: int, K_b: int, P: int, iters: int, active: int | None = None,
                active_b: int | None = None, vel_b: bool = False) -> int:
    """FP32 operations of one env's solve."""
    a = K if active is None else active
    ab = K_b if active_b is None else active_b
    prep = K + a * (PREP_LANE + SCALE_LANE + (PREP_VEL_B if vel_b else 0)) + ab * PREP_LANE_B
    return int(prep + iters * (a * SWEEP_LANE + ab * SWEEP_LANE_B + P * SWEEP_PART))


def bytes_per_env(K: int, P: int, masked: int | None = None, active: int | None = None,
                  vel_b: bool = False) -> int:
    """Bytes one env's solve reads and writes: every lane's mask, the depth
    of each ``masked`` lane, point and normal (and ``vel_b``) of each
    ``active`` lane, the group label, COM, inverse mass and inertia and both
    velocities of every part in, both velocities out."""
    m = K if masked is None else masked
    a = K if active is None else active
    return K + 4 * m + a * (24 + (12 if vel_b else 0)) + P * (4 + 12 + 4 + 36 + 12 + 12) + P * 24
