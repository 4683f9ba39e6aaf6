"""Typed configuration tree for furniture_tpu_torch.

The port's own copy of ``furniture_tpu.config``: the same frozen
dataclasses with the same fields and defaults, so a configuration means the
same thing in both packages. The port ignores ``SimConfig.use_pallas``,
``mega_block`` and ``arm_mega_block``, which stay for parity of the
dataclass: its batched physics always runs the CUDA kernels
(``physics/megakernel.py``, ``physics/arm_megakernel.py``) on CUDA tensors
and their plain PyTorch versions on CPU tensors. The arm fields
(``arm_lane_budget``, ``robot_coupling``, ``robot_coupling_clamp``,
``gripper_squeeze``, ``grip_press_vel``, ``held_vel_clamp``,
``held_angvel_clamp``; ``EnvConfig.agent_type``, ``control_type``,
``action_repeat``, ``move_speed``, ``rotate_speed``, ``agent_xyz_rand``)
mean what they mean in the JAX package.

Defaults mirror the reference's argparse defaults exactly (citations inline).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SimConfig:
    """Physics integration parameters.

    The reference inherits MuJoCo defaults from ``base.xml`` plus the
    control-frequency flags (``config/furniture.py:72``,
    ``env/furniture.py:172``).
    """

    timestep: float = 0.002          # MuJoCo default model timestep
    control_freq: int = 10           # config/furniture.py:72
    gravity: float = -9.81
    # contact solver
    solver_iters: int = 12           # Jacobi impulse iterations per substep.
                                     # The converged impulses warm-start the
                                     # next substep's sweep (engine.substeps
                                     # + both Pallas kernels), which halves
                                     # the iterations a cold mass-split
                                     # Jacobi solve needed (was 24).
    relaxation: float = 0.55         # Jacobi under-relaxation factor
    baumgarte: float = 0.2           # position-correction fraction per substep
    contact_slop: float = 0.001      # penetration tolerance (m)
    friction: float = 2.0            # floor friction set at env/furniture.py:1971-1977
    max_contacts_per_pair: int = 8
    # stabilization velocity clamp (reference _slow_object: env/furniture.py:2821)
    slow_clip: float = 0.2
    # hard safety clamp on part velocities (replaces the reference's
    # instability-exception reset, env/furniture.py:2889-2897)
    max_velocity: float = 10.0
    # grasp-aware velocity clamp (m/s, rad/s), DISABLED by default (0):
    # measured on 128-lane TPU batches, pinch-gated clamping cost more
    # completed assemblies than it saved (the 2-6 m/s mating-phase leg
    # ejections mostly occur in un-pinched instants, which the gate cannot
    # touch, while the clamp slows legitimate carry corrections).
    held_vel_clamp: float = 0.0
    held_angvel_clamp: float = 8.0
    # kinematic-gripper squeeze overlap: fingers servo at most this far past
    # first part contact (emulates MuJoCo's force-limited finger servos)
    gripper_squeeze: float = 0.004
    # physics backend for *batched* step paths:
    #   "auto" (default): whole-control-step Pallas megakernel on TPU
    #     (physics/megakernel.py — measured ~15-100x over the XLA-fused
    #     per-env path, which is launch/HBM-roundtrip bound at P~5/K~200),
    #     pure XLA elsewhere (CPU tests, virtual-device meshes)
    #   "on": megakernel everywhere (interpret mode off-TPU; slow, test-only)
    #   "off": pure XLA everywhere
    #   "lane": legacy per-env Pallas lane solver (physics/pallas_solver.py,
    #     kept as a validated alternative backend)
    use_pallas: str = "auto"
    # environments per megakernel grid program (lane-dimension block)
    mega_block: int = 256
    # arm megakernel block (more lanes/state per env → smaller block fits VMEM)
    arm_mega_block: int = 128
    # contact-lane budget for the arm megakernel: the robot sample sets
    # densify in tiers under this cap — all hand geoms at the 15-point set
    # if the total lane count fits, else finger geoms dense, else
    # fingertips dense, else all 8-corner (engine.robot_contact_tables;
    # XLA narrow phase and Pallas kernel read the same tables so parity
    # holds). Sized so the kernel's live [K,block] working set fits v5e
    # VMEM: Baxter all-dense (K=2310) and fingers-dense (K=2170) both
    # spill at Mosaic compile; fingertips-dense (K=1610) fits. Sawyer
    # (K=1260 all-dense) keeps the full set.
    arm_lane_budget: int = 1700
    # two-way gripper↔part contact coupling: contact impulses on robot geoms
    # return as Jᵀλ joint-space impulses so grasped part weight loads the arm
    # (MuJoCo native behavior; the reference steps these contacts two-way in
    # mj_step, env/furniture.py:2877-2879)
    robot_coupling: bool = True
    # clamp on the per-joint contact-impulse feedback, expressed as a
    # torque (N·m; impulse cap = value·dt). Physical part-weight loading is
    # ≤1 N·m here; the clamp only removes the pathological spikes that
    # occur when a part state rides the max_velocity clamp (λ ∝ m·10 m/s),
    # which otherwise jerk the arm and turn the pads into bats.
    robot_coupling_clamp: float = 20.0
    # finger-servo press velocity (m/s). The reference's finger position
    # servos are force-limited actuators (kp=1e4-1e6, forcerange ±20 N,
    # grippers/two_finger_gripper.xml): blocked against a part, the pad
    # keeps pressing. Here the press is a prescribed INWARD surface
    # velocity on engaged finger contact lanes (vel_b += v·n̂ while the
    # servo commands closing and penetration holds at the squeeze clamp),
    # so squeeze forces — and with them the friction force closure that
    # carries and reorients grasped parts — emerge from the contact solve
    # itself, momentum-consistently. The impulse level saturates at the
    # warm-start cap (engine.WARM_CAP_ACC × per-lane effective mass —
    # inertia-aware, so gram-scale sticks are not over-torqued). Replaces
    # both the retired grip_torsion/grip_linear/grip_gravity_comp blend
    # assists and the round-5 interim fixed-force normal floor, whose
    # unconditional pad-couple noise spun light parts out of the grasp.
    grip_press_vel: float = 0.05


@dataclass(frozen=True)
class AlignConfig:
    """Connector alignment thresholds (``config/furniture.py:202-226``)."""

    pos_dist: float = 0.1
    rot_dist_up: float = 0.9
    rot_dist_forward: float = 0.9
    project_dist: float = 0.3


@dataclass(frozen=True)
class RewardConfig:
    """Reward coefficients (``config/furniture.py:291-295``)."""

    ctrl_penalty_coef: float = 1e-3
    unstable_penalty_coef: float = 100.0
    success_reward: float = 100.0
    touch_reward: float = 10.0
    pick_reward: float = 100.0


@dataclass(frozen=True)
class DenseRewardConfig:
    """8-phase dense-reward coefficients
    (``config/furniture_sawyer_dense.py:26-72``; defaults replicated)."""

    diff_rew: bool = True
    phase_bonus: float = 5000.0
    eef_forward_dist_coef: float = 2.0
    eef_up_dist_coef: float = 4.0
    eef_rot_threshold: float = 0.95
    gripper_penalty_coef: float = 1.0
    move_other_part_penalty_coef: float = 50.0
    drop_penalty_coef: float = 20.0
    early_termination: bool = False
    init_eef_pos_dist_coef: float = 100.0
    move_eef_pos_dist_coef: float = 100.0
    lower_eef_pos_dist_coef: float = 1000.0
    grasp_dist_coef: float = 200.0
    lift_z_dist_coef: float = 500.0
    lift_xy_dist_coef: float = 250.0
    lift_z_pos_threshold: float = 0.02
    lift_xy_pos_threshold: float = 0.05
    align_pos_dist_coef: float = 100.0
    align_rot_dist_coef: float = 50.0
    align_pos_threshold: float = 0.2
    align_rot_threshold: float = 0.85
    move_pos_dist_coef: float = 300.0
    move_rot_dist_coef: float = 50.0
    move_pos_threshold: float = 0.06
    move_rot_threshold: float = 0.85
    move_fine_pos_exp_coef: float = -25.0
    move_fine_pos_dist_coef: float = 500.0
    move_fine_rot_dist_coef: float = 200.0
    aligned_bonus_coef: float = 10.0
    ctrl_penalty_coef: float = 0.0001
    phase_ob: bool = False


@dataclass(frozen=True)
class EnvConfig:
    """Top-level environment configuration."""

    furniture_name: str = "table_lack_0825"
    agent_type: str = "Cursor"       # Cursor | Sawyer | Baxter | Panda | Jaco | Fetch
    control_type: str = "ik"         # ik | ik_quaternion | impedance | torque | velocity
    max_episode_steps: int = 2000    # config/furniture.py:164-168
    move_speed: float = 0.1          # config/furniture.py:84
    rotate_speed: float = 22.5       # config/furniture.py:87 (degrees)
    cursor_boundary: float = 1.5     # config/furniture.py:288
    num_connects: int | None = None  # config/furniture.py:81 (None -> all welds)
    # reset randomization (config/furniture.py:177-200)
    furn_xyz_rand: float = 0.02
    furn_rot_rand: float = 3.0       # degrees
    agent_xyz_rand: float = 0.0
    # furniture resize (config/furniture.py:197-200; env/furniture.py:1428-1431):
    # scale = furn_size_scale * (1 + U(-furn_size_rand, furn_size_rand)),
    # applied at model-compile time (the reference likewise rebuilds the model)
    furn_size_rand: float = 0.0
    furn_size_scale: float = 1.0
    # cursor connect needs N consecutive connect steps (furniture_cursor.py:32)
    num_connect_steps: int = 10
    # recipe-prefix preassembly at reset: these recipe subtask indices start
    # connected (welds active, groups merged) — the reference's
    # ``--preassembled`` / ``set_subtask`` (config/furniture.py:158,
    # env/furniture.py:1492-1566, :205-207). When ``num_connects`` is also
    # set, success requires num_connects connects BEYOND the preassembled
    # ones (env/furniture.py:1479)
    preassembled: tuple = ()
    # pickle path of an initial-state pool: at reset, with probability 0.8,
    # part poses (and robot qpos when present) are drawn from the pool
    # instead of the placement sampler (``--load_init_states``,
    # env/furniture.py:127-130, 1433-1434)
    load_init_states: str | None = None
    # observation toggles (config/furniture.py:229-285)
    robot_ob: bool = True
    object_ob: bool = True
    object_ob_all: bool = True
    subtask_ob: bool = False
    # camera observations (config/furniture.py:248-276): rendered on-device
    # by furniture_tpu.render instead of Unity/mujoco-py offscreen GL
    camera_ob: bool = False
    depth_ob: bool = False
    segmentation_ob: bool = False
    screen_width: int = 500
    screen_height: int = 500
    # sub-configs
    sim: SimConfig = field(default_factory=SimConfig)
    align: AlignConfig = field(default_factory=AlignConfig)
    reward: RewardConfig = field(default_factory=RewardConfig)
    dense: DenseRewardConfig = field(default_factory=DenseRewardConfig)
    # control
    control_timestep: float | None = None  # derived: 1/control_freq
    action_repeat: int = 3           # env/furniture.py:172 (ik mode)

    @property
    def n_substeps(self) -> int:
        """Physics substeps per control step (env/furniture.py:2877-2879)."""
        return int((1.0 / self.sim.control_freq) / self.sim.timestep)

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


def default_config(**overrides) -> EnvConfig:
    return EnvConfig(**overrides)
