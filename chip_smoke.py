"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``furniture_tpu_torch``; nothing of JAX or of the JAX
package is imported) on the card:

1. build: compiles every CUDA kernel of the port from the sources in the
   checkout (one ``nvcc`` per source, started together: the free-part
   kernel ``megakernel.cu`` and the arm kernel ``arm_megakernel.cu``, both
   on the shared header ``physics_common.cuh``, and the lane solver
   ``lane_solver.cu``; beside them the phase-clock builds of all three,
   the same sources with ``-DFT_PHASE_CLOCKS``: six at once) and prints
   the ``-Xptxas -v`` report;
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card, TF32 off, at the shapes the main paths give it.
   Free-part kernel (table_lack, B=256, from a settled reset; n = 5 within
   1e-4 and n = 50 within 1e-3) and on a model whose lane working set
   exceeds shared memory (chair_balser_0115, K = 4153). Cases: free parts
   with velocities; parts 0 and 1 welded where they lie apart with part 2
   gravity-compensated; and on table_lack parts welded by connects (two
   recipe steps preassembled) with a free leg gravity-compensated; and a
   leg laid across another, so that SAT edge lanes carry the contact
   (n = 1 and 5 within 1e-4). Two parts welded where they lie apart make a
   body whose 50-substep motion is chaotic: there the plain version's own
   spread under a 1e-7 input perturbation is measured and the kernel is
   held to 10x it where that exceeds the bound. Every case is launched
   twice: the two results must agree bit for bit (the sums are taken in a
   fixed order, no float atomics).
   Arm kernel (B=256): Sawyer (K = 1260) from a reset with part 0 placed
   between the fingers and the gripper closing, n = 5 within 5e-4 and
   n = 50 within 1e-3; Baxter (K = 1610) with part 0 on a fingertip, n = 5
   within 5e-4; a free state (no contact), n = 50 within 1e-3;
   ``robot_coupling=False``, a held-velocity clamp, and the global-scratch
   route (a lowered shared-memory limit), n = 5. One substep of the
   gripped states is held to 5e-4 in every env. Over more substeps a part
   pinched between kinematic pads is ill-conditioned in a few envs of the
   batch (a lane on a threshold flips): there the median over the envs is
   held to the bound, at most a tenth of the envs may exceed it, and the
   maximum is held to 10x the plain version's own spread under position
   noise of 1e-7 and 1e-6, all printed. Touch flags must be equal, and set
   where the part is gripped. Two launches on one input must agree bit for
   bit.
   Lane solver (B=256; one launch from the raw contacts to the
   velocities), on contacts taken from real states: table_lack (K = 210)
   with a leg laid on the table top and chair_balser_0115 (K = 4153, P = 8;
   the global-scratch route) from a reset dropped onto the floor, table_lack
   with two recipe steps preassembled (welded groups), each with part
   velocities of 0.1 m/s; the leg case also through the global-scratch
   route, with a non-zero ``vel_b``
   (kinematic lanes), and with every lane masked (the velocities must come
   back exactly): ``solve_contacts_lane`` on the card against
   ``plain_solve_contacts_lane`` on the card at 12 and 24 sweeps within
   1e-4 on both velocities; two launches on one input must agree bit for
   bit; the gap to ``engine._solve_contacts`` started cold is printed and
   held to 2e-3 (linear) and 5e-3 (angular) with rtol 1e-3;
3. main paths, each with the launch counts set to 0 before it and read
   after it: ``make_vec_env("IKEACursor-v0", num_envs=4096)``, reset and 10
   steps of uniform random actions; ``make_vec_env("IKEASawyer-v0",
   num_envs=512, control_type="impedance")`` and the same id with
   ``control_type="ik"`` at 256 envs, reset and 10 steps each. The counts
   must be what the code implies (the settle launches of the free-part
   kernel; one arm-kernel launch per impedance step, ``action_repeat`` = 3
   per ik step); the state must stay finite and in range, and a small batch
   must agree with the port's CPU run (the plain versions). Then the lane
   path, ``make_vec_env("IKEACursor-v0", num_envs=4096,
   sim=SimConfig(use_pallas="lane"))``: reset and 5 steps (100 lane-solver
   launches per reset, 50 + 1 per step, none of the free-part kernel); the
   planners on ``CursorEnv(SimConfig(timestep=0.02, solver_iters=8))``:
   three receding-horizon MPPI plans of horizon 64 x 256 samples on the
   default backend (128 free-part launches a plan), one on the lane backend
   (384 lane-solver launches), one CEM iteration of horizon 16 x 256
   samples, costs finite, means within [-1, 1], a plan repeated from the
   same seed equal; and Sawyer at 512 envs under ``position_orientation``
   and ``joint_impedance``, reset and 5 steps, one arm-kernel launch per
   step, finite and not unstable. Then the task envs: the scripted demo
   generator (``make_vec_env("IKEASawyerGen-v0")``, ik, default
   ``SimConfig``) at 128 envs, ``reset_batch`` and 30 steps of
   ``scripted_action`` + ``step_batch`` (3 arm-kernel launches a step, the
   reset's 10 of the free-part kernel), finite, not unstable, some env past
   the phase it started in, the step and the policy decision timed apart
   (median and spread over the last 20 steps); a staged connect at 8 envs
   (a leg placed between the fingers, 8 closing steps, then up to 250
   policy steps from ``ALIGN_CONN``) that must connect in some env, whose
   pre-connect state, restored with ``restore_snapshot`` and stepped with
   the recorded action, must connect again; and ``generate_demos`` through
   ``furniture_tpu_torch/tools/generate_demos.py``'s ``generate`` at batch
   16 for 30 steps, its stats schema checked and, where a demo succeeded,
   its pickles and trajectory-store records read back. Then the iLQR
   planner and the RL trainers: iLQR on the cursor at ``bench.py``'s configuration
   (``SimConfig(solver_iters=8)``, 10 substeps a step, horizon 64 x 5
   iterations, parallel Riccati, cursor 0 holding part 0 driven to a
   target 18 cm away): a warm-up solve that must beat the zero-control
   rollout, then 3 timed solves warm-started as ``bench.py`` evolves them,
   64 + 5 x 64 free-part launches each, then one iteration's steps timed
   apart, and the free-part kernel held against its plain version at the
   planner's own inputs (recorded at three steps of the initial rollout,
   one env, and of the line search, 5 envs; the held group at gscale 0)
   at n = 5 within 1e-4 and n = 10 within 1e-3; one solve of 1 iteration
   of the same problem on the lane backend (10 lane-solver launches a
   planner step: 1,280), and the lane solver held against its plain
   version at 8 sweeps on the first substep of the recorded steps within
   1e-4; the arm form of its dynamics (Sawyer impedance, 5 substeps, the
   parts in motion): one arm-kernel launch for the ``autograd.Function``'s
   forward, within 5e-4 of the plain version, and its Jacobian along 4
   random directions against central differences of the kernel forward
   (at whichever eps of 1e-3, 3e-4, 1e-4 the plain forward's own
   differences come closest, the step being smooth only between contact
   onsets), within twice the plain forward's own gap or 1e-3 of
   max |J d|; the RL stack on the cursor at default
   ``SimConfig``: 2 PPO iterations at ``PPOConfig()`` (128 launches each
   plus 10 a step with a done), its rollout and update timed apart, a
   checkpoint round trip of the card's state (bit-exact), 20 SAC
   iterations at ``SACConfig()`` (16 of warm-up), one GAIL iteration on
   expert arrays of the cursor's widths made from the seed, BC on the
   committed demos (the loss must fall), ``make_evaluate`` at 64 episodes x
   200 steps (410 launches), and ``train_rl.train`` for 2 iterations (the
   entry point: metrics lines, ``result.json``, 686 launches plus resets);
   then the renderer: ``make_render_fn``'s chunked frames against the
   generic per-geom path for the cursor (table_lack) and Sawyer at
   200 x 200 on 8 envs (``seg`` identical, ``rgb`` within 1e-5, depth
   finite on hits and inf elsewhere), and the reference's two render-on
   workloads (``bench.py:118-160``, ``:304-309``) as rollouts of random
   actions, ``step_batch`` then a render every step, 5 steps x 3 rounds:
   Sawyer impedance at 128 envs, 200 x 200 (one arm-kernel launch a step)
   and the cursor at 32 envs, 500 x 500 (two free-part launches a step),
   the step and the render timed apart, the peak memory read; the
   single-env wrapper ``make_env`` on the card for ``IKEACursor-v0`` and
   ``IKEASawyer-v0`` (ik) with all three camera observations at 64 x 64:
   reset and 3 steps, shapes, the three render modes equal to the
   observations, an unknown mode raising, the launch counts; the
   multi-device layer:
   world size 1 on nccl in this process, sharded MPPI 64 x 256 against
   ``make_mppi`` on the same noise within 1e-5 (128 launches), the two
   timed in turns; then two ranks spawned on the one card with gloo over
   CUDA tensors (NCCL refuses two ranks on one device), each the same plan
   within 1e-5 and one sharded PPO iteration at ``PPOConfig()`` (128 lanes
   a rank, 128 launches), the networks identical on both ranks (a MIN and
   a MAX all-reduce of them); a rank that fails, or both not done within
   420 s, fails the run. Each of these paths also has its kernel held
   against its plain version at its own inputs, recorded (``recording``)
   on one step of it run after the counted one, at phase 2's bounds (after
   5 substeps within 1e-4 for kernel 1 and 5e-4 for kernel 2, after the
   call's own n within 1e-3) and, since a rollout's late states are
   ill-conditioned in a few envs, by its rule for a gripped part: the
   median over the envs within the bound and at most a tenth of them
   over it; kernel 2's maximum within 10x the plain version's own spread
   under 3 draws each of 1e-7 and 1e-6 of position noise, kernel 1's every
   env within 10x the plain version's own spread in that env (20 draws
   each of 1e-7 and 1e-6 of noise on the positions and quaternions and,
   where a lane of the plain run sits within rounding of the contact
   threshold, that threshold moved 8 ulp either way: ``hold_free``) where
   that is larger than the bound: the render rollouts' (kernel 2 at 128 envs,
   kernel 1 at 32), the wrapper's (B = 1: kernel 1's two calls, the ik
   step's three kernel-2 calls), the sharded plan's at world size 1 (256
   rows) and rank 0's (128 rows, the plan's ``SimConfig``), and rank 0's
   PPO rollout's (128 lanes); then the whole registry: every furniture
   model of ``models.furniture_names`` (64) as a ``CursorEnv`` and the six
   models of ``tests/test_all_furniture_runtime.py``'s arm subset as
   Sawyer impedance, at that test's ``SimConfig(timestep=0.01,
   solver_iters=6)`` and 16 envs: reset and 3 steps of its actions, its
   checks on every env (finite, unit quaternions, above the floor, finite
   reward and observations), the launches (10 a reset; 2 a cursor step, 1
   an impedance step), the free-part kernel held against its plain
   version after 5 substeps from the settled reset and, for the cursor
   envs, from the stepped state (``hold_free``: every env within 1e-4 or
   within 10x the plain version's own spread in that env; the median and
   the count of envs over 1e-4, at most a tenth, taken over the envs where
   that spread is within 1e-4, since a model's reset can be chaotic in
   most of its envs), and for the arm envs the arm kernel at each of the
   3 steps' recorded inputs by the rule above, one
   ``[sweep]`` line a model (P, K, the routes of kernels 1 and 3 or 2,
   reset and step ms); the lane solver timed on its two routes at 4096
   envs and 12 sweeps in turns (one lane a thread on table_lack, global
   scratch on chair_balser_0115, K = 4153) on a dropped reset's contacts;
   then each command-line tool of ``furniture_tpu_torch/tools/`` through
   its ``main()`` with small arguments, outputs in a temporary directory,
   the launches of the kernel wrappers each tool built counted and each
   of those kernels held, by the rule above, at the inputs of its last
   call in the tool (Baxter ik and impedance at 512 envs in ``fps``,
   the dense Sawyer of ``eval_bc``, the generator of ``profile_gen``,
   each reset's settle among them): ``run_demo
   --state_replay`` on a committed demo (its 1,570 states, 4 connects) and
   action replay of its first 30 actions, ``run_manual`` on a key script
   with a screenshot, ``eval_bc`` at 5 epochs x 8 episodes x 20 steps,
   ``fps --all`` at batch 512 (Baxter ik and impedance among its rows),
   ``resize`` into a temporary asset copy (nothing written into the real
   one), ``profile_gen`` at 16 envs x 30 steps, and ``profile_cursor`` and
   ``profile_ilqr`` at their bench sizes, each phase's seconds printed;
4. times with CUDA events after a warm-up: env steps/s of ``step_batch``
   for the cursor (B = 4096) and for Sawyer impedance (B = 512) and ik
   (B = 256), the cursor and impedance steps as the median of three rounds
   of 10 steps with every round printed, each beside the ms the host took
   to enqueue a step (where the two agree the host sets the pace), each
   kernel's ms per launch at n = 50, its plain version's ms, and the bound
   from its bytes and FP32 operations; for the two
   physics kernels also the blocks an SM holds, the latency floor (the block
   barriers of a launch as the phase-clock build counts them x the measured
   round trip of a bare barrier at that occupancy x the waves of blocks) and, from the phase-clock build, the
   share of a block's clock each phase of a substep takes (``[time] kernel
   phases:`` and ``[time] arm kernel phases:``); the free-part kernel also
   with parts welded (table_lack with two recipe steps preassembled) beside
   the free case, both at B = 4096, n = 50; for the Sawyer
   step also ``joint_dyn_matrices`` and the IK solve; the lane solver's ms
   per launch at B = 4096, K = 210, 12 sweeps and with every lane forced
   into contact, beside ``solve_contacts_lane`` as a whole, its plain version and
   ``engine._solve_contacts`` at the same shape, its blocks an SM, latency
   floor and phase shares (``[time] lane phases:``); the lane path's step,
   MPPI plans/s on each backend and the ``position_orientation`` step with
   the controller's share.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Exits non-zero without a card, and when run
from a directory that holds this script without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FULL_POWER_W = 700.0

MAIN_B = 4096
CHECK_B = 256
STEPS = 10
LANE_STEPS = 5
CTRL_STEPS = 5
ARM_RUNS = (("impedance", 512), ("ik", 256))   # bench.py's Sawyer sizes
# the scripted demo generator: tools/generate_demos.py's usage batch, the
# staged connect of tests/test_dense_gen.py and the CLI's entry point
GEN_B = 128
GEN_STEPS = 30
STAGED_B = 8
STAGED_MAX = 250
ENTRY_B = 16
ENTRY_STEPS = 30
# the iLQR planner at bench.py's configuration (bench.py:201-256): the cursor
# on SimConfig(solver_iters=8), 10 substeps a planner step, cursor 0 holding
# part 0, which the cost drives to a target 18 cm away
ILQR = dict(horizon=64, iterations=5, parallel_riccati=True)
ILQR_SUBSTEPS = 10
ILQR_SOLVES = 3
ARM_JAC_SUBSTEPS = 5
# central differences of the arm dynamics: directions, and the steps tried
ARM_FD_DIRS, ARM_FD_EPS = 4, (1e-3, 3e-4, 1e-4)
# the RL stack on the cursor at default SimConfig: PPOConfig() (256 envs x 64
# steps), SACConfig() (64 envs; 16 iterations of warm-up = 1,024 transitions,
# then updates), one GAIL iteration, BC on the committed demos, the
# evaluation at 64 episodes x 200 steps, and train_rl for 2 iterations
PPO_ITERS = 2
SAC_ITERS = 20
BC_EPOCHS = 5
EVAL_EPISODES, EVAL_STEPS = 64, 200
TRAIN_RL_ITERS = 2
# the renderer: chunked against generic at 200 x 200 on 8 envs, then the
# reference's two render-on workloads (bench.py:118-160, :304-309) as
# rollouts of random actions, a step then a render, 5 steps x 3 rounds
RENDER_CHECK = (8, 200)
RENDER_RUNS = (("sawyer_impedance_render200", 128, 200), ("cursor_render500", 32, 500))
RENDER_HORIZON, RENDER_ROUNDS = 5, 3
WRAPPER_STEPS, WRAPPER_SIDE = 3, 64
# the multi-device layer: MPPI at the bench configuration on world size 1
# (nccl) and 2 (two processes on the one card, gloo over CUDA tensors), and
# one sharded PPO iteration at PPOConfig() on world size 2
NOISE_DRAWS = 20    # per noise size, for the plain version's own spread in an env
MESH_WORLD = 2
MESH_TIMEOUT_S = 420
# the whole registry on the card: every furniture model as a cursor env,
# then tests/test_all_furniture_runtime.py's six-model arm subset as Sawyer
# impedance, at that test's coarse SimConfig (its _COARSE), reset + 3 steps
SWEEP_SIM = dict(timestep=0.01, solver_iters=6)
SWEEP_B = 16
SWEEP_STEPS = 3
SWEEP_ARM = ("table_lack_0825", "swivel_chair_0700", "chair_agne_0007", "bench_bjursta_0210",
             "desk_mikael_1064", "shelf_ivar_0678")
# kernel 3's two routes timed in turns at the bench batch (default SimConfig,
# 12 sweeps): one lane a thread on table_lack, global scratch on chair_balser
LANE_ROUTE_MODELS = ("table_lack_0825", "chair_balser_0115")
# the port's command-line tools, each main() with small arguments
TOOL_DEMO = os.path.join("demos", "generated", "Sawyer_table_lack_0825_0000.pkl")
TOOL_REPLAY_ACTIONS = 30
TOOL_SCRIPT = "w w e SPACE c t"
TOOL_GEN = (16, 30)          # profile_gen --batch, --max_steps
# ms per launch of the two physics kernels before their redesign (n = 50;
# B = 4096 and B = 512; NVIDIA H100 80GB HBM3, 700.00 W, this script at that
# time): printed beside the new times, not part of the ``kernels`` line
PREV_KERNEL_MS = 22.07
PREV_ARM_KERNEL_MS = 19.89
# phases of a substep as the phase-clock builds count them
MEGA_PHASES = ("frames+aggregates", "narrow phase+prep", "first pass (gates+counts+warm start)",
               "passes: group half", "passes: lane half", "integration+floor")
LANE_PHASES = ("loads", "preparation+counts", "sweeps: lane half", "sweeps: group half")
ARM_PHASES = ("joint update+chain+hand geoms | held clamp+frames+aggregates", "narrow phase+prep",
              "first pass (gates+counts+warm start | servo gates+actuators)",
              "passes: group half", "passes: lane half", "integration+floor+hand-geom forces")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def stamp(section: str) -> None:
    """Where the run's time goes: seconds since the start, per section."""
    print(f"[clock] {time.perf_counter() - T_START:7.1f} s: {section}", flush=True)


def card_name_and_limit() -> tuple[str, float]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    watts = float(out.split(",")[-1].strip().split()[0])
    return out, watts


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_and_host_ms(fn, reps: int) -> tuple[float, float]:
    """Mean ms per call of ``fn`` over ``reps`` calls by CUDA events, and the
    ms per call the host took to enqueue them (host clock, before the
    synchronisation): where the two agree the host sets the pace."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def median_round(fn, reps: int, rounds: int = 3):
    """``cuda_and_host_ms`` over ``rounds`` rounds of ``reps`` calls: the
    round with the median device time, and every round's device ms (the
    host-paced steps move from round to round)."""
    got = sorted(cuda_and_host_ms(fn, reps) for _ in range(rounds))
    return got[len(got) // 2], [round(ms, 3) for ms, _ in got]


def max_err(a, b) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_shares(clocks, names, n: int):
    """Shares of a block's clock per phase (mean over the envs) and the
    cycles a block spends on a substep, from a ``[B, phases]`` clock tensor
    of a launch of ``n`` substeps."""
    c = clocks[:, : len(names)].double()
    shares = (c / c.sum(-1, keepdim=True).clamp(min=1)).mean(0).tolist()
    return shares, c.sum(-1).mean().item() / n


def latency_floor(phys, clocks, sm_count: int):
    """(floor ms, blocks an SM, barriers a launch, barrier round trip in
    us): the block barriers a block passed in the substep loop of a launch
    (counted by the phase-clock build, the last column of ``clocks``), times
    the measured round trip of a bare barrier with as many blocks of the
    kernel's size resident on every SM as the kernel has, times the waves the
    blocks come in."""
    resident = phys.resident_blocks()
    counts = clocks[:, -1]
    barriers = int(counts[0])
    if barriers <= 0 or not bool((counts == barriers).all()):
        fail(f"the blocks of a launch counted different numbers of barriers ({counts.unique().tolist()})")
    probe_n = 20000
    blocks = resident * sm_count
    phys.barrier_probe(blocks, 100)  # warm-up
    trip_ms = cuda_ms(lambda: phys.barrier_probe(blocks, probe_n), 3) / probe_n
    waves = -(-clocks.shape[0] // blocks)
    return waves * barriers * trip_ms, resident, barriers, trip_ms * 1e3


def _timed(fn):
    """(fn(), seconds) on the host clock, the card synchronised on both
    sides."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


class recording:
    """``with recording(env, keep) as calls:`` copies into ``calls`` the
    inputs of each physics call ``env`` makes while the block runs, the
    last ``keep`` of them: a cursor env's ``_physics(parts, group, gscale,
    n)``, an arm env's ``physics.control_step(parts, group, gscale, qpos,
    qvel, ctrl, tau_extra, G1, G2, n)``. The calls run as before; main
    holds the kernels against their plain versions on what was recorded."""

    def __init__(self, env, keep: int):
        arm = hasattr(env.physics, "control_step")
        self.owner, self.name = (env.physics, "control_step") if arm else (env, "_physics")
        self.keep = keep

    def __enter__(self):
        return record_calls(self.owner, self.name, self.keep)

    def __exit__(self, *exc):
        delattr(self.owner, self.name)
        return False


def record_calls(owner, name: str, keep: int):
    """Replace the method ``owner.name`` by one that also keeps copies of
    the inputs of its last ``keep`` calls, in the deque returned."""
    import collections

    import torch

    from furniture_tpu_torch.physics.state import PartState

    calls = collections.deque(maxlen=keep)
    inner = getattr(owner, name)

    def own(a):
        if isinstance(a, PartState):
            return PartState(*map(own, a))
        return a.clone(memory_format=torch.contiguous_format) if torch.is_tensor(a) else a

    def record(*args):
        calls.append(tuple(map(own, args)))
        return inner(*args)

    setattr(owner, name, record)
    return calls


def flat_call(call):
    """A recorded free-part call ``(parts, group, gscale, n)`` as a tuple of
    tensors and an int, which ``torch.load`` reads with ``weights_only``."""
    return tuple(call[0]) + tuple(call[1:])


def unflat_call(flat):
    from furniture_tpu_torch.physics.state import PartState

    return (PartState(*flat[:4]),) + tuple(flat[4:])


def drive_ilqr(dev, backend="auto", iterations=ILQR["iterations"], solves=ILQR_SOLVES):
    """iLQR on the cursor at bench.py's configuration: a warm-up solve of
    ``iterations`` iterations, then ``solves`` timed solves, each from the
    start state nudged by 1e-4 (i + 1) and warm-started with the previous
    plan, as bench.py's ``evolve`` does; then one iteration's steps timed
    apart, and run once more with the physics inputs recorded. ``backend``
    is ``SimConfig.use_pallas``. Returns ``(out, env, recorded)``: ``out``
    a dict of what it measured, the physics kernel's launches per solve
    (the free-part kernel's, or the lane solver's under
    ``backend="lane"``) in ``launches``, those of the warm-up solve in
    ``warm_up_launches``; ``recorded`` the inputs ``(parts, group,
    gscale, n)`` of three steps of the initial rollout (one env) and of
    the line search (``len(alphas)`` envs), at t = 0, H/2 and H - 1."""
    import torch

    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.physics import lane_solver
    from furniture_tpu_torch.physics.state import PartState
    from furniture_tpu_torch.planning import ILQRConfig, flatten_env_dynamics, make_ilqr

    env = CursorEnv(EnvConfig(sim=SimConfig(solver_iters=8, use_pallas=backend)), device=dev)
    counter = lane_solver if backend == "lane" else env.physics
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = env.reset_batch(1, gen)
    cursor = s.cursor_pos.clone()
    cursor[:, 0] = s.parts.pos[:, 0]
    s = s._replace(cursor_pos=cursor,
                   selected=torch.tensor([[0, -1]], dtype=torch.int32, device=dev))
    f, x0, unravel = flatten_env_dynamics(env, s, substeps=ILQR_SUBSTEPS)
    target = unravel(x0)["pos"][0] + torch.tensor([0.12, 0.1, 0.08], device=dev)

    def running_cost(x, u, t):
        return (10.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1)
                + 0.05 * torch.sum(u**2, -1))

    def terminal_cost(x):
        return 100.0 * torch.sum((unravel(x)["pos"][:, 0] - target) ** 2, -1)

    cfg = ILQRConfig(**{**ILQR, "iterations": iterations})
    plan = make_ilqr(f, running_cost, terminal_cost, cfg)
    u = torch.zeros((cfg.horizon, env.dof), device=dev)
    counter.launches = 0
    (_, info0), warm_s = _timed(lambda: plan(x0, u))
    out = {"warm_up_s": warm_s, "warm_up_launches": counter.launches,
           "solve_s": [], "launches": [], "cost": [], "cost0": [],
           "history": [], "finite": True, "cold_cost": info0["cost"].item(),
           "cold_cost0": info0["cost0"].item()}
    for i in range(solves):
        counter.launches = 0
        xi = x0 + 1e-4 * (i + 1)
        (u, info), sec = _timed(lambda: plan(xi, u))
        out["launches"].append(counter.launches)
        out["solve_s"].append(sec)
        out["cost"].append(info["cost"].item())
        out["cost0"].append(info["cost0"].item())
        out["history"].append(info["history"].tolist())
        out["finite"] &= bool(torch.isfinite(u).all())
    # the last solve's plan rolled out: the held part against its target
    x = x0[None]
    with torch.no_grad():
        for ut in u:
            x = f(x, ut[None])
    out["distance_m"] = [torch.linalg.norm(unravel(x0)["pos"][0] - target).item(),
                         torch.linalg.norm(unravel(x)["pos"][0, 0] - target).item()]
    # one iteration's steps, timed apart
    (xs, _), out["initial_rollout_ms"] = _timed(lambda: plan.initial_rollout(x0, u))
    exp, out["linearize_ms"] = _timed(lambda: plan.linearize(xs, u))
    reg = torch.full((), cfg.reg_init, device=dev)
    (ks, Ks, _), out["backward_ms"] = _timed(lambda: plan.backward(*exp, reg))
    _, out["line_search_ms"] = _timed(lambda: plan.line_search(x0, xs, u, ks, Ks))
    for k in ("initial_rollout_ms", "linearize_ms", "backward_ms", "line_search_ms"):
        out[k] *= 1e3
    # the same two rollouts again, with the physics inputs recorded
    calls = []

    def record(parts, group, gscale, n):
        own = lambda t: t.clone(memory_format=torch.contiguous_format)
        calls.append((PartState(*map(own, parts)), own(group), own(gscale), n))
        return CursorEnv._physics(env, parts, group, gscale, n)

    env._physics = record
    try:
        plan.initial_rollout(x0, u)
        plan.line_search(x0, xs, u, ks, Ks)
    finally:
        del env._physics
    H = cfg.horizon
    if len(calls) != 2 * H:
        fail(f"iLQR: {len(calls)} physics calls in an initial rollout and a line search, not {2 * H}")
    recorded = [calls[o + t] for o in (0, H) for t in (0, H // 2, H - 1)]
    out["n"], out["m"], out["horizon"] = x0.shape[0], env.dof, cfg.horizon
    out["iterations"], out["alphas"] = cfg.iterations, len(cfg.alphas)
    return out, env, recorded


def drive_render(dev):
    """The renderer on the card: ``make_render_fn``'s chunked frames against
    the generic path for the cursor (table_lack) and Sawyer at
    ``RENDER_CHECK``; then ``RENDER_RUNS``, each a rollout of random actions
    (``step_batch``, then a render of every env) over ``RENDER_HORIZON``
    steps, ``RENDER_ROUNDS`` rounds, the step and the render timed apart
    with CUDA events and the peak memory read. Each rollout's kernel
    launches are counted from 0 on its env; after the rounds one more step
    and render run with their physics inputs recorded (``recorded``, and
    the envs in ``envs``) for main to hold the kernels on."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.render import SEG_BACKGROUND, frontview, make_render_fn, render

    envs = {"cursor": CursorEnv(EnvConfig(furniture_name="table_lack_0825"), device=dev),
            "sawyer": ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device=dev)}
    gen = torch.Generator(device=dev)
    out = {"check": {}, "runs": {}, "envs": envs}
    nb, side = RENDER_CHECK
    for name, env in envs.items():
        gen.manual_seed(0)
        st = env.reset_batch(nb, gen)
        st = env.step_batch(st, torch.rand((nb, env.dof), generator=gen, device=dev) * 2 - 1)[0]
        cam = frontview(side, side)
        rf = make_render_fn(env, cam)
        rgb, depth, seg = rf(st)
        rgb_g, depth_g, seg_g = render(rf.scene(st), cam)
        hit = seg != SEG_BACKGROUND
        out["check"][name] = {
            "seg_equal": torch.equal(seg, seg_g),
            "rgb_max_abs_err": (rgb - rgb_g).abs().max().item(),
            "depth_finite_on_hits": bool(torch.isfinite(depth[hit]).all()),
            "depth_inf_elsewhere": bool(torch.isinf(depth[~hit]).all()),
            "ids": torch.unique(seg).tolist(),
        }
    for name, nb, side in RENDER_RUNS:
        env = envs["sawyer" if name.startswith("sawyer") else "cursor"]
        rf = make_render_fn(env, frontview(side, side))
        gen.manual_seed(1)
        st = env.reset_batch(nb, gen)
        rgb = rf(env.step_batch(st, torch.rand((nb, env.dof), generator=gen, device=dev) * 2 - 1)[0])[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        phys = env.physics
        phys.launches = 0
        if hasattr(phys, "free"):
            phys.free.launches = 0
        rounds = []
        for _ in range(RENDER_ROUNDS):
            marks = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RENDER_HORIZON):
                a = torch.rand((nb, env.dof), generator=gen, device=dev) * 2 - 1
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                st = env.step_batch(st, a)[0]
                ev[1].record()
                rgb, depth, seg = rf(st)
                ev[2].record()
                marks.append(ev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rounds.append({"s": wall,
                           "step_ms": sum(e[0].elapsed_time(e[1]) for e in marks) / RENDER_HORIZON,
                           "render_ms": sum(e[1].elapsed_time(e[2]) for e in marks) / RENDER_HORIZON})
        out["runs"][name] = {
            "batch": nb, "side": side, "rounds": rounds,
            "peak_bytes": torch.cuda.max_memory_allocated(), "held_bytes": held,
            "launches": phys.launches,
            "free_launches": phys.free.launches if hasattr(phys, "free") else None,
            "finite": bool(torch.isfinite(rgb).all()), "rgb_shape": list(rgb.shape),
        }
        with recording(env, keep=2) as calls:
            st = env.step_batch(st, torch.rand((nb, env.dof), generator=gen, device=dev) * 2 - 1)[0]
            rf(st)
        out["runs"][name]["recorded"] = list(calls)
    return out


def drive_wrapper(dev):
    """``make_env`` with all three camera observations at ``WRAPPER_SIDE``
    on the card, the cursor and Sawyer: reset, ``WRAPPER_STEPS`` steps, the
    three render modes and a bad one; each env's kernel launches from 0,
    the physics inputs of the last step recorded (``recorded``, the env in
    ``env``)."""
    import numpy as np

    from furniture_tpu_torch.api import make_env

    out = {}
    for name in ("IKEACursor-v0", "IKEASawyer-v0"):
        w = make_env(name, camera_ob=True, depth_ob=True, segmentation_ob=True,
                     screen_width=WRAPPER_SIDE, screen_height=WRAPPER_SIDE)
        phys = w.env.physics
        phys.launches = 0
        if hasattr(phys, "free"):
            phys.free.launches = 0
        t0 = time.perf_counter()
        ob = w.reset(seed=0)
        rng = np.random.RandomState(0)
        for _ in range(WRAPPER_STEPS - 1):
            ob, rew, done, info = w.step(w.action_space.sample(rng))
        with recording(w.env, keep=8) as calls:
            ob, rew, done, info = w.step(w.action_space.sample(rng))
        sec = time.perf_counter() - t0
        modes = [w.render(m) for m in ("rgb_array", "depth_array", "segmentation")]
        try:
            w.render("no_such_mode")
            bad_mode_raises = False
        except ValueError:
            bad_mode_raises = True
        side = (WRAPPER_SIDE, WRAPPER_SIDE)
        cfg = w.env.config
        out[name] = {
            "env": w.env, "recorded": list(calls),
            "device": str(w.device), "s": sec, "launches": phys.launches,
            "control_type": getattr(cfg, "control_type", None),
            "per_step": cfg.action_repeat if hasattr(phys, "free") and cfg.control_type == "ik" else 1,
            "free_launches": phys.free.launches if hasattr(phys, "free") else None,
            "shapes_ok": (ob["camera_ob"].shape == side + (3,) and ob["depth_ob"].shape == side
                          and ob["segmentation_ob"].shape == side),
            "modes_match_obs": (np.array_equal(modes[0], ob["camera_ob"])
                                and np.array_equal(modes[1], ob["depth_ob"])
                                and np.array_equal(modes[2], ob["segmentation_ob"])),
            "bad_mode_raises": bad_mode_raises, "reward_finite": bool(np.isfinite(rew)),
        }
    return out


def _mesh_plan_inputs(dev):
    """The MPPI problem both mesh runs plan on: the bench configuration's
    env, one reset state, the zero mean and one draw of noise."""
    import torch

    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.planning import MPPIConfig

    cfg = MPPIConfig(horizon=64, n_samples=256, sigma=0.3)
    env = CursorEnv(EnvConfig(sim=SimConfig(timestep=0.02, solver_iters=8)), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.reset_batch(1, gen)
    gen.manual_seed(7)
    noise = torch.randn((cfg.n_samples, cfg.horizon, env.dof), generator=gen, device=dev) * cfg.sigma
    return env, cfg, state, torch.zeros((cfg.horizon, env.dof), device=dev), noise


def _mesh_rank(rank: int, init_method: str, out_dir: str, device: str) -> None:
    """One of ``MESH_WORLD`` ranks on the one card (gloo over CUDA
    tensors): the sharded MPPI plan against ``make_mppi`` on the same
    noise, then one sharded PPO iteration at ``PPOConfig()`` whose networks
    must be identical on every rank (a MIN and a MAX all-reduce of them);
    then one more sharded plan and one more PPO rollout with the physics
    inputs of their last step recorded. Writes ``rank<r>.json`` and those
    inputs, ``inputs<r>.pt``, to ``out_dir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from furniture_tpu_torch import rl
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.parallel import make_mesh, mpi_min
    from furniture_tpu_torch.planning import make_mppi, make_sharded_mppi

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=MESH_WORLD)
    try:
        mesh = make_mesh(MESH_WORLD, backend="gloo", device=dev)
        env, cfg, state, mean, noise = _mesh_plan_inputs(dev)
        env.physics.launches = 0
        (smean, sinfo), plan_s = _timed(lambda: make_sharded_mppi(env, cfg, mesh)(
            state, mean, None, noise=noise))
        plan_launches = env.physics.launches
        pmean, pinfo = make_mppi(env, cfg)(state, mean, None, noise=noise)
        penv = CursorEnv(EnvConfig(), device=dev)
        init, train = rl.make_ppo(penv, rl.PPOConfig(), mesh=mesh)
        st = init(0)
        penv.physics.launches = 0
        (st, m), ppo_s = _timed(lambda: train(st))
        ppo_launches = penv.physics.launches
        flat = torch.cat([p.detach().reshape(-1) for p in st.params.parameters()])
        out = {
            "rank": mesh.rank, "device": str(mesh.device),
            "plan_s": plan_s, "plan_launches": plan_launches,
            "plan_err": (smean - pmean).abs().max().item(),
            "best_cost": sinfo["best_cost"].item(), "plain_best_cost": pinfo["best_cost"].item(),
            "ppo_s": ppo_s, "ppo_launches": ppo_launches, "ppo_lanes": st.env_states.group.shape[0],
            "ppo_loss": float(m["loss"]), "ppo_reward_per_step": float(m["reward_per_step"]),
            "params_identical": (torch.equal(mpi_min(mesh, flat), flat)
                                 and torch.equal(-mpi_min(mesh, -flat), flat)),
            "params_sum": flat.double().sum().item(),
        }
        with recording(env, keep=2) as mppi_calls:
            make_sharded_mppi(env, cfg, mesh)(state, mean, None, noise=noise)
        with recording(penv, keep=2) as ppo_calls:
            train.rollout(st.params, st.env_states, st.generator)
        torch.save({"mppi": [flat_call(c) for c in mppi_calls], "ppo": [flat_call(c) for c in ppo_calls]},
                   os.path.join(out_dir, f"inputs{rank}.pt"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def drive_mesh(dev):
    """World size 1 on nccl in this process: the sharded MPPI plan against
    ``make_mppi`` on the same noise, timed in turns (plain, sharded,
    sharded, plain); then ``MESH_WORLD`` ranks spawned on the one card
    (``_mesh_rank``), which must all finish within ``MESH_TIMEOUT_S``.
    ``recorded`` holds the physics inputs of the last step of one more
    world-size-1 plan (``"ws1"``), and of rank 0's sharded plan and PPO
    rollout (``"ws2_mppi"``, ``"ws2_ppo"``); ``env`` is the plan's env."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from furniture_tpu_torch.parallel import make_mesh
    from furniture_tpu_torch.planning import make_mppi, make_sharded_mppi

    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, device=dev)
        env, cfg, state, mean, noise = _mesh_plan_inputs(dev)
        splan, plan = make_sharded_mppi(env, cfg, mesh), make_mppi(env, cfg)
        splan(state, mean, None, noise=noise)                      # warm-up
        env.physics.launches = 0
        (smean, sinfo), s1 = _timed(lambda: splan(state, mean, None, noise=noise))
        out["ws1_launches"] = env.physics.launches
        (pmean, pinfo), p0 = _timed(lambda: plan(state, mean, None, noise=noise))
        _, s2 = _timed(lambda: splan(state, mean, None, noise=noise))
        _, p1 = _timed(lambda: plan(state, mean, None, noise=noise))
        out["ws1"] = {"backend": dist.get_backend(), "err": (smean - pmean).abs().max().item(),
                      "best_cost": sinfo["best_cost"].item(),
                      "plain_best_cost": pinfo["best_cost"].item(),
                      "sharded_s": [s1, s2], "plain_s": [p0, p1]}
        with recording(env, keep=2) as calls:
            splan(state, mean, None, noise=noise)
        out["env"], out["recorded"] = env, {"ws1": list(calls)}
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.spawn(_mesh_rank, args=(f"tcp://localhost:{_free_port()}", tmp, str(mesh.device)),
                       nprocs=MESH_WORLD, join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    fail(f"the {MESH_WORLD} mesh ranks did not finish within {MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        out["ws2_s"] = time.perf_counter() - t0
        out["ws2"] = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(MESH_WORLD)]
        rank0 = torch.load(os.path.join(tmp, "inputs0.pt"), map_location=dev)
        out["recorded"]["ws2_mppi"] = [unflat_call(c) for c in rank0["mppi"]]
        out["recorded"]["ws2_ppo"] = [unflat_call(c) for c in rank0["ppo"]]
    return out


def drive_arm_dynamics(dev):
    """The arm form of the iLQR dynamics (Sawyer impedance, default
    ``SimConfig``), from a reset with the parts in motion: the forward
    (the arm kernel on the card) against the plain version over the n rows
    of a Jacobian batch; then the Jacobian through the autograd.Function
    (kernel forward, plain backward) against central differences of the
    kernel forward along ``ARM_FD_DIRS`` random directions in (x, u), as
    the gap max |J d - fd(d)| / max |J d|, beside the same gap of the
    plain forward's central differences, at the step of ``ARM_FD_EPS``
    where the latter is least."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.planning import flatten_env_dynamics

    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f, x0, unravel = flatten_env_dynamics(env, env.reset_batch(1, gen), substeps=ARM_JAC_SUBSTEPS)
    # at zero angular velocity the integrator's axis w/|w| has a 1e9
    # derivative, which would swamp every other entry
    for name in ("lin_vel", "ang_vel"):
        v = unravel(x0)[name]
        v.copy_(torch.linspace(-0.5, 0.5, v.numel(), device=dev).reshape(v.shape))
    # the fingers rest at their open limit, where the joint clamp makes the
    # step jump: joints within 5 mm (rad) of a limit go to mid-range
    q = unravel(x0)["qpos"]
    lim = torch.as_tensor(env.robot.jnt_range, dtype=q.dtype, device=dev)
    near = ((q - lim[:, 0]) < 5e-3) | ((lim[:, 1] - q) < 5e-3)
    q.copy_(torch.where(near, lim.mean(-1), q))
    n, m = x0.shape[0], env.dof
    u0 = torch.linspace(-0.5, 0.5, m, device=dev)
    eye = torch.eye(n, device=dev)
    env.physics.launches = 0
    X = x0[None].repeat(n, 1).requires_grad_(True)
    U = u0[None].repeat(n, 1).requires_grad_(True)
    y = f(X, U)
    Jx, Ju = torch.autograd.grad(y, (X, U), eye)
    launches = env.physics.launches
    with torch.no_grad():
        yp = f.f_grad(X, U)
        gen.manual_seed(5)
        D = ARM_FD_DIRS
        dx = torch.rand((D, n), generator=gen, device=dev) * 2 - 1
        du = torch.rand((D, m), generator=gen, device=dev) * 2 - 1
        jd = dx @ Jx.T + du @ Ju.T

        def gap(fn, eps):
            ys = fn(torch.cat([x0 + eps * dx, x0 - eps * dx]), torch.cat([u0 + eps * du, u0 - eps * du]))
            return ((ys[:D] - ys[D:]) / (2 * eps) - jd).abs().max().item() / jd.abs().max().item()

        # the step is smooth only between contact onsets: the eps at which
        # the plain forward's own differences come closest to J d
        plain_gaps = {eps: gap(f.f_grad, eps) for eps in ARM_FD_EPS}
        eps = min(plain_gaps, key=plain_gaps.get)
        kernel_gap = gap(f, eps)
    return {"launches": launches, "rows": n, "substeps": ARM_JAC_SUBSTEPS,
            "forward_max_abs_err": (y - yp).abs().max().item(), "fd_eps": eps,
            "fd_gap": kernel_gap, "fd_gap_plain": plain_gaps[eps], "fd_gaps_plain": plain_gaps,
            "jd_max_abs": jd.abs().max().item(), "jacobian_max_abs": Jx.abs().max().item(),
            "finite": bool(torch.isfinite(Jx).all() and torch.isfinite(Ju).all())}


def drive_rl(dev):
    """The RL stack on the cursor (table_lack, default ``SimConfig``):
    PPO, SAC, one GAIL iteration, BC on the committed demos, the
    evaluation, a checkpoint round trip of the card's state and the
    entry point ``train_rl``. Returns a dict of what it measured; each
    phase's free-part kernel launches are read from the env it drove,
    their counts set to 0 just before."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from furniture_tpu_torch import rl
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.rl.ppo import gae
    from furniture_tpu_torch.tools import train_rl
    from furniture_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    from furniture_tpu_torch.utils.demo import load_demo

    env = CursorEnv(EnvConfig(), device=dev)
    phys = env.physics
    out = {}
    finite = lambda m: all(np.isfinite(float(v)) for v in m.values())

    # PPO
    pcfg = rl.PPOConfig()
    phys.launches = 0
    init, train = rl.make_ppo(env, pcfg)
    st = init(0)
    out["ppo_setup_launches"] = phys.launches
    its = []
    for _ in range(PPO_ITERS):
        phys.launches = 0
        (st, m), sec = _timed(lambda: train(st))
        its.append({"s": sec, "launches": phys.launches, "done_frac": float(m["done_frac"]),
                    "loss": float(m["loss"]), "reward_per_step": float(m["reward_per_step"]),
                    "finite": finite(m)})
    out["ppo_iters"] = its
    out["ppo_env_steps"] = pcfg.num_envs * pcfg.rollout_len
    (env_states, traj, last_value), roll_s = _timed(
        lambda: train.rollout(st.params, st.env_states, st.generator))
    adv, ret = gae(traj, last_value, pcfg.gamma, pcfg.lam)
    _, upd_s = _timed(lambda: train.update(st.params, st.opt_state, traj, adv, ret,
                                                st.generator))
    out["ppo_rollout_ms"], out["ppo_update_ms"] = roll_s * 1e3, upd_s * 1e3

    # the checkpoint of the card's state, back into a fresh state
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, st, st.step)
        back = load_checkpoint(latest_checkpoint(tmp), init(7))
    same = (back.step == st.step
            and all(torch.equal(a, b) for a, b in zip(st.params.state_dict().values(),
                                                       back.params.state_dict().values()))
            and torch.equal(st.generator.get_state(), back.generator.get_state())
            and all(torch.equal(a, b) for a, b in zip(
                [t for t in st.env_states if isinstance(t, torch.Tensor)] + list(st.env_states.parts),
                [t for t in back.env_states if isinstance(t, torch.Tensor)] + list(back.env_states.parts))))
    sa, sb = st.opt_state.state_dict()["state"], back.opt_state.state_dict()["state"]
    same = same and all(sa[k]["count"] == sb[k]["count"] and torch.equal(sa[k]["mu"], sb[k]["mu"])
                        and torch.equal(sa[k]["nu"], sb[k]["nu"]) for k in sa)
    out["checkpoint_bit_exact"] = bool(same)
    out["checkpoint_on"] = str(back.env_states.parts.pos.device)

    # SAC
    scfg = rl.SACConfig()
    phys.launches = 0
    sinit, strain = rl.make_sac(env, scfg)
    sst = sinit(1)
    out["sac_setup_launches"] = phys.launches
    phys.launches = 0
    warm_ms, upd_ms, sm = [], [], None
    for _ in range(SAC_ITERS):
        warm = sst.step * scfg.num_envs < scfg.warmup
        (sst, sm), sec = _timed(lambda: strain(sst))
        (warm_ms if warm else upd_ms).append(sec * 1e3)
    out["sac"] = {"launches": phys.launches, "iters": SAC_ITERS, "warm_up_iters": len(warm_ms),
                  "warm_up_ms_median": float(np.median(warm_ms)) if warm_ms else None,
                  "update_iter_ms_median": float(np.median(upd_ms)) if upd_ms else None,
                  "buffer_size": sst.buffer.size, "q_loss": float(sm["q_loss"]),
                  "alpha": float(sm["alpha"]), "finite": finite(sm)}

    # GAIL: expert arrays of the cursor's widths, from the seed
    rng = np.random.default_rng(0)
    obs_d, act_d = rl.obs_dim(env.observe(st.env_states)), env.dof
    e_obs = rng.standard_normal((1024, obs_d)).astype(np.float32)
    e_act = rng.uniform(-1, 1, (1024, act_d)).astype(np.float32)
    g_init, disc_reward, disc_update, g_make_ppo = rl.make_gail(env, pcfg, rl.GAILConfig(),
                                                                e_obs, e_act)
    ds, policy_seed = g_init(2)
    ginit, gtrain = g_make_ppo(env, pcfg, reward_fn=lambda o, a, r: disc_reward(ds.params)(o, a, r))
    gst = ginit(policy_seed)
    phys.launches = 0

    def gail_iteration(gst=gst):
        obs = rl.flatten_obs(env.observe(gst.env_states))
        with torch.no_grad():
            acts = gst.params["pi"].sample(obs, gst.generator)[0]
        _, dm = disc_update(ds, obs, acts)
        gst, gm = gtrain(gst)
        return {**dm, **gm}

    gm, gail_s = _timed(gail_iteration)
    out["gail"] = {"s": gail_s, "launches": phys.launches, "disc_acc": float(gm["disc_acc"]),
                   "reward_per_step": float(gm["reward_per_step"]), "finite": finite(gm)}

    # BC on the committed demos
    files = sorted(glob.glob(os.path.join(HERE, "demos", "generated", "*.pkl")))
    X, Y = rl.demos_to_dataset([load_demo(fn) for fn in files])
    binit, bfit, bpredict = rl.make_bc(X.shape[-1], Y.shape[-1], rl.BCConfig(lr=3e-4), device=dev)
    Xd, Yd = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    bst = binit(0)
    mses, bc_s = [], []
    for _ in range(BC_EPOCHS):
        (bst, bm), sec = _timed(lambda: bfit(bst, Xd, Yd))
        mses.append(float(bm["mse"]))
        bc_s.append(sec)
    out["bc"] = {"demos": len(files), "samples": int(X.shape[0]), "mse": mses, "epoch_s": bc_s,
                 "pred_shape": list(bpredict(bst.params, Xd[:64]).shape)}

    # the evaluation
    egen = torch.Generator(device=dev)
    egen.manual_seed(3)
    evaluate = rl.make_evaluate(env, rl.ppo_act, EVAL_EPISODES, EVAL_STEPS)
    phys.launches = 0
    em, eval_s = _timed(lambda: evaluate(st.params, egen))
    out["eval"] = {"s": eval_s, "launches": phys.launches, **{k: float(v) for k, v in em.items()}}

    # the entry point: a fresh env inside, its launches counted from 0
    with tempfile.TemporaryDirectory() as tmp:
        args = train_rl.parse_args(["--algo", "ppo", "--iters", str(TRAIN_RL_ITERS),
                                    "--run_dir", tmp])
        (result, tenv), tr_s = _timed(lambda: train_rl.train(args))
        lines = [json.loads(l) for l in open(os.path.join(tmp, "metrics.jsonl"))]
        on_disk = json.load(open(os.path.join(tmp, "result.json")))
    out["train_rl"] = {"s": tr_s, "launches": tenv.physics.launches, "result": on_disk,
                       "metric_lines": [l["iter"] for l in lines],
                       "num_envs": args.num_envs, "rollout_len": args.rollout_len,
                       "eval_episodes": args.eval_episodes, "eval_max_steps": args.eval_max_steps}
    return out


def live_state_problem(env, state) -> str | None:
    """``tests/test_all_furniture_runtime.py``'s ``_assert_live_state`` on
    every env of a batch: what is wrong, or None."""
    import torch

    parts = state.parts
    for f in ("pos", "quat", "lin_vel"):
        if not torch.isfinite(getattr(parts, f)).all():
            return f"{f} not finite"
    if (torch.linalg.norm(parts.quat, dim=-1) - 1.0).abs().max().item() > 1e-3:
        return "quaternions not unit"
    zmin = parts.pos[..., 2].min().item()
    if not zmin > -float(env.model.geom_size.max()) - 0.02:
        return f"a part center sank below the floor (z={zmin:.3f})"
    return None


def env_max(x, y):
    """max |x - y| in each env over the tensors of two sequences: [B]."""
    import torch

    B = x[0].shape[0]
    return torch.stack([(u - v.to(u.device)).abs().reshape(B, -1).amax(-1) for u, v in zip(x, y)]).amax(0)


def pose_noise(parts, mag: float, seed: int):
    """``parts`` with uniform noise of ``mag`` on the positions and the
    quaternions (renormalised), drawn from ``seed``."""
    import torch

    dev = parts.pos.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    eps = (torch.rand(parts.pos.shape, generator=g, device=dev) - 0.5) * 2 * mag
    q = parts.quat + (torch.rand(parts.quat.shape, generator=g, device=dev) - 0.5) * 2 * mag
    return parts._replace(pos=parts.pos + eps, quat=q / torch.linalg.norm(q, dim=-1, keepdim=True))


def contact_ties(phys, parts, group, gscale, n: int):
    """[B] bool: the envs where, in some substep of the plain run, a lane's
    depth lies within 4 float32 ulp (of the largest coordinate of the env's
    parts) of the contact threshold ``-slop``, over the floor lanes and every
    lane whose geometric mask is set. Whether such a lane acts is decided by
    rounding, which no noise on the poses moves when the floor projection
    pins the lane there (a plate whose half thickness equals the slop,
    lifted onto its deepest corner each substep)."""
    import torch

    sub, slop = phys._plain, phys.cfg.contact_slop
    B, dev = parts.pos.shape[0], parts.pos.device
    lam = torch.zeros((B, sub.n_base_lanes, 3), device=dev)
    margin = torch.full((B,), float("inf"), device=dev)
    st = parts
    for _ in range(n):
        c = sub.solver_args(st, group, gscale)[1][0]
        held = c.mask | (torch.arange(c.depth.shape[1], device=dev) < phys.Kf)
        gap = torch.where(held, (c.depth + slop).abs(), torch.full_like(c.depth, float("inf")))
        margin = torch.minimum(margin, gap.amin(-1))
        st, lam = sub(st, group, gscale, lam)
    return margin < 4 * torch.finfo(torch.float32).eps * parts.pos.abs().reshape(B, -1).amax(-1)


def hold_free(phys, parts, group, gscale, n: int, tol: float, chaotic: bool = False) -> dict:
    """The free-part kernel against its plain version after ``n`` substeps,
    env by env. Each env is held to ``tol`` or to 10x the plain version's own
    spread in that env, the larger: the largest change of the plain result
    under ``NOISE_DRAWS`` draws each of 1e-7 and 1e-6 of pose noise and, in
    an env with a lane on the contact threshold (``contact_ties``), under
    the threshold moved by 8 ulp either way, which decides that lane each
    way. The median over the envs is held to ``tol``, and at most a tenth of
    them may exceed it; with ``chaotic`` these two limits count only the
    envs whose own spread is within ``tol`` (in the others the plain version
    itself is chaotic at that bound). The spread is measured only where an
    env exceeds ``tol``: otherwise every limit holds whatever it is. The
    outputs must be finite and two launches bit-identical. These launches
    are measurements, not the path's. Returns the numbers and ``problem``,
    the first limit broken, or None."""
    import dataclasses

    import torch

    from furniture_tpu_torch.physics import engine
    from furniture_tpu_torch.physics.state import PartState

    parts = PartState(*(t.contiguous() for t in parts))
    group, gscale = group.contiguous(), gscale.contiguous()
    B = parts.pos.shape[0]
    ref = phys.plain_substeps(parts, group, gscale, n)
    out = phys.kernel_substeps(parts, group, gscale, n)
    again = phys.kernel_substeps(parts, group, gscale, n)
    torch.cuda.synchronize()
    env_err = env_max(ref, out)
    spread, ties = None, torch.zeros_like(env_err, dtype=torch.bool)
    bound = torch.full_like(env_err, tol)
    if bool((env_err > tol).any()):
        spread = torch.zeros_like(env_err)
        for mag in (1e-7, 1e-6):
            for seed in range(NOISE_DRAWS):
                spread = torch.maximum(spread, env_max(ref, phys.plain_substeps(
                    pose_noise(parts, mag, 100 + seed), group, gscale, n)))
        ties = contact_ties(phys, parts, group, gscale, n)
        if bool(ties.any()):
            slop = phys.cfg.contact_slop
            d = 8 * torch.finfo(torch.float32).eps * parts.pos.abs().max().item()
            for s in (slop - d, slop + d):
                moved = engine.make_substep(phys.model_np, dataclasses.replace(
                    phys.cfg, contact_slop=s, use_pallas="off"), phys.device)
                spread = torch.where(ties, torch.maximum(spread, env_max(
                    ref, engine.substeps(moved, parts, group, gscale, n))), spread)
        bound = torch.clamp(10 * spread, min=tol)
    counted = spread <= tol if chaotic and spread is not None else torch.ones_like(ties)
    med = env_err[counted].median().item() if bool(counted.any()) else 0.0
    over = int((env_err[counted] > tol).sum())
    i = int(torch.argmax(env_err / bound))
    h = {"n": n, "tol": tol, "err": env_err.max().item(), "median": med, "envs_over": over,
         "envs_counted": int(counted.sum()), "env": i, "env_err": env_err[i].item(),
         "env_spread": None if spread is None else spread[i].item(), "bound": bound[i].item(),
         "bound_max": bound.max().item(), "spread": None if spread is None else spread.max().item(),
         "tie_envs": int(ties.sum()), "chaotic_envs": B - int(counted.sum()),
         "per": {f: round(max_err([a], [b]), 9) for f, a, b in zip(PartState._fields, ref, out)},
         "problem": None}
    if not all(bool(torch.isfinite(t).all()) for t in out):
        h["problem"] = "kernel output not finite"
    elif not same_bits(out, again):
        h["problem"] = "two launches on one input differ"
    elif not med <= tol:
        h["problem"] = f"median error {med} > {tol}"
    elif over > B // 10:
        h["problem"] = f"{over} envs over {tol}"
    elif not bool((env_err <= bound).all()):
        h["problem"] = (f"env {i} disagrees by {env_err[i].item()}, over {tol} and over 10x the plain "
                        f"version's own spread there ({h['env_spread']})")
    return h


def free_note(h: dict) -> str:
    """``hold_free``'s numbers for a ``[check]`` line."""
    B = h["envs_counted"] + h["chaotic_envs"]
    if h["spread"] is None:
        return f"bound {h['tol']:.3g} in every env, median {h['median']:.3g}"
    return (f"bound per env {h['tol']:.3g} or 10x its own spread, at most {h['bound_max']:.3g}; median "
            f"{h['median']:.3g}, {h['envs_over']} over {h['tol']:.3g}, of the {h['envs_counted']} of {B} envs "
            f"where the plain version's own spread is within the bound" if h["chaotic_envs"] else
            f"bound per env {h['tol']:.3g} or 10x its own spread, at most {h['bound_max']:.3g}; median "
            f"{h['median']:.3g} (bound {h['tol']:.3g}), {h['envs_over']} of {B} envs over {h['tol']:.3g}") + (
        f"; the plain version's own spread, the largest in an env: {h['spread']:.3g} under {NOISE_DRAWS} "
        f"draws each of 1e-7 and 1e-6 of pose noise"
        + (f" and, in the {h['tie_envs']} envs with a lane on the contact threshold, that threshold moved "
           f"8 ulp either way" if h["tie_envs"] else "")
        + f"; the env nearest its bound, {h['env']}: {h['env_err']:.3g} against its own spread "
        f"{h['env_spread']:.3g}")


ARM_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "qpos", "qvel")


def arm_per_env(a, b):
    """max |a - b| per env and field of two arm results: {field: [B]}."""
    B = a[1].shape[0]
    pairs = list(zip(a[0], b[0])) + [(a[1], b[1]), (a[2], b[2])]
    return {f: (x - y).abs().reshape(B, -1).amax(-1) for f, (x, y) in zip(ARM_FIELDS, pairs)}


def hold_arm_call(ph, args, n: int, tol: float, pinched: bool) -> dict:
    """The arm kernel against its plain version after ``n`` substeps from
    ``args``, the inputs of one ``control_step`` call but its ``n``. The
    outputs must be finite, two launches bit-identical and the touch flags
    equal. Plain, the maximum is held to ``tol``. A ``pinched`` case is
    ill-conditioned in a few envs: its median over the envs is held to
    ``tol``, at most a tenth of the envs may exceed it, and its maximum is
    held to 10x the plain version's own spread under three draws each of
    1e-7 and 1e-6 of position noise, measured only where an env exceeds
    ``tol``. Returns the numbers and ``problem``, the first limit broken,
    or None."""
    import torch

    args = tuple(args) + (n,)
    B = args[3].shape[0]
    ref = ph.plain_control_step(*args)
    out = ph.kernel_control_step(*args)
    again = ph.kernel_control_step(*args)
    torch.cuda.synchronize()
    errs = arm_per_env(ref, out)
    env_err = torch.stack(list(errs.values())).amax(0)
    err = env_err.max().item()
    med = max(v.median().item() for v in errs.values())
    h = {"n": n, "tol": tol, "B": B, "pinched": pinched, "err": err, "median": med,
         "envs_over": int((env_err > tol).sum()), "spreads": None, "bound": tol,
         "n_touch": int(out[3].sum()), "per": {f: round(v.max().item(), 9) for f, v in errs.items()},
         "problem": None}
    if pinched and err > tol:
        # one substep of summing ~1000 lanes in another order already
        # moves the velocities by up to 7e-5, which 1e-7 of position noise
        # does not always reproduce: hence also 1e-6
        spreads = {}
        for mag in (1e-7, 1e-6):
            worst = 0.0
            for seed in (7, 8, 9):
                g = torch.Generator(device=args[0].pos.device)
                g.manual_seed(seed)
                eps = (torch.rand(args[0].pos.shape, generator=g, device=g.device) - 0.5) * 2 * mag
                ref2 = ph.plain_control_step(args[0]._replace(pos=args[0].pos + eps), *args[1:])
                worst = max(worst, max(v.max().item() for v in arm_per_env(ref, ref2).values()))
            spreads[mag] = worst
        h["spreads"] = spreads
        h["bound"] = max(tol, 10 * max(spreads.values()))
    if not all(bool(torch.isfinite(t).all()) for t in list(out[0]) + [out[1], out[2]]):
        h["problem"] = "arm kernel output not finite"
    elif not same_bits(list(out[0]) + list(out[1:]), list(again[0]) + list(again[1:])):
        h["problem"] = "two launches of the arm kernel on one input differ"
    elif not torch.equal(ref[3], out[3]):
        h["problem"] = "touch flags differ between arm kernel and plain version"
    elif pinched and not med <= tol:
        h["problem"] = f"median error {med} > {tol}"
    elif pinched and h["envs_over"] > B // 10:
        h["problem"] = f"{h['envs_over']} envs over {tol}"
    elif not err <= h["bound"]:
        h["problem"] = f"arm kernel disagrees with its plain version ({err} > {h['bound']})"
    return h


def arm_note(h: dict) -> str:
    """``hold_arm_call``'s numbers for a ``[check]`` line."""
    note = f"bound {h['bound']:.3g}"
    if h["pinched"]:
        note += (f", median over envs {h['median']:.3g} (bound {h['tol']:.3g}), {h['envs_over']} of {h['B']} "
                 f"envs over {h['tol']:.3g}")
        if h["spreads"]:
            note += (f", plain vs plain(pos + noise) {h['spreads'][1e-7]:.3g} at 1e-7 and "
                     f"{h['spreads'][1e-6]:.3g} at 1e-6")
    return note + f", touch flags equal, {h['n_touch']} set"


def recorded_checks(call):
    """The (n, tol) checks of one recorded physics call at phase 2's bounds:
    after 5 substeps (n where n <= 5) and after the call's own n."""
    n, arm = call[-1], len(call) == 10
    short, full = (5e-4, 1e-3) if arm else (1e-4, 1e-3)
    return ((n, short),) if n <= 5 else ((5, short), (n, full))


def hold_call(phys, call) -> list:
    """The kernel of a recorded call against its plain version at
    ``recorded_checks``: kernel 2 for an arm call (``hold_arm_call``, pinched),
    kernel 1 for a free-part call (``hold_free``). A list of results."""
    if len(call) == 10:
        return [hold_arm_call(phys, call[:-1], n, tol, True) for n, tol in recorded_checks(call)]
    return [hold_free(phys, *call[:3], n, tol) for n, tol in recorded_checks(call)]


def hold_line(tag: str, h: dict) -> str:
    """A ``[check]`` line for one result of ``hold_call``."""
    arm = "n_touch" in h
    return (f"[check] {'arm ' if arm else ''}{tag} n={h['n']}: max|kernel-plain| {h['err']:.3g} "
            f"({arm_note(h) if arm else free_note(h)}), repeat bit-identical {h['per']}")


def drive_sweep(dev):
    """Every furniture model of the registry as a ``CursorEnv`` on the card,
    then the arm subset as Sawyer impedance, at ``SWEEP_SIM`` and B =
    ``SWEEP_B``: reset, ``SWEEP_STEPS`` steps of
    ``tests/test_all_furniture_runtime.py``'s actions, its checks on every
    env, and the kernels' launches (read before the holds). Then each
    kernel of the model's path against its plain version: kernel 1 after 5
    substeps from the settled reset and, for the cursor envs, from the
    stepped state (``hold_free``, ``chaotic``: a model's reset may be
    chaotic in most of its envs); for the arm envs kernel 2 at each step's
    own inputs (``recording``, ``hold_call``). One row a model."""
    import contextlib

    import torch

    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.models import furniture_names
    from furniture_tpu_torch.physics import engine, lane_solver

    sim = SimConfig(**SWEEP_SIM)
    gen = torch.Generator(device=dev)
    rows = []
    for agent, name in [("Cursor", n) for n in furniture_names] + [("Sawyer", n) for n in SWEEP_ARM]:
        t0 = time.perf_counter()
        if agent == "Cursor":
            env = CursorEnv(EnvConfig(furniture_name=name, sim=sim), device=dev)
            free = env.physics
            lane = engine.make_substep(engine.physics_tables(env.model),
                                       SimConfig(**SWEEP_SIM, use_pallas="lane"), dev).lane_tables
            routes = {"kernel 3": lane_solver.ROUTE_NAMES[lane.route]}
        else:
            env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance", furniture_name=name,
                                   sim=sim), device=dev)
            free = env._settle_physics
            routes = {"kernel 2": "shared memory" if env.physics.lane_buffer()[2] else "global scratch"}
        _, _, in_smem, regs = free.lane_buffer()
        routes["kernel 1"] = "registers" if regs else ("shared memory" if in_smem else "global scratch")
        build_s = time.perf_counter() - t0
        gen.manual_seed(3)
        state, reset_s = _timed(lambda: env.reset_batch(SWEEP_B, gen))
        problem = live_state_problem(env, state)
        action = torch.zeros((SWEEP_B, env.dof), device=dev)
        if agent == "Cursor":
            action[:, 0], action[:, 2] = 0.5, 0.2
        else:
            action[:, -2] = -1.0
        rew_finite = obs_finite = True
        reset_state = state
        arm = agent != "Cursor"
        with recording(env, keep=SWEEP_STEPS) if arm else contextlib.nullcontext(()) as calls:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SWEEP_STEPS):
                state, obs, rew, done, info = env.step_batch(state, action)
                rew_finite &= bool(torch.isfinite(rew).all())
                obs_finite &= all(bool(torch.isfinite(v.float()).all()) for v in obs.values())
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) / SWEEP_STEPS * 1e3
        problem = problem or live_state_problem(env, state)
        if arm and not torch.isfinite(state.qpos).all():
            problem = problem or "qpos not finite"
        row = {"agent": agent, "name": name, "P": env._P, "K": free.K, "routes": routes,
               "build_s": build_s, "reset_ms": reset_s * 1e3, "step_ms": step_ms,
               "free_launches": free.launches, "arm_launches": env.physics.launches if arm else 0,
               "arm_K": env.physics.K if arm else None,
               "problem": problem, "reward_finite": rew_finite, "obs_finite": obs_finite}
        ones = torch.ones((SWEEP_B, env._P), device=dev)
        holds = [("kernel 1 from the reset", hold_free(free, reset_state.parts, reset_state.group, ones, 5,
                                                       1e-4, chaotic=True))]
        if not arm:
            holds.append(("kernel 1 from the stepped state", hold_free(free, state.parts, state.group, ones, 5,
                                                                       1e-4, chaotic=True)))
        else:
            holds += [(f"kernel 2 at step {k + 1}'s inputs", h)
                      for k, call in enumerate(calls) for h in hold_call(env.physics, call)]
        row["holds"] = holds
        row["recorded"] = len(calls)
        rows.append(row)
    return rows


def time_lane_routes(dev) -> dict:
    """Kernel 3 on each model of ``LANE_ROUTE_MODELS`` at B = ``MAIN_B``,
    default ``SimConfig`` (12 sweeps), on the contacts of a settled reset
    dropped onto the floor by 50 free-part substeps (gravity on): its route,
    the lanes in contact, the bound of this data's work, and its ms a
    launch, timed in turns (first, second, second, first) by CUDA events."""
    import torch

    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.physics import engine, lane_solver
    from furniture_tpu_torch.physics.megakernel import make_batched_substeps
    from furniture_tpu_torch.physics.state import PartState

    gen = torch.Generator(device=dev)
    cases = {}
    for name in LANE_ROUTE_MODELS:
        env = CursorEnv(EnvConfig(furniture_name=name), device=dev)
        gen.manual_seed(3)
        st = env.reset_batch(MAIN_B, gen)
        ones = torch.ones((MAIN_B, env._P), device=dev)
        group = st.group.contiguous()
        parts = env.physics.substeps(PartState(*(t.contiguous() for t in st.parts)), group, ones, 50)
        lphys = make_batched_substeps(engine.physics_tables(env.model), SimConfig(use_pallas="lane"), dev)
        args = lphys.solver_args(PartState(*(t.contiguous() for t in parts)), group, ones)
        tables = lphys.lane_tables
        c = args[0]
        K, P, iters = c.depth.shape[1], env._P, args[8]
        K_b = int((c.part_b >= 0).sum())
        live = c.mask & (c.depth > -args[10])
        mask_env, act_env = c.mask.sum(-1).tolist(), live.sum(-1).tolist()
        actb_env = (live & (c.part_b >= 0)).sum(-1).tolist()
        ops = sum(lane_solver.fp32_ops_per_env(K, K_b, P, iters, a, ab) for a, ab in zip(act_env, actb_env))
        nbytes = sum(lane_solver.bytes_per_env(K, P, m, a) for m, a in zip(mask_env, act_env)) \
            + tables.table_bytes()
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        lane_solver.launch(tables, *args)  # warm-up
        cases[name] = {"K": K, "P": P, "sweeps": iters, "route": lane_solver.ROUTE_NAMES[tables.route],
                       "lanes_with_contact": sum(act_env), "lanes_with_mask_set": sum(mask_env),
                       "ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ms": [],
                       "run": (tables, args)}
    for name in list(LANE_ROUTE_MODELS) + list(reversed(LANE_ROUTE_MODELS)):
        tables, args = cases[name]["run"]
        cases[name]["ms"].append(cuda_ms(lambda: lane_solver.launch(tables, *args), 20))
    for case in cases.values():
        del case["run"]
    return cases


class made_objects:
    """``with made_objects({A: "method"}) as made:`` appends to ``made[A]``
    every object of class ``A`` made inside the block, as ``(obj, calls)``,
    where ``calls`` keeps the inputs of the object's last call of
    ``method`` (``record_calls``): how a tool phase finds the kernel
    wrappers of the envs a tool builds for itself, each with its
    ``launches`` count from 0, and the inputs each kernel last had."""

    def __init__(self, methods: dict):
        self.methods = methods

    def __enter__(self):
        self.made = {c: [] for c in self.methods}
        self.inits = {c: c.__init__ for c in self.methods}
        for c, init in self.inits.items():
            def wrapped(obj, *args, _init=init, _c=c, **kw):
                _init(obj, *args, **kw)
                self.made[_c].append((obj, record_calls(obj, self.methods[_c], 1)))
            c.__init__ = wrapped
        return self.made

    def __exit__(self, *exc):
        for c, init in self.inits.items():
            c.__init__ = init
        return False


def drive_tools(dev) -> dict:
    """Each command-line tool of the port through its ``main()`` on the card
    with small arguments, its outputs in a temporary directory: ``run_demo``
    (state replay of a committed demo; action replay of a copy cut to its
    first ``TOOL_REPLAY_ACTIONS`` actions), ``run_manual`` on a key script,
    ``eval_bc`` at 5 epochs x 8 episodes x 20 steps, ``fps --all`` at its
    default batch, ``resize`` into a temporary asset copy, ``profile_gen``
    at ``TOOL_GEN``, and ``profile_cursor`` and ``profile_ilqr`` at their
    bench sizes. Per tool: seconds, stdout, what ``main`` returned, the
    launches of the kernel wrappers the tool made (``made_objects``), and
    then each of those kernels held against its plain version at the
    inputs of its last call in the tool (``hold_call``)."""
    import contextlib
    import io
    import pickle
    import shutil
    import tempfile

    import torch

    from furniture_tpu_torch import models
    from furniture_tpu_torch.models import compiler
    from furniture_tpu_torch.physics.arm_megakernel import ArmMegaPhysics
    from furniture_tpu_torch.physics.megakernel import MegaPhysics
    from furniture_tpu_torch.tools import (
        eval_bc, fps, profile_cursor, profile_gen, profile_ilqr, resize, run_demo, run_manual,
    )

    out = {}
    tmp = tempfile.mkdtemp()
    real_assets = models.ASSET_DIR

    def run(key, fn, argv):
        buf = io.StringIO()
        methods = {MegaPhysics: "substeps", ArmMegaPhysics: "control_step"}
        with made_objects(methods) as made, contextlib.redirect_stdout(buf):
            ret, sec = _timed(lambda: fn(argv))
        out[key] = {"s": sec, "stdout": buf.getvalue(), "ret": ret,
                    "free_launches": sum(o.launches for o, _ in made[MegaPhysics]),
                    "arm_launches": sum(o.launches for o, _ in made[ArmMegaPhysics]),
                    "wrappers": (len(made[MegaPhysics]), len(made[ArmMegaPhysics]))}
        t = time.perf_counter()
        out[key]["holds"] = [(f"{c.__name__} {j} of {len(made[c])}, its last call (B={call[1].shape[0]}, "
                              f"n={call[-1]})", h)
                             for c in methods for j, (o, calls) in enumerate(made[c])
                             for call in calls for h in hold_call(o, call)]
        out[key]["hold_s"] = time.perf_counter() - t
        print(f"[clock] {time.perf_counter() - T_START:7.1f} s: tool {key} done ({sec:.1f} s; its kernels "
              f"held in {out[key]['hold_s']:.1f} s)", flush=True)

    try:
        demo = os.path.join(HERE, TOOL_DEMO)
        run("run_demo_state_replay", run_demo.main, [demo, "--env", "IKEASawyer-v0", "--state_replay"])
        with open(demo, "rb") as f:
            cut = pickle.load(f)
        cut["actions"] = cut["actions"][:TOOL_REPLAY_ACTIONS]
        cut_path = os.path.join(tmp, "cut.pkl")
        with open(cut_path, "wb") as f:
            pickle.dump(cut, f)
        run("run_demo_actions", run_demo.main, [cut_path, "--env", "IKEASawyer-v0"])
        run("run_manual", run_manual.main, ["--script", TOOL_SCRIPT, "--out_dir", tmp,
                                            "--demo_dir", os.path.join(tmp, "demos")])
        run("eval_bc", eval_bc.main, ["--demos", os.path.join(HERE, "demos", "generated", "*.pkl"),
                                      "--epochs", "5", "--episodes", "8", "--steps", "20",
                                      "--out", os.path.join(tmp, "bc_eval.json")])
        run("fps", fps.main, ["--all"])
        assets = os.path.join(tmp, "assets")
        shutil.copytree(real_assets, assets)
        models.ASSET_DIR = compiler.ASSET_DIR = type(real_assets)(assets)
        try:
            run("resize", resize.main, ["table_lack_0825", "--scale", "1.3"])
        finally:
            models.ASSET_DIR = compiler.ASSET_DIR = real_assets
        out["resize"]["in_real_assets"] = os.path.exists(
            os.path.join(real_assets, "furniture", "table_lack_0825_x1p3.json"))
        run("profile_gen", profile_gen.main, ["--batch", str(TOOL_GEN[0]), "--max_steps",
                                              str(TOOL_GEN[1]), "--out", os.path.join(tmp, "gen.json")])
        run("profile_cursor", profile_cursor.main, ["--out", os.path.join(tmp, "cursor.json")])
        run("profile_ilqr", profile_ilqr.main, ["--out", os.path.join(tmp, "ilqr.json")])
        out["files"] = {f: os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)
                        if os.path.isfile(os.path.join(tmp, f))}
        with open(os.path.join(tmp, "bc_eval.json")) as f:
            out["bc_eval_json"] = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    return out


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import furniture_tpu_torch as ft
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    if not os.path.abspath(ft.__file__).startswith(os.path.join(HERE, "furniture_tpu_torch")):
        fail(f"imported the port from {ft.__file__}, not from this checkout")
    from furniture_tpu_torch import _cuda
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.config import SimConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.physics import arm_megakernel, engine, lane_solver, megakernel
    from furniture_tpu_torch.planning import CEMConfig, MPPIConfig, make_cem, make_mppi
    from furniture_tpu_torch.robots import kinematics as K
    from furniture_tpu_torch.physics.state import PartState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card, watts = card_name_and_limit()
    print(f"card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}", flush=True)

    # -- 1. build ---------------------------------------------------------------
    stamp("build")
    t0 = time.perf_counter()
    sources = [megakernel.SOURCE, arm_megakernel.SOURCE, lane_solver.SOURCE]
    builds = [(s, ()) for s in sources] + [(s, _cuda.PHASE_CLOCKS) for s in sources]
    procs = [_cuda.start_build(s, d) for s, d in builds]
    for p in procs:
        _cuda.finish_build(p)
    for s, d in builds:
        print(f"[build] {os.path.relpath(s, HERE)} {' '.join('-D' + x for x in d)} "
              f"({time.perf_counter() - t0:.1f} s):")
        for line in _cuda.build_log(s, d).splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print("   ", line.strip())
    megakernel.library()
    arm_megakernel.library()
    lane_solver.library()
    megakernel.library(_cuda.PHASE_CLOCKS)
    arm_megakernel.library(_cuda.PHASE_CLOCKS)
    lane_solver.library(_cuda.PHASE_CLOCKS)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count

    # -- 2. kernel vs plain -------------------------------------------------------
    stamp("free-part kernel vs plain")
    worst = 0.0   # over the checks held at their stated bounds
    spread_cases = []
    gen = torch.Generator(device=dev)

    def hold(env, parts, group, gscale, tag, checks=((5, 1e-4), (50, 1e-3)), chaotic_at=(),
             pinched=False):
        """Kernel vs plain after n substeps within tol, for each (n, tol)
        of ``checks``. Where n is in ``chaotic_at`` the motion is chaotic:
        there the plain version's own spread under a 1e-7 input
        perturbation is measured and the kernel is held to 10x that spread
        where it exceeds tol. A ``pinched`` state is ill-conditioned in a
        few envs: it is held env by env, its median and the count of envs
        over tol limited (``hold_free``). An env next to a
        contact onset jumps; so does a symmetric contact, such as the snap
        substep's placeholder of part 0 at the origin in every env without
        a connect, whose large impulses cancel to a rounding that position
        noise alone does not move."""
        nonlocal worst
        phys = env.physics
        for n, tol in checks:
            if pinched:
                h = hold_free(phys, parts, group, gscale, n, tol)
                print(hold_line(tag, h), flush=True)
                if h["problem"]:
                    fail(f"{tag} n={n}: {h['problem']}")
                spread_cases.append((f"{tag} n={n}", h["err"], h["spread"]))
                worst = max(worst, h["median"])
                continue
            ref = phys.plain_substeps(parts, group, gscale, n)
            out = phys.kernel_substeps(parts, group, gscale, n)
            again = phys.kernel_substeps(parts, group, gscale, n)
            torch.cuda.synchronize()
            for name, b in zip(PartState._fields, out):
                if not torch.isfinite(b).all():
                    fail(f"{tag} n={n}: kernel {name} not finite")
            if not same_bits(out, again):
                fail(f"{tag} n={n}: two launches on one input differ")
            err = max_err(ref, out)
            per = {f: round(max_err([a], [b]), 9) for f, a, b in zip(PartState._fields, ref, out)}
            note = ""
            if n in chaotic_at:
                g2 = torch.Generator(device=dev)
                g2.manual_seed(7)
                eps = (torch.rand(parts.pos.shape, generator=g2, device=dev) - 0.5) * 2e-7
                ref2 = phys.plain_substeps(parts._replace(pos=parts.pos + eps), group, gscale, n)
                spread = max_err(ref, ref2)
                tol = max(tol, 10 * spread)
                spread_cases.append((tag, err, spread))
                note = f", plain vs plain(pos + 1e-7 noise) {spread:.3g}"
            else:
                worst = max(worst, err)
            print(f"[check] {tag} n={n}: max|kernel-plain| {err:.3g} (bound {tol:.3g}{note}), "
                  f"repeat bit-identical {per}", flush=True)
            if not err <= tol:
                fail(f"{tag} n={n}: kernel disagrees with its plain version ({err} > {tol})")

    for name in ("table_lack_0825", "chair_balser_0115"):
        env = CursorEnv(EnvConfig(furniture_name=name), device=dev)
        gen.manual_seed(0)
        state = env.reset_batch(CHECK_B, gen)
        P = env._P
        nf, smem, in_smem, in_regs = env.physics.lane_buffer()
        where = "registers (one lane a thread)" if in_regs else (
            "shared memory" if in_smem else "global scratch")
        print(f"[check] {name}: P={P} K={env.physics.K} slots {env.physics.slots['KS']} lane working "
              f"set in {where} ({smem} B shared/block, {env.physics.resident_blocks()} blocks an SM)")
        parts = state.parts._replace(
            lin_vel=state.parts.lin_vel + 0.05, ang_vel=state.parts.ang_vel + 0.1
        )
        group = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(CHECK_B, 1)
        hold(env, parts, group, torch.ones((CHECK_B, P), device=dev), f"{name} free")
        # parts 0 and 1 welded where they lie (apart), part 2 gravity-compensated
        group = group.clone()
        group[:, 1] = 0
        gscale = torch.ones((CHECK_B, P), device=dev)
        gscale[:, 2] = 0.0
        hold(env, state.parts, group, gscale, f"{name} welded-apart+gravity-comp",
             chaotic_at=(50,))
    # SAT edge lanes: leg 1 laid across leg 0 (edge on edge, no corner
    # inside either box), settled into contact by the plain version, then
    # 1 and 5 substeps (longer runs of this point contact are chaotic)
    from furniture_tpu_torch import transforms as T
    from furniture_tpu_torch.physics.collide import edge_contacts, pair_contacts, torch_tables

    env = CursorEnv(EnvConfig(), device=dev)
    P = env._P
    pos = torch.tensor([[2.0 + i, 2.0 + i, 0.02] for i in range(P)], device=dev)
    pos[0] = torch.tensor([0.0, 0.0, 0.017], device=dev)
    pos[1] = torch.tensor([0.0, 0.0, 0.055], device=dev)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(P, 1)
    y90 = T.euler_to_quat(torch.tensor([0.0, 90.0, 0.0], device=dev))
    quat[0] = y90
    quat[1] = T.quat_mul(T.euler_to_quat(torch.tensor([0.0, 0.0, 90.0], device=dev)), y90)
    pos = pos[None].repeat(CHECK_B, 1, 1)
    pos[:, 1, 0] += torch.linspace(-0.01, 0.01, CHECK_B, device=dev)
    group = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(CHECK_B, 1)
    gscale = torch.ones((CHECK_B, P), device=dev)
    start = env.physics.plain_substeps(
        PartState(pos, quat[None].repeat(CHECK_B, 1, 1), torch.zeros_like(pos), torch.zeros_like(pos)),
        group, gscale, 50,
    )
    tt = torch_tables(env.tables, dev)
    slop = env.config.sim.contact_slop
    NP = env.physics.Ke
    pm = pair_contacts(tt, start.pos, start.quat, group, slop).mask
    hit = pm[:, : NP * 8].reshape(-1, NP, 8).any(-1) | pm[:, NP * 8 :].reshape(-1, NP, 8).any(-1)
    n_edge = int(edge_contacts(tt, start.pos, start.quat, group, slop, hit).mask.sum())
    print(f"[check] crossed legs: {n_edge} SAT edge lanes active in {CHECK_B} envs")
    if n_edge == 0:
        fail("the crossed-legs case has no active SAT edge lane")
    hold(env, start, group, gscale, "table_lack_0825 crossed-legs SAT",
         checks=((1, 1e-4), (5, 1e-4)))

    # welded by connects (two recipe subtasks preassembled at reset), one
    # free leg gravity-compensated
    env = CursorEnv(EnvConfig(preassembled=(0, 1)), device=dev)
    gen.manual_seed(0)
    state = env.reset_batch(CHECK_B, gen)
    gscale = torch.ones((CHECK_B, env._P), device=dev)
    gscale[:, 3] = 0.0
    print(f"[check] table_lack_0825 preassembled (0, 1): groups {state.group[0].tolist()}")
    hold(env, state.parts, state.group, gscale, "table_lack_0825 welded-by-connect+gravity-comp")

    # -- 2b. arm kernel vs plain --------------------------------------------------
    stamp("arm kernel vs plain")
    arm_worst = 0.0      # over the checks held at their stated bounds
    arm_spread_cases = []

    def arm_inputs(env, state, ctrl):
        B = ctrl.shape[0]
        G1, G2 = K.joint_dyn_matrices(env.robot, state.qpos, env.config.sim.timestep)
        return (
            PartState(*(t.contiguous() for t in state.parts)), state.group,
            torch.ones((B, env._P), device=dev), state.qpos, state.qvel, ctrl,
            torch.zeros((B, env.robot.nj), device=dev), G1.contiguous(), G2.contiguous(),
        )

    def hold_arm(env, state, ctrl, tag, checks, pinched, want_touch, recorded=None):
        """Arm kernel vs plain after n substeps for each (n, tol), from
        ``state`` under ``ctrl``, or from ``recorded`` (the inputs of one
        ``control_step`` call but its ``n``) where given
        (``hold_arm_call``)."""
        nonlocal arm_worst
        args = arm_inputs(env, state, ctrl) if recorded is None else recorded
        for n, tol in checks:
            h = hold_arm_call(env.physics, args, n, tol, pinched)
            print(hold_line(tag, h), flush=True)
            if h["problem"]:
                fail(f"{tag} n={n}: {h['problem']}")
            if want_touch and h["n_touch"] == 0:
                fail(f"{tag} n={n}: no touch flag set")
            if pinched:
                sp = h["spreads"] or {}
                arm_spread_cases.append((f"{tag} n={n}", h["err"], h["median"], sp.get(1e-7), sp.get(1e-6),
                                         h["envs_over"]))
                arm_worst = max(arm_worst, h["median"])
            else:
                arm_worst = max(arm_worst, h["err"])

    def hold_recorded(env, calls, tag):
        """The kernel of ``env``'s path against its plain version at that
        path's own inputs (``recording``: kernel 2 for an arm env's calls,
        kernel 1 for a cursor env's) at ``recorded_checks``. A rollout's
        state may hold a part against the fingers, or parts at the velocity
        clamp in contact (the plan's late steps at ``timestep=0.02``), where
        the plain version itself jumps by far more than the bound in a few
        envs: so both kernels are held by phase 2's rule for a pinched
        state. At B = 1 that is the plain bound but where the plain
        version's own spread is larger."""
        if not calls:
            fail(f"{tag}: no physics call recorded")
        for k, call in enumerate(calls):
            where = f"{tag}, call {k + 1} of {len(calls)} (B={call[1].shape[0]}, n={call[-1]})"
            if len(call) == 10:
                hold_arm(env, None, None, where, recorded_checks(call), True, False, recorded=call[:-1])
            else:
                hold(env, *call[:3], where, checks=recorded_checks(call), pinched=True)

    def staged(agent, where, **sim):
        """An impedance env of ``agent``, a reset with part 0 placed at the
        first arm's grip site ("grip"), in its left fingertip ("tip") or
        left where it settled ("free"), and a random action with the
        grippers closing."""
        env = ArmEnv(EnvConfig(agent_type=agent, control_type="impedance", sim=SimConfig(**sim)),
                     device=dev)
        gen.manual_seed(0)
        st = env.reset_batch(CHECK_B, gen)
        r, arm = env.robot, env.arms[0]
        fk_out = K.fk(r, st.qpos)
        if where != "free":
            if where == "grip":
                target, _ = K.site_world(r, fk_out, arm)
            else:
                # off the fingertip's center: a sample point exactly on a
                # box center ties the least-penetrated axis
                target = K.geom_world(r, fk_out)[0][:, int(r.finger_geoms_l[arm][-1])]
                target = target + torch.tensor([0.004, 0.003, 0.002], device=dev)
            pos = st.parts.pos.clone()
            pos[:, 0] = target
            st = st._replace(parts=st.parts._replace(pos=pos))
        gen.manual_seed(1)
        act = torch.rand((CHECK_B, env.dof), generator=gen, device=dev) * 2 - 1
        act[:, -1 - env.n_arms : -1] = -1.0        # close every gripper hard
        return env, st, env._direct_ctrl(act[:, :-1])

    env, st, ctrl = staged("Sawyer", "grip")
    nf, smem, in_smem = env.physics.lane_buffer()
    print(f"[check] arm Sawyer table_lack_0825: K={env.physics.K} NJ={env.robot.nj} "
          f"hand geoms {env.physics.NRG}, lane working set in "
          f"{'shared memory' if in_smem else 'global scratch'} ({smem} B shared/block, "
          f"{env.physics.resident_blocks()} block(s) an SM)")
    if env.physics.K != 1260:
        fail(f"Sawyer on table_lack has K = {env.physics.K}, not 1260")
    hold_arm(env, st, ctrl, "Sawyer gripped", ((1, 5e-4),), False, True)
    hold_arm(env, st, ctrl, "Sawyer gripped", ((5, 5e-4), (50, 1e-3)), True, True)
    env.physics.smem_limit = 64 * 1024
    if env.physics.lane_buffer()[2]:
        fail("the lowered shared-memory limit did not select the global-scratch route")
    hold_arm(env, st, ctrl, "Sawyer gripped, global scratch", ((5, 5e-4),), True, True)
    env, st, ctrl = staged("Sawyer", "free")
    hold_arm(env, st, ctrl, "Sawyer free", ((50, 1e-3),), False, False)
    env, st, ctrl = staged("Sawyer", "grip", robot_coupling=False)
    hold_arm(env, st, ctrl, "Sawyer gripped, robot_coupling=False", ((5, 5e-4),), True, True)
    env, st, ctrl = staged("Sawyer", "grip", held_vel_clamp=0.05)
    hold_arm(env, st, ctrl, "Sawyer gripped, held_vel_clamp=0.05", ((5, 5e-4),), True, True)
    env, st, ctrl = staged("Baxter", "tip")
    print(f"[check] arm Baxter table_lack_0825: K={env.physics.K} NJ={env.robot.nj} "
          f"hand geoms {env.physics.NRG}, {env.physics.lane_buffer()[1]} B shared/block")
    if env.physics.K != 1610:
        fail(f"Baxter on table_lack has K = {env.physics.K}, not 1610")
    hold_arm(env, st, ctrl, "Baxter part in fingertip", ((1, 5e-4),), False, True)
    hold_arm(env, st, ctrl, "Baxter part in fingertip", ((5, 5e-4),), True, True)

    # -- 2c. lane solver vs plain ---------------------------------------------------
    stamp("lane solver vs plain")
    lane_worst = 0.0
    lane_cold_gap = [0.0, 0.0]

    def lane_args(name, stack, **cfg):
        """Solver arguments from a real state: a reset of the lane-backend
        env dropped onto the floor by 50 substeps under gravity, then part
        velocities of 0.1 m/s."""
        env = CursorEnv(EnvConfig(furniture_name=name, sim=SimConfig(use_pallas="lane"), **cfg),
                        device=dev)
        gen.manual_seed(0)
        st = env.reset_batch(CHECK_B, gen)
        ones = torch.ones((CHECK_B, env._P), device=dev)
        parts = st.parts
        if stack:
            # leg 0 laid on the table top, so that pair lanes carry contact
            pos = parts.pos.clone()
            pos[:, 0] = pos[:, 4] + torch.tensor([0.05, 0.0, 0.02 + 0.015 - 0.002], device=dev)
            parts = parts._replace(pos=pos)
        parts = env.physics.substeps(parts, st.group, ones, 50)
        # 0.1 m/s along the floor and into it, 0.1 rad/s about every axis
        push = torch.tensor([0.1, 0.1, -0.1], device=dev)
        parts = parts._replace(lin_vel=parts.lin_vel + push, ang_vel=parts.ang_vel + 0.1)
        return env, st.group, env.physics.solver_args(parts, st.group, ones)

    def hold_lane(tag, tables, args, route=None, exact=False, sweeps=(12, 24)):
        """The kernel (``solve_contacts_lane`` with the model's ``tables``,
        or one launch of ``route``'s tables) against the plain version at
        each of ``sweeps`` within 1e-4, two launches bit-identical, held to
        the cold ``engine._solve_contacts``; ``exact``: no lane has a
        contact, so the velocities come back as they went in."""
        nonlocal lane_worst
        c = args[0]
        B_, P_ = args[1].shape
        n_lanes = c.depth.shape[1]
        if route is not None:
            tables = lane_solver.LaneTables.of(c, P_, route)
        live = c.mask & (c.depth > -args[10])
        active = int(live.sum())
        active_b = int((live & (c.part_b >= 0)).sum())
        print(f"[check] lane {tag}: P={P_} K={n_lanes} slots {tables.KS} ({tables.lpt} a thread), route "
              f"{lane_solver.ROUTE_NAMES[tables.route]}, {tables.smem_bytes()} B shared/block, "
              f"{tables.resident_blocks()} blocks an SM, {active} active lanes in {B_} envs "
              f"({active_b} between parts), groups {args[1][0].tolist()}"
              f"{', vel_b set' if c.vel_b is not None else ''}")
        if exact != (active == 0):
            fail(f"lane {tag}: {active} active contact lanes")

        def solve(a):
            if route is None:
                return lane_solver.solve_contacts_lane(*a, tables=tables)
            return lane_solver.launch(tables, *a)[:2]

        for iters in sweeps:
            a = args[:8] + (iters,) + args[9:]
            lv, av = solve(a)
            lv2, av2 = solve(a)
            rl, ra = lane_solver.plain_solve_contacts_lane(*a)
            wl, wa, _, _ = engine._solve_contacts(*a, torch.zeros((B_, n_lanes, 3), device=dev))
            torch.cuda.synchronize()
            if not (torch.isfinite(lv).all() and torch.isfinite(av).all()):
                fail(f"lane {tag} iters={iters}: kernel output not finite")
            if not (torch.equal(lv, lv2) and torch.equal(av, av2)):
                fail(f"lane {tag} iters={iters}: two launches on one input differ")
            e_l, e_a = (lv - rl).abs().max().item(), (av - ra).abs().max().item()
            g_l, g_a = (lv - wl).abs().max().item(), (av - wa).abs().max().item()
            moved = (lv - a[5]).abs().max().item()
            print(f"[check] lane {tag} iters={iters}: max|kernel-plain| lin {e_l:.3g} ang {e_a:.3g} "
                  f"(bound 1e-4), repeat bit-identical, vs engine._solve_contacts cold lin {g_l:.3g} "
                  f"ang {g_a:.3g} (bounds 2e-3, 5e-3 + 1e-3 relative), solve moved lin_vel by {moved:.3g}",
                  flush=True)
            if not max(e_l, e_a) <= 1e-4:
                fail(f"lane {tag} iters={iters}: kernel disagrees with its plain version")
            if exact:
                if not (torch.equal(lv, a[5]) and torch.equal(av, a[6])):
                    fail(f"lane {tag} iters={iters}: no lane has a contact, yet the velocities moved")
            elif not moved > 1e-3:
                fail(f"lane {tag} iters={iters}: the solve changed nothing")
            if not ((lv - wl).abs() <= 2e-3 + 1e-3 * wl.abs()).all() or not (
                (av - wa).abs() <= 5e-3 + 1e-3 * wa.abs()
            ).all():
                fail(f"lane {tag} iters={iters}: kernel and cold engine._solve_contacts disagree")
            lane_worst = max(lane_worst, e_l, e_a)
            lane_cold_gap[0] = max(lane_cold_gap[0], g_l)
            lane_cold_gap[1] = max(lane_cold_gap[1], g_a)

    for tag, name, stack, cfg in (
        ("table_lack_0825 leg on table top", "table_lack_0825", True, {}),
        ("chair_balser_0115", "chair_balser_0115", False, {}),
        ("table_lack_0825 welded-by-connect", "table_lack_0825", False, {"preassembled": (0, 1)}),
    ):
        env, group, args = lane_args(name, stack, **cfg)
        if stack and not bool((args[0].mask & (args[0].part_b >= 0)).any()):
            fail(f"lane {tag}: no contact between parts")
        tables = env.physics.lane_tables
        hold_lane(tag, tables, args)
        if stack:
            c = args[0]
            route = lane_solver.ROUTE_MEMORY
            hold_lane(f"{tag}, {lane_solver.ROUTE_NAMES[route]}", tables, args, route)
            # kinematic lanes: a prescribed b-side velocity on every lane
            gen.manual_seed(4)
            vel_b = torch.randn(c.point.shape, generator=gen, device=dev) * 0.05
            hold_lane(f"{tag}, vel_b", tables, (c._replace(vel_b=vel_b),) + args[1:])
            hold_lane(f"{tag}, every lane masked", tables,
                      (c._replace(mask=torch.zeros_like(c.mask)),) + args[1:], exact=True)

    # -- 3. main path -----------------------------------------------------------
    stamp("cursor main path")
    vec = ft.make_vec_env("IKEACursor-v0", num_envs=MAIN_B, seed=0)
    phys = vec.env.physics
    agen = torch.Generator(device=dev)
    agen.manual_seed(1)
    actions = [torch.rand((MAIN_B, 15), generator=agen, device=dev) * 2 - 1 for _ in range(STEPS)]
    phys.launches = 0
    vec.reset()
    dones = []
    for a in actions:
        _, rew, done, _ = vec.step(a)
        dones.append(bool(done.any()))
    torch.cuda.synchronize()
    launches = phys.launches
    # 10 settle rounds, then per step the n-substep launch and the
    # unconditional 1-substep snap launch, plus a 10-launch reset on steps
    # where some lane finished
    expect = 10 + 2 * STEPS + 10 * sum(dones)
    print(f"[main] make_vec_env IKEACursor-v0 B={MAIN_B}: reset + {STEPS} steps, "
          f"kernel launches {launches} (expected {expect}), steps with a done {sum(dones)}")
    if launches != expect:
        fail(f"launch count {launches} != {expect}")
    s = vec.state
    env = vec.env
    def cursor_in_range(s, env, max_t, tag):
        for t in s.parts:
            if not torch.isfinite(t).all():
                fail(f"{tag}: state not finite")
        P, W = env._P, env._W
        checks = {
            "group": ((s.group >= 0) & (s.group < P)).all(),
            "selected": ((s.selected >= -1) & (s.selected < P)).all(),
            "num_connected": ((s.num_connected >= 0) & (s.num_connected <= W)).all(),
            "connect_step": ((s.connect_step >= 0) & (s.connect_step <= env.config.num_connect_steps)).all(),
            "subtask": ((s.subtask >= -1) & (s.subtask < P)).all(),
            "t": ((s.t >= 0) & (s.t <= max_t)).all(),
            "cursor": (s.cursor_pos.abs() <= env.config.cursor_boundary).all(),
            "quat_norm": ((s.parts.quat.norm(dim=-1) - 1).abs() < 1e-3).all(),
        }
        bad = [k for k, v in checks.items() if not bool(v)]
        if bad:
            fail(f"{tag}: state out of range: {bad}")

    cursor_in_range(s, env, STEPS, "main path")
    P = env._P
    print(f"[main] state finite and in range; mean reward of last step {rew.mean().item():.4f}")

    # a small batch through the card and through the CPU (plain version)
    from furniture_tpu_torch.convert import cursor_state_from_numpy, cursor_state_to_numpy

    def cursor_small_batch(env, cpu_env, n_steps, tag):
        """8 envs through the card and through the CPU (plain versions):
        discrete state exact, part floats within 1e-3."""
        gen.manual_seed(2)
        st_gpu = env.reset_batch(8, gen)
        st_cpu = cursor_state_from_numpy(cursor_state_to_numpy(st_gpu), "cpu")
        for i in range(n_steps):
            a = actions[i][:8]
            st_gpu = env.step_batch(st_gpu, a)[0]
            st_cpu = cpu_env.step_batch(st_cpu, a.cpu())[0]
        g, c = cursor_state_to_numpy(st_gpu), cursor_state_to_numpy(st_cpu)
        for k in ("group", "selected", "num_connected", "connect_step", "t"):
            if not np.array_equal(g[k], c[k]):
                fail(f"{tag} small batch: {k} differs between card and CPU")
        err = max(float(np.abs(g[k] - c[k]).max()) for k in ("pos", "quat", "lin_vel", "ang_vel"))
        print(f"[main] {tag} B=8, {n_steps} steps: card vs CPU plain version max|diff| {err:.3g} "
              f"(bound 1e-3)")
        if not err <= 1e-3:
            fail(f"{tag} small batch: card and CPU differ by {err}")
        return err

    err_small = cursor_small_batch(env, CursorEnv(EnvConfig(), device="cpu"), 3, "cursor")

    # -- 3b. arm main paths ---------------------------------------------------
    stamp("arm main paths")
    from furniture_tpu_torch.convert import arm_state_from_numpy, arm_state_to_numpy

    arm_vecs, arm_launches, free_launches_arm = {}, {}, 0
    for control_type, nb in ARM_RUNS:
        avec = ft.make_vec_env("IKEASawyer-v0", num_envs=nb, seed=0, control_type=control_type)
        aenv = avec.env
        agen = torch.Generator(device=dev)
        agen.manual_seed(1)
        acts = [torch.rand((nb, aenv.dof), generator=agen, device=dev) * 2 - 1 for _ in range(STEPS)]
        aenv.physics.launches = 0
        aenv.physics.free.launches = 0
        avec.reset()
        dones = []
        for a in acts:
            _, rew, done, _ = avec.step(a)
            dones.append(bool(done.any()))
        torch.cuda.synchronize()
        per_step = aenv.config.action_repeat if control_type == "ik" else 1
        want_arm = per_step * STEPS
        want_free = 10 + 10 * sum(dones)
        got_arm, got_free = aenv.physics.launches, aenv.physics.free.launches
        print(f"[main] make_vec_env IKEASawyer-v0 {control_type} B={nb}: reset + {STEPS} steps, "
              f"arm kernel launches {got_arm} (expected {want_arm}), free-part kernel launches "
              f"{got_free} (expected {want_free}), steps with a done {sum(dones)}")
        if got_arm != want_arm or got_free != want_free:
            fail(f"{control_type}: launch counts {got_arm}, {got_free} != {want_arm}, {want_free}")
        s = avec.state
        for t in list(s.parts) + [s.qpos, s.qvel, s.ik_target_pos, s.hand_quat_init, rew]:
            if not torch.isfinite(t).all():
                fail(f"{control_type}: main path state not finite")
        P, W = aenv._P, aenv._W
        lo = torch.as_tensor(aenv.robot.jnt_range[:, 0], dtype=torch.float32, device=dev)
        hi = torch.as_tensor(aenv.robot.jnt_range[:, 1], dtype=torch.float32, device=dev)
        checks = {
            "group": ((s.group >= 0) & (s.group < P)).all(),
            "num_connected": ((s.num_connected >= 0) & (s.num_connected <= W)).all(),
            "connect_step": (s.connect_step == 0).all(),
            "subtask": ((s.subtask >= -1) & (s.subtask < P)).all(),
            "t": ((s.t >= 0) & (s.t <= STEPS)).all(),
            "qpos": ((s.qpos >= lo) & (s.qpos <= hi)).all(),
            "quat_norm": ((s.parts.quat.norm(dim=-1) - 1).abs() < 1e-3).all(),
            "hand_quat_norm": ((s.hand_quat_init.norm(dim=-1) - 1).abs() < 1e-3).all(),
            "picked_implies_touched": (~s.picked | s.touched).all(),
        }
        bad = [k for k, v in checks.items() if not bool(v)]
        if bad:
            fail(f"{control_type}: main path state out of range: {bad}")
        print(f"[main] {control_type}: state finite and in range; parts touched so far "
              f"{int(s.touched.sum())}, mean reward of last step {rew.mean().item():.4f}")
        arm_vecs[control_type] = (avec, acts)
        arm_launches[control_type] = got_arm
        free_launches_arm += got_free

        # a small batch through the card and through the CPU (plain versions)
        cpu_aenv = ArmEnv(aenv.config, device="cpu")
        gen.manual_seed(2)
        st_gpu = aenv.reset_batch(8, gen)
        st_cpu = arm_state_from_numpy(arm_state_to_numpy(st_gpu), "cpu")
        for i in range(3):
            a = acts[i][:8]
            st_gpu, _, r_gpu, d_gpu, _ = aenv.step_batch(st_gpu, a)
            st_cpu, _, r_cpu, d_cpu, _ = cpu_aenv.step_batch(st_cpu, a.cpu())
        g, c = arm_state_to_numpy(st_gpu), arm_state_to_numpy(st_cpu)
        for k in ("group", "num_connected", "connect_step", "t", "touched", "picked",
                  "touch_l", "touch_r"):
            if not np.array_equal(g[k], c[k]):
                fail(f"{control_type} small batch: {k} differs between card and CPU")
        # parts and the IK target within 1e-3, and the joints too for
        # impedance. Under ik the joint velocities are 5x the converged DLS
        # command, whose orientation error 2*arccos(w) near w = 1 turns one
        # ulp of w into ~5e-4 rad, so card and CPU commands differ by that
        # noise: qvel 5e-2, and qpos 5e-3 after three 0.3 s steps
        ik = control_type == "ik"
        bounds = {"pos": 1e-3, "quat": 1e-3, "ik_target_pos": 1e-3, "lin_vel": 1e-3,
                  "ang_vel": 1e-3, "qpos": 5e-3 if ik else 1e-3, "qvel": 5e-2 if ik else 1e-3}
        per = {k: float(np.abs(g[k] - c[k]).max()) for k in bounds}
        print(f"[main] {control_type} B=8, 3 steps: card vs CPU plain version max|diff| "
              + ", ".join(f"{k} {per[k]:.3g} (bound {bounds[k]:g})" for k in bounds))
        bad = [k for k in bounds if not per[k] <= bounds[k]]
        if bad:
            fail(f"{control_type} small batch: card and CPU differ in {bad}")

    # -- 3c. the lane path ----------------------------------------------------------
    stamp("lane path")
    lane_sim = SimConfig(use_pallas="lane")
    lvec = ft.make_vec_env("IKEACursor-v0", num_envs=MAIN_B, seed=0, sim=lane_sim)
    lenv = lvec.env
    if not isinstance(lenv.physics, megakernel.LanePhysics):
        fail("use_pallas='lane' did not select the lane backend")
    lane_solver.launches = 0
    vec.env.physics.launches = 0
    lvec.reset()
    dones = []
    for a in actions[:LANE_STEPS]:
        _, rew, done, _ = lvec.step(a)
        dones.append(bool(done.any()))
    torch.cuda.synchronize()
    lane_launches = lane_solver.launches
    # 10 settle rounds of 10 substeps, one launch per substep; per step the
    # n substeps and the unconditional 1-substep snap launch; a reset more
    # on steps where some lane finished
    n_sub = lenv.config.n_substeps
    want_lane = 100 + (n_sub + 1) * LANE_STEPS + 100 * sum(dones)
    print(f"[main] make_vec_env IKEACursor-v0 use_pallas=lane B={MAIN_B}: reset + {LANE_STEPS} steps, "
          f"lane-solver launches {lane_launches} (expected {want_lane}), free-part kernel launches "
          f"{vec.env.physics.launches} (expected 0), steps with a done {sum(dones)}")
    if lane_launches != want_lane or vec.env.physics.launches != 0:
        fail(f"lane path launch counts {lane_launches}, {vec.env.physics.launches} != {want_lane}, 0")
    cursor_in_range(lvec.state, lenv, LANE_STEPS, "lane path")
    print(f"[main] lane path: state finite and in range; mean reward of last step {rew.mean().item():.4f}")
    cursor_small_batch(lenv, CursorEnv(EnvConfig(sim=lane_sim), device="cpu"), 2, "lane path")

    # -- 3d. the planners -----------------------------------------------------------
    stamp("planners")
    plan_sim = {"timestep": 0.02, "solver_iters": 8}     # bench.py's MPPI configuration
    mcfg = MPPIConfig(horizon=64, n_samples=256, sigma=0.3)
    penv = CursorEnv(EnvConfig(sim=SimConfig(**plan_sim)), device=dev)
    gen.manual_seed(0)
    pstate = penv.reset_batch(1, gen)
    plan = make_mppi(penv, mcfg)
    pgen = torch.Generator(device=dev)

    def check_plan(mean, info, tag):
        if not (torch.isfinite(info["costs"]).all() and torch.isfinite(mean).all()):
            fail(f"{tag}: costs or mean not finite")
        if mean.abs().max().item() > 1.0 + 1e-6:
            fail(f"{tag}: mean outside [-1, 1]")

    penv.physics.launches = 0
    mean = torch.zeros((mcfg.horizon, penv.dof), device=dev)
    mppi_s = []
    for i in range(3):                      # receding horizon: warm-started mean
        pgen.manual_seed(10 + i)
        (mean, pinfo), sec = _timed(lambda: plan(pstate, mean, pgen))
        check_plan(mean, pinfo, f"MPPI plan {i}")
        mppi_s.append(sec)
    mppi_launches = penv.physics.launches
    want = 3 * 2 * mcfg.horizon             # per control step: n substeps + the snap launch
    pgen.manual_seed(10)
    m0, _ = plan(pstate, torch.zeros_like(mean), pgen)
    pgen.manual_seed(10)
    m1, _ = plan(pstate, torch.zeros_like(mean), pgen)
    repeat_diff = (m0 - m1).abs().max().item()
    print(f"[main] MPPI horizon {mcfg.horizon} x {mcfg.n_samples} samples, default backend: 3 plans, "
          f"free-part kernel launches {mppi_launches} (expected {want}), best cost "
          f"{pinfo['best_cost'].item():.4f}, mean cost {pinfo['mean_cost'].item():.4f}, "
          f"same seed twice max|diff| {repeat_diff:.3g}; s per plan {[round(x, 3) for x in mppi_s]}")
    if mppi_launches != want:
        fail(f"MPPI launch count {mppi_launches} != {want}")
    if repeat_diff != 0.0:
        fail(f"MPPI: the same seed gave another mean ({repeat_diff})")

    lpenv = CursorEnv(EnvConfig(sim=SimConfig(use_pallas="lane", **plan_sim)), device=dev)
    lplan = make_mppi(lpenv, mcfg)
    lane_solver.launches = 0
    penv.physics.launches = 0
    pgen.manual_seed(10)
    (lmean, linfo), lane_plan_s = _timed(lambda: lplan(pstate, torch.zeros_like(mean), pgen))
    check_plan(lmean, linfo, "MPPI lane plan")
    mppi_lane_launches = lane_solver.launches
    want = mcfg.horizon * (lpenv.config.n_substeps + 1)
    print(f"[main] MPPI lane backend: 1 plan, lane-solver launches {mppi_lane_launches} (expected "
          f"{want}), free-part kernel launches {penv.physics.launches} (expected 0), best cost "
          f"{linfo['best_cost'].item():.4f}; {lane_plan_s:.3f} s")
    if mppi_lane_launches != want or penv.physics.launches != 0:
        fail(f"MPPI lane launch counts {mppi_lane_launches}, {penv.physics.launches} != {want}, 0")

    ccfg = CEMConfig(horizon=16, n_samples=256, n_elite=32)
    cem = make_cem(penv, ccfg)
    pgen.manual_seed(20)
    (cmean, csigma, cinfo), cem_s = _timed(lambda: cem(
        pstate, torch.zeros((ccfg.horizon, penv.dof), device=dev),
        torch.full((ccfg.horizon, penv.dof), ccfg.sigma_init, device=dev), pgen))
    cem_launches = penv.physics.launches
    check_plan(cmean, cinfo, "CEM")
    if not (torch.isfinite(csigma).all() and (csigma >= ccfg.sigma_min).all()):
        fail("CEM: sigma not finite or below sigma_min")
    print(f"[main] CEM horizon {ccfg.horizon} x {ccfg.n_samples} samples, {ccfg.n_elite} elites: 1 "
          f"iteration, free-part kernel launches {cem_launches} (expected {2 * ccfg.horizon}), best cost "
          f"{cinfo['best_cost'].item():.4f}; {cem_s:.3f} s")
    if cem_launches != 2 * ccfg.horizon:
        fail(f"CEM launch count {cem_launches} != {2 * ccfg.horizon}")

    # -- 3e. the torque-space controllers -------------------------------------------
    stamp("torque-space controllers")
    ctrl_vecs, ctrl_launches = {}, {}
    for control_type in ("position_orientation", "joint_impedance"):
        cvec = ft.make_vec_env("IKEASawyer-v0", num_envs=512, seed=0, control_type=control_type)
        cenv = cvec.env
        agen = torch.Generator(device=dev)
        agen.manual_seed(1)
        cacts = [torch.rand((512, cenv.dof), generator=agen, device=dev) * 2 - 1
                 for _ in range(CTRL_STEPS)]
        cenv.physics.launches = 0
        cenv.physics.free.launches = 0
        cvec.reset()
        dones, unstable = [], False
        for a in cacts:
            _, rew, done, info = cvec.step(a)
            dones.append(bool(done.any()))
            unstable = unstable or bool(info["unstable"].any())
        torch.cuda.synchronize()
        got_arm, got_free = cenv.physics.launches, cenv.physics.free.launches
        want_free = 10 + 10 * sum(dones)
        print(f"[main] make_vec_env IKEASawyer-v0 {control_type} B=512: reset + {CTRL_STEPS} steps, "
              f"arm kernel launches {got_arm} (expected {CTRL_STEPS}), free-part kernel launches "
              f"{got_free} (expected {want_free}), unstable {unstable}, max |qvel| "
              f"{cvec.state.qvel.abs().max().item():.3f}")
        if got_arm != CTRL_STEPS or got_free != want_free:
            fail(f"{control_type}: launch counts {got_arm}, {got_free} != {CTRL_STEPS}, {want_free}")
        cs = cvec.state
        for t in list(cs.parts) + [cs.qpos, cs.qvel, rew]:
            if not torch.isfinite(t).all():
                fail(f"{control_type}: state not finite")
        if unstable:
            fail(f"{control_type}: an env went unstable")
        ctrl_vecs[control_type] = (cvec, cacts)
        ctrl_launches[control_type] = got_arm

    # -- 3f. the task envs: the scripted demo generator -------------------------------
    stamp("generator rollout")
    from furniture_tpu_torch.convert import dense_state_to_numpy
    from furniture_tpu_torch.envs import sawyer_gen as SG
    from furniture_tpu_torch.tools.generate_demos import generate
    from furniture_tpu_torch.utils.demo import load_demo
    from furniture_tpu_torch.utils.traj_store import TrajStore

    genv = ft.make_vec_env("IKEASawyerGen-v0", num_envs=GEN_B, seed=0).env
    ggen = torch.Generator(device=dev)
    ggen.manual_seed(5)
    genv.physics.launches = 0
    genv.physics.free.launches = 0
    gstate = genv.reset_batch(GEN_B, ggen)
    pol = genv.init_policy_state(gstate, ggen)
    start_phase = pol.phase.clone()   # table_lack's first part starts past INIT_GRIP
    left_start = torch.zeros_like(start_phase, dtype=torch.bool)
    gen_step_ms, gen_policy_ms, phase_hist = [], [], []
    for _ in range(GEN_STEPS):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        ga, pol = genv.scripted_action(pol, gstate)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        gstate, _, grew, _, ginfo = genv.step_batch(gstate, ga)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        gen_policy_ms.append((t_b - t_a) * 1e3)
        gen_step_ms.append((t_c - t_b) * 1e3)
        phase_hist.append(torch.bincount(pol.phase.long(), minlength=SG.N_GEN_PHASES))
        left_start |= pol.phase != start_phase
    gen_arm_launches, gen_free_launches = genv.physics.launches, genv.physics.free.launches
    want_arm = genv.config.action_repeat * GEN_STEPS
    hist = torch.stack(phase_hist).sum(0).tolist()
    print(f"[main] make_vec_env IKEASawyerGen-v0 (ik) B={GEN_B}: reset_batch + {GEN_STEPS} steps of "
          f"scripted_action + step_batch, arm kernel launches {gen_arm_launches} (expected {want_arm}), "
          f"free-part kernel launches {gen_free_launches} (expected 10)")
    print(f"[main] generator: policy phases over the run (env-steps per phase) {hist}; final phases "
          f"{torch.bincount(pol.phase.long(), minlength=SG.N_GEN_PHASES).tolist()}; envs that left "
          f"their starting phase {int(left_start.sum())}; dense phases "
          f"{torch.bincount(gstate.phase_i.long(), minlength=8).tolist()}; parts touched "
          f"{int(gstate.touched.sum())}; mean reward of the last step {grew.mean().item():.3f}")
    if gen_arm_launches != want_arm or gen_free_launches != 10:
        fail(f"generator launch counts {gen_arm_launches}, {gen_free_launches} != {want_arm}, 10")
    for t in list(gstate.parts) + [gstate.qpos, gstate.qvel, grew, ga]:
        if not torch.isfinite(t).all():
            fail("generator rollout: state, reward or action not finite")
    if bool(ginfo["unstable"].any()):
        fail("generator rollout: an env went unstable")
    if not bool(left_start.any()):
        fail("generator rollout: no env left the phase it started in")
    # what paces the host: the ATen operations one decision and one step
    # dispatch (each an eager launch on the card, or a host-side op)
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with OpCount() as pol_ops:
        genv.scripted_action(pol, gstate)
    with OpCount() as step_ops:
        genv.step_batch(gstate, ga)
    with OpCount() as ik_ops:
        genv._ik_prepare(gstate, ga)
    gen_ops = {"scripted_action": pol_ops.n, "step_batch": step_ops.n, "_ik_prepare": ik_ops.n}
    print(f"[time] generator: ATen operations dispatched by one scripted_action {pol_ops.n}, one "
          f"step_batch {step_ops.n} (of which _ik_prepare {ik_ops.n})")
    tail = lambda xs: (float(np.median(xs[-20:])), min(xs[-20:]), max(xs[-20:]))
    gen_step_t, gen_policy_t = tail(gen_step_ms), tail(gen_policy_ms)
    print(f"[time] generator B={GEN_B}, the last 20 of {GEN_STEPS} steps: step_batch (ik) median "
          f"{gen_step_t[0]:.3f} ms (spread {gen_step_t[1]:.3f}-{gen_step_t[2]:.3f}); scripted_action "
          f"median {gen_policy_t[0]:.3f} ms (spread {gen_policy_t[1]:.3f}-{gen_policy_t[2]:.3f}); "
          f"{GEN_B / ((gen_step_t[0] + gen_policy_t[0]) / 1e3):.1f} scripted env steps/s")

    # -- 3g. a staged connect on the card, and its replay ------------------------------
    stamp("staged connect")
    st = genv._st
    ggen.manual_seed(3)
    sstate = genv.reset_batch(STAGED_B, ggen)
    fk_out = K.fk(genv.robot, sstate.qpos)
    grip_pos, _ = K.site_world(genv.robot, fk_out, "right")
    leg = int(st["leg"][0])
    sub0 = torch.zeros(STAGED_B, dtype=torch.long, device=dev)
    gl = genv._site_pos(sstate.parts, genv._stt["gl"][sub0])
    gr = genv._site_pos(sstate.parts, genv._stt["gr"][sub0])
    pos = sstate.parts.pos.clone()
    pos[:, leg] += grip_pos - 0.5 * (gl + gr)
    sstate = sstate._replace(parts=sstate.parts._replace(pos=pos))
    a_close = torch.zeros((STAGED_B, genv.dof), device=dev)
    a_close[:, 6] = 1.0
    for _ in range(8):
        sstate = genv.step_batch(sstate, a_close)[0]
    held = sstate.touch_l[:, 0, leg] & sstate.touch_r[:, 0, leg]
    print(f"[main] staged connect B={STAGED_B}: leg {leg} between the fingers, 8 closing steps: "
          f"held in {int(held.sum())} envs")
    if not bool(held.any()):
        fail("staged connect: the gripper closed on the leg in no env")
    pol = genv.init_policy_state(sstate, ggen)
    pol = pol._replace(phase=torch.full_like(pol.phase, SG.ALIGN_CONN))
    connected_at = None
    for i in range(STAGED_MAX):
        sa, pol = genv.scripted_action(pol, sstate)
        before = sstate
        sstate = genv.step_batch(sstate, sa)[0]
        if bool((sstate.num_connected >= 1).any()):
            connected_at = i
            break
    if connected_at is None:
        fail(f"staged connect: no env connected in {STAGED_MAX} policy steps (phases "
             f"{torch.bincount(pol.phase.long(), minlength=SG.N_GEN_PHASES).tolist()})")
    b = int(torch.nonzero(sstate.num_connected >= 1)[0, 0])
    print(f"[main] staged connect: env {b} connected at policy step {connected_at + 1} "
          f"({int((sstate.num_connected >= 1).sum())} of {STAGED_B} envs at that step), groups "
          f"{sstate.group[b].tolist()}")
    snap = {k: v[b].cpu().numpy() for k, v in genv.state_snap(before).items()}
    ggen.manual_seed(7)
    replay = genv.restore_snapshot(genv.reset_batch(1, ggen), snap)
    replay = genv.step_batch(replay, sa[b:b + 1])[0]
    rep_conn = int(replay.num_connected[0])
    print(f"[main] staged connect replay: env {b}'s pre-connect state restored with restore_snapshot "
          f"and its action stepped again: num_connected {rep_conn} (recorded "
          f"{int(sstate.num_connected[b])}), groups {replay.group[0].tolist()}")
    if rep_conn != int(sstate.num_connected[b]):
        fail("staged connect: the recorded connect did not reproduce under state replay")

    # -- 3h. the entry point: generate_demos through the CLI's function ------------------
    stamp("generate_demos entry point")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        demo_dir, store = os.path.join(tmp, "demos"), os.path.join(tmp, "demos.ftr")
        t_e = time.perf_counter()
        edemos, estats = generate(n_demos=ENTRY_B, batch=ENTRY_B, seed=0, max_steps=ENTRY_STEPS,
                                  out=store, demo_dir=demo_dir)
        entry_s = time.perf_counter() - t_e
        print(f"[main] generate_demos batch={ENTRY_B} max_steps={ENTRY_STEPS} ({entry_s:.1f} s): "
              f"{json.dumps(estats)}")
        want = {"batch": int, "max_steps": int, "seed": int, "success_rate": float,
                "connect_histogram": list, "mean_num_connected": float,
                "first_success_steps": list, "furniture_name": str, "n_demos_saved": int}
        if {k: type(v) for k, v in estats.items()} != want:
            fail(f"generate_demos: stats schema {sorted(estats)} differs")
        if sum(estats["connect_histogram"]) != ENTRY_B or estats["max_steps"] != ENTRY_STEPS:
            fail("generate_demos: the histogram or step count is wrong")
        if edemos:
            files = sorted(os.listdir(demo_dir))
            d0 = load_demo(os.path.join(demo_dir, files[0]))
            with TrajStore(store, "r") as ts:
                a0, r0, _ = ts.read(0)
                n_store = len(ts)
            ok = (len(files) == len(edemos) == n_store and len(d0["obs"]) == len(d0["actions"]) + 1
                  and np.array_equal(a0, edemos[0]["actions"]))
            print(f"[main] generate_demos: {len(files)} demo pickles and {n_store} store records read "
                  f"back")
            if not ok:
                fail("generate_demos: the saved demos do not read back")
        elif os.path.exists(store) or (os.path.isdir(demo_dir) and os.listdir(demo_dir)):
            fail("generate_demos: files written without a successful demo")

    # -- 3i. the iLQR planner, and the arm form of its dynamics ---------------------------
    stamp("iLQR planner")
    il, il_env, il_recorded = drive_ilqr(dev)
    want_il = il["horizon"] + il["iterations"] * il["horizon"]
    med_il = float(np.median(il["solve_s"]))
    print(f"[main] iLQR on the cursor, horizon {il['horizon']} x {il['iterations']} iterations, "
          f"{il['alphas']} step sizes, n = {il['n']}, m = {il['m']}, {ILQR_SUBSTEPS} substeps a step: "
          f"free-part kernel launches per solve {il['launches']} (expected {want_il}); cold solve "
          f"cost {il['cold_cost']:.5g} from {il['cold_cost0']:.5g} (zero controls); warm-started "
          f"solves cost {[round(c, 6) for c in il['cost']]} from {[round(c, 6) for c in il['cost0']]}; "
          f"held part {il['distance_m'][0]:.4f} -> {il['distance_m'][1]:.4f} m from its target")
    print(f"[time] iLQR solve ({ILQR_SOLVES} solves): median {med_il:.3f} s (spread "
          f"{min(il['solve_s']):.3f}-{max(il['solve_s']):.3f}), warm-up solve {il['warm_up_s']:.3f} s; "
          f"one iteration's steps: initial rollout {il['initial_rollout_ms']:.1f} ms, linearize "
          f"{il['linearize_ms']:.1f} ms, backward (parallel) {il['backward_ms']:.1f} ms, line search "
          f"{il['line_search_ms']:.1f} ms | {card}")
    if il["launches"] != [want_il] * ILQR_SOLVES:
        fail(f"iLQR launch counts {il['launches']} != {want_il}")
    if not (il["finite"] and il["cold_cost"] < il["cold_cost0"]
            and all(c <= c0 for c, c0 in zip(il["cost"], il["cost0"]))
            and il["distance_m"][1] < il["distance_m"][0]):
        fail("iLQR: the plan is not finite, or does not beat the zero-control rollout")
    # the free-part kernel at the planner's own inputs: SimConfig(solver_iters=8),
    # the held group at gscale 0, one env (initial rollout) and len(alphas)
    # envs (line search), at the path's n = 10 and at n = 5
    H = il["horizon"]
    for k, (parts, group, gscale, n) in enumerate(il_recorded):
        where = ("initial rollout", "line search")[k // 3]
        t = (0, H // 2, H - 1)[k % 3]
        hold(il_env, parts, group, gscale, f"iLQR {where} t={t} (B={group.shape[0]}, held gscale "
             f"{gscale.min().item():g})", checks=((5, 1e-4), (n, 1e-3)))

    lane_il, lane_env, lane_recorded = drive_ilqr(dev, backend="lane", iterations=1, solves=0)
    want_lane_il = 2 * H * ILQR_SUBSTEPS       # one iteration; one lane-solver launch a substep
    print(f"[main] iLQR on the lane backend (the same problem, one solve of 1 iteration): lane-solver "
          f"launches {lane_il['warm_up_launches']} (expected {want_lane_il}), cost "
          f"{lane_il['cold_cost']:.5g} from {lane_il['cold_cost0']:.5g}; {lane_il['warm_up_s']:.3f} s, "
          f"one iteration's line search {lane_il['line_search_ms']:.1f} ms | {card}")
    if lane_il["warm_up_launches"] != want_lane_il or not lane_il["cold_cost"] < lane_il["cold_cost0"]:
        fail("iLQR lane backend: launch count or cost wrong")
    # the lane solver at the planner's own inputs: the first substep of each
    # recorded step, at the configuration's 8 sweeps
    lphys = lane_env.physics
    any_live = False
    for k, (parts, group, gscale, n) in enumerate(lane_recorded):
        args = lphys.solver_args(parts, group, gscale)
        c = args[0]
        live = bool((c.mask & (c.depth > -args[10])).any())
        any_live |= live
        where = ("initial rollout", "line search")[k // 3]
        t = (0, H // 2, H - 1)[k % 3]
        hold_lane(f"iLQR {where} t={t}", lphys.lane_tables, args, exact=not live, sweeps=(args[8],))
    if not any_live:
        fail("iLQR lane backend: no recorded step has an active contact lane")

    stamp("iLQR arm dynamics")
    ad = drive_arm_dynamics(dev)
    fd_bound = max(2 * ad["fd_gap_plain"], 1e-3)
    print(f"[main] iLQR arm dynamics (Sawyer impedance, {ad['substeps']} substeps, {ad['rows']} rows): "
          f"arm kernel launches {ad['launches']} (expected 1); forward, kernel vs plain max|diff| "
          f"{ad['forward_max_abs_err']:.3g} (bound 5e-4); the Function's Jacobian J (max |J_x| "
          f"{ad['jacobian_max_abs']:.4g}) along {ARM_FD_DIRS} random directions d in (x, u) vs central "
          f"differences of the kernel forward at eps {ad['fd_eps']:g} (of {ARM_FD_EPS}, the plain "
          f"forward's closest: its gaps {ad['fd_gaps_plain']}): max|J d - fd| / max|J d| "
          f"{ad['fd_gap']:.3g} (bound {fd_bound:.3g}: twice the plain forward's own {ad['fd_gap_plain']:.3g}, "
          f"or 1e-3), max |J d| {ad['jd_max_abs']:.4g}")
    if ad["launches"] != 1 or not ad["finite"]:
        fail(f"arm dynamics: {ad['launches']} arm kernel launches, finite {ad['finite']}")
    if not (ad["forward_max_abs_err"] <= 5e-4 and ad["fd_gap"] <= fd_bound):
        fail("arm dynamics: the kernel forward disagrees with the plain version, or the Function's "
             "Jacobian with the kernel's central differences")

    # -- 3j. the RL stack and its entry point ---------------------------------------------
    stamp("RL stack")
    rr = drive_rl(dev)
    T2 = 2 * 64                          # PPOConfig().rollout_len steps, 2 launches each

    def resets_ok(got, base):
        return got >= base and (got - base) % 10 == 0

    ppo_s = [it["s"] for it in rr["ppo_iters"]]
    ppo_launch = [it["launches"] for it in rr["ppo_iters"]]
    print(f"[main] PPO (PPOConfig(): 256 envs x 64 steps, 3 epochs x 4 minibatches, hidden 256x256): "
          f"set-up launches {rr['ppo_setup_launches']} (expected 20: the probe's and the lanes' resets); "
          f"{PPO_ITERS} iterations, free-part kernel launches {ppo_launch} (expected {T2} + 10 a step "
          f"with a done), done fractions {[it['done_frac'] for it in rr['ppo_iters']]}, losses "
          f"{[round(it['loss'], 5) for it in rr['ppo_iters']]}")
    print(f"[time] PPO iteration: {[round(x, 3) for x in ppo_s]} s, "
          f"{rr['ppo_env_steps'] / min(ppo_s):.1f} env steps/s at the faster; rollout "
          f"{rr['ppo_rollout_ms']:.1f} ms, update {rr['ppo_update_ms']:.1f} ms | {card}")
    if rr["ppo_setup_launches"] != 20 or not all(resets_ok(n, T2) for n in ppo_launch) \
            or not all(it["finite"] for it in rr["ppo_iters"]):
        fail("PPO: launch counts or metrics wrong")
    sac = rr["sac"]
    print(f"[main] SAC (SACConfig(): 64 envs) {sac['iters']} iterations ({sac['warm_up_iters']} of warm-up): "
          f"free-part kernel launches {sac['launches']} (expected {2 * SAC_ITERS} + 10 a step with a done), "
          f"buffer {sac['buffer_size']}, q_loss {sac['q_loss']:.4g}, alpha {sac['alpha']:.5f}; "
          f"ms an iteration: warm-up {sac['warm_up_ms_median']:.1f}, with an update "
          f"{sac['update_iter_ms_median']:.1f} (medians) | {card}")
    if not (resets_ok(sac["launches"], 2 * SAC_ITERS) and sac["finite"]
            and sac["buffer_size"] == SAC_ITERS * 64 and sac["warm_up_iters"] == 16):
        fail("SAC: launch counts, buffer or metrics wrong")
    ga = rr["gail"]
    print(f"[main] GAIL: one iteration (2 discriminator updates, then PPO on its reward) {ga['s']:.3f} s, "
          f"free-part kernel launches {ga['launches']} (expected {T2} + resets), discriminator accuracy "
          f"{ga['disc_acc']:.3f}, reward per step {ga['reward_per_step']:.4f}")
    if not (resets_ok(ga["launches"], T2) and ga["finite"] and ga["reward_per_step"] > 0):
        fail("GAIL: launch counts or metrics wrong")
    bcr = rr["bc"]
    print(f"[main] BC on the committed demos ({bcr['demos']} demos, {bcr['samples']} samples): mse by epoch "
          f"{[round(x, 5) for x in bcr['mse']]}, s an epoch {[round(x, 3) for x in bcr['epoch_s']]}")
    if not (bcr["mse"][-1] < bcr["mse"][0] and bcr["pred_shape"][0] == 64):
        fail("BC: the loss did not decrease")
    ev = rr["eval"]
    want_ev = 10 + 2 * EVAL_STEPS
    print(f"[main] make_evaluate {EVAL_EPISODES} episodes x {EVAL_STEPS} steps: {ev['s']:.3f} s, "
          f"free-part kernel launches {ev['launches']} (expected {want_ev}), success rate "
          f"{ev['success_rate']:.3f}, mean episode length {ev['mean_episode_len']:.1f}")
    if ev["launches"] != want_ev or not np.isfinite(ev["mean_reward"]):
        fail("evaluate: launch count or metrics wrong")
    print(f"[main] checkpoint round trip of the card's PPO state ({rr['checkpoint_on']}): bit-exact "
          f"{rr['checkpoint_bit_exact']}")
    if not rr["checkpoint_bit_exact"] or not rr["checkpoint_on"].startswith("cuda"):
        fail("checkpoint: the card's state did not come back bit for bit")
    tr = rr["train_rl"]
    want_tr = 20 + TRAIN_RL_ITERS * T2 + want_ev
    print(f"[main] python -m furniture_tpu_torch.tools.train_rl --algo ppo --iters {TRAIN_RL_ITERS} "
          f"({tr['num_envs']} envs x {tr['rollout_len']} steps, eval {tr['eval_episodes']} x "
          f"{tr['eval_max_steps']}): {tr['s']:.1f} s, free-part kernel launches {tr['launches']} "
          f"(expected {want_tr} + 10 a step with a done), metrics lines {tr['metric_lines']}, "
          f"result {json.dumps(tr['result'])} | {card}")
    if not (resets_ok(tr["launches"], want_tr) and tr["metric_lines"] == [0, 1, "eval"]
            and tr["result"]["device"].startswith("cuda")):
        fail("train_rl: launch count, metrics or result wrong")
    rl_launches = {"ilqr_per_solve": il["launches"], "ppo_setup": rr["ppo_setup_launches"],
                   "ppo_iterations": ppo_launch, "sac": sac["launches"], "gail": ga["launches"],
                   "evaluate": ev["launches"], "train_rl": tr["launches"]}

    # -- 3k. the renderer: chunked against generic, then the render-on rollouts ------------
    stamp("renderer")
    rd = drive_render(dev)
    for name, c in rd["check"].items():
        print(f"[main] render {name} B={RENDER_CHECK[0]} {RENDER_CHECK[1]}x{RENDER_CHECK[1]}: chunked vs "
              f"generic seg identical {c['seg_equal']}, rgb max|diff| {c['rgb_max_abs_err']:.3g} (bound "
              f"1e-5), seg ids {c['ids']}")
        if not (c["seg_equal"] and c["rgb_max_abs_err"] <= 1e-5 and c["depth_finite_on_hits"]
                and c["depth_inf_elsewhere"] and -2 in c["ids"] and max(c["ids"]) >= 0):
            fail(f"render {name}: the chunked path disagrees with the generic one, or depth/ids wrong")
    render_launches = {}
    for name, nb, side in RENDER_RUNS:
        run = rd["runs"][name]
        steps = RENDER_HORIZON * RENDER_ROUNDS
        arm = name.startswith("sawyer")
        want = steps if arm else 2 * steps
        render_launches[name] = (run["launches"], run["free_launches"])
        walls = sorted(r["s"] for r in run["rounds"])
        step_ms = sorted(r["step_ms"] for r in run["rounds"])
        ren_ms = sorted(r["render_ms"] for r in run["rounds"])
        print(f"[main] render rollout {name}: B={nb}, {side}x{side}, {steps} steps, "
              f"{'arm' if arm else 'free-part'} kernel launches {run['launches']} (expected {want})"
              + (f", free-part kernel launches {run['free_launches']} (expected 0)" if arm else "")
              + f", frames {run['rgb_shape']} finite {run['finite']}")
        print(f"[time] render rollout {name}: {nb * RENDER_HORIZON / walls[1]:.1f} env steps/s with a "
              f"render every step (median of {RENDER_ROUNDS} rounds of {RENDER_HORIZON} steps; rounds "
              f"{[round(nb * RENDER_HORIZON / w, 1) for w in walls]}); step {step_ms[1]:.3f} ms "
              f"(rounds {[round(x, 3) for x in step_ms]}) against render {ren_ms[1]:.3f} ms (rounds "
              f"{[round(x, 3) for x in ren_ms]}); peak memory {run['peak_bytes'] / 2**30:.3f} GiB "
              f"({run['held_bytes'] / 2**30:.3f} GiB held before the rollout) | {card}")
        if run["launches"] != want or (arm and run["free_launches"] != 0) or not run["finite"] \
                or run["rgb_shape"] != [nb, side, side, 3]:
            fail(f"render rollout {name}: launch counts or frames wrong")
        # the rollout's kernel at its own inputs: one more step of it, recorded
        hold_recorded(rd["envs"]["sawyer" if arm else "cursor"], run["recorded"],
                      f"render rollout {name} step")

    # -- 3l. the single-env wrapper --------------------------------------------------------
    stamp("single-env wrapper")
    wr = drive_wrapper(dev)
    for name, w in wr.items():
        arm = "Sawyer" in name
        want = w["per_step"] * WRAPPER_STEPS if arm else 10 + 2 * WRAPPER_STEPS
        print(f"[main] make_env({name!r}, camera, depth and segmentation obs at "
              f"{WRAPPER_SIDE}x{WRAPPER_SIDE}) on {w['device']}: reset + {WRAPPER_STEPS} steps "
              f"{w['s']:.3f} s, {'arm' if arm else 'free-part'} kernel launches {w['launches']} "
              f"(expected {want})" + (f", free-part kernel launches {w['free_launches']} (expected 10)"
                                      if arm else "")
              + f"; shapes {w['shapes_ok']}, render modes match the obs {w['modes_match_obs']}, "
              f"unknown mode raises {w['bad_mode_raises']}")
        if not (w["device"].startswith("cuda") and w["shapes_ok"] and w["modes_match_obs"]
                and w["bad_mode_raises"] and w["reward_finite"] and w["launches"] == want
                and (not arm or w["free_launches"] == 10)):
            fail(f"wrapper {name}: wrong device, shapes, modes or launch counts")
        hold_recorded(w["env"], w["recorded"], f"make_env({name!r}) last step")

    # -- 3m. the multi-device layer -----------------------------------------------------------
    stamp("multi-device layer")
    ms = drive_mesh(dev)
    w1 = ms["ws1"]
    print(f"[main] sharded MPPI 64 x 256, world size 1 ({w1['backend']}): max|mean - make_mppi's| "
          f"{w1['err']:.3g} (bound 1e-5), best cost {w1['best_cost']:.6f} vs {w1['plain_best_cost']:.6f}, "
          f"free-part kernel launches {ms['ws1_launches']} (expected 128)")
    print(f"[time] MPPI 64 x 256 plans/s, in turns: make_mppi {1 / w1['plain_s'][0]:.3f}, sharded (world "
          f"size 1) {1 / w1['sharded_s'][0]:.3f}, {1 / w1['sharded_s'][1]:.3f}, make_mppi "
          f"{1 / w1['plain_s'][1]:.3f} | {card}")
    if not (w1["backend"] == "nccl" and w1["err"] <= 1e-5 and ms["ws1_launches"] == 128
            and abs(w1["best_cost"] - w1["plain_best_cost"]) <= 1e-5 * max(1.0, abs(w1["plain_best_cost"]))):
        fail("sharded MPPI at world size 1 disagrees with make_mppi, or its launch count is wrong")
    for r in ms["ws2"]:
        print(f"[main] mesh rank {r['rank']} of {MESH_WORLD} on {r['device']} (gloo): sharded MPPI "
              f"max|mean - make_mppi's| {r['plan_err']:.3g} (bound 1e-5), {r['plan_launches']} launches "
              f"(expected 128), {r['plan_s']:.3f} s; PPO iteration at PPOConfig() on {r['ppo_lanes']} lanes: "
              f"{r['ppo_launches']} launches (expected 128 + 10 a step with a done), {r['ppo_s']:.3f} s, loss "
              f"{r['ppo_loss']:.5f}, networks identical on every rank (MIN and MAX all-reduce) "
              f"{r['params_identical']}")
        if not (r["plan_err"] <= 1e-5 and r["plan_launches"] == 128 and r["params_identical"]
                and r["ppo_lanes"] == 128 and resets_ok(r["ppo_launches"], 128)
                and np.isfinite(r["ppo_loss"])):
            fail(f"mesh rank {r['rank']}: plan, launch counts or replicated networks wrong")
    if len({r["params_sum"] for r in ms["ws2"]}) != 1 or \
            len({r["ppo_reward_per_step"] for r in ms["ws2"]}) != 1:
        fail("mesh: the ranks disagree on the networks or the reduced metrics")
    print(f"[time] world size {MESH_WORLD} on one card: the spawn, both ranks' set-up, plan and PPO "
          f"iteration {ms['ws2_s']:.1f} s | {card}")
    # kernel 1 at the mesh paths' own inputs: the last step of a sharded plan
    # at world size 1 (all 256 rows) and of rank 0's (128 rows) under the
    # plan's SimConfig, and of rank 0's PPO rollout (128 lanes)
    hold_recorded(ms["env"], ms["recorded"]["ws1"], "sharded MPPI world size 1 last step")
    hold_recorded(ms["env"], ms["recorded"]["ws2_mppi"], f"sharded MPPI rank 0 of {MESH_WORLD} last step")
    hold_recorded(CursorEnv(EnvConfig(), device=dev), ms["recorded"]["ws2_ppo"],
                  f"sharded PPO rank 0 of {MESH_WORLD} rollout's last step")
    mesh_launches = {"mppi_ws1": ms["ws1_launches"],
                     "mppi_ws2_ranks": [r["plan_launches"] for r in ms["ws2"]],
                     "ppo_ws2_ranks": [r["ppo_launches"] for r in ms["ws2"]]}
    render_mesh_free = (render_launches["cursor_render500"][0] + render_launches["sawyer_impedance_render200"][1]
                   + wr["IKEACursor-v0"]["launches"] + wr["IKEASawyer-v0"]["free_launches"]
                   + ms["ws1_launches"] + sum(mesh_launches["mppi_ws2_ranks"])
                   + sum(mesh_launches["ppo_ws2_ranks"]))
    render_mesh_arm = render_launches["sawyer_impedance_render200"][0] + wr["IKEASawyer-v0"]["launches"]

    # -- 3n. the whole registry on the card ------------------------------------------------------
    stamp("all-furniture sweep")
    t_phase = time.perf_counter()
    sweep = drive_sweep(dev)
    for r in sweep:
        want_free = 10 + (2 * SWEEP_STEPS if r["agent"] == "Cursor" else 0)
        want_arm = SWEEP_STEPS if r["agent"] != "Cursor" else 0
        kern = " ".join(f"{k}: {v}" for k, v in sorted(r["routes"].items()))
        print(f"[sweep] {r['agent']} {r['name']}: P={r['P']} K={r['K']}"
              + (f" (kernel 2 K={r['arm_K']})" if r["arm_K"] else "")
              + f" | {kern} | build {r['build_s']:.2f} s, reset {r['reset_ms']:.1f} ms, step "
              f"{r['step_ms']:.1f} ms (B={SWEEP_B}) | launches free {r['free_launches']} arm "
              f"{r['arm_launches']} | " + "; ".join(
                  f"{what} n={h['n']}: {h['err']:.3g}" + (
                      "" if h["spread"] is None else
                      f" (over {h['tol']:.3g} in {h['envs_over']} of the {h['envs_counted']} envs whose own "
                      f"spread is within it, median {h['median']:.3g}; {h['chaotic_envs']} envs chaotic, "
                      f"{h['tie_envs']} with a lane on the contact threshold; the env nearest its bound, "
                      f"{h['env']}: {h['env_err']:.3g} against its own spread {h['env_spread']:.3g})"
                  ) if "n_touch" not in h else f"{what} n={h['n']}: {h['err']:.3g} ({arm_note(h)})"
                  for what, h in r["holds"]), flush=True)
        if r["problem"] or not (r["reward_finite"] and r["obs_finite"]):
            fail(f"sweep {r['agent']} {r['name']}: {r['problem'] or 'reward or observation not finite'}")
        if (r["free_launches"], r["arm_launches"]) != (want_free, want_arm):
            fail(f"sweep {r['agent']} {r['name']}: launches {(r['free_launches'], r['arm_launches'])}, "
                 f"expected {(want_free, want_arm)}")
        if r["agent"] != "Cursor" and r["recorded"] != SWEEP_STEPS:
            fail(f"sweep {r['agent']} {r['name']}: {r['recorded']} arm calls recorded, expected {SWEEP_STEPS}")
        for what, h in r["holds"]:
            if h["problem"]:
                fail(f"sweep {r['agent']} {r['name']}: {what} n={h['n']}: {h['problem']}")
    free_holds = [h for r in sweep for _, h in r["holds"] if "n_touch" not in h]
    sweep_worst = max((h["err"] for h in free_holds if h["spread"] is None), default=0.0)
    sweep_arm_worst = max((h["median"] for r in sweep for _, h in r["holds"] if "n_touch" in h), default=0.0)
    sweep_free = sum(r["free_launches"] for r in sweep)
    sweep_arm = sum(r["arm_launches"] for r in sweep)
    cursor_rows = [r for r in sweep if r["agent"] == "Cursor"]
    route_counts = {}
    for r in cursor_rows:
        for k, v in r["routes"].items():
            route_counts.setdefault(k, {}).setdefault(v, 0)
            route_counts[k][v] += 1
    chaotic = sorted({r["name"] for r in sweep for _, h in r["holds"] if h.get("chaotic_envs")})
    tied = sorted({r["name"] for r in sweep for _, h in r["holds"] if h.get("tie_envs")})
    print(f"[main] sweep: {len(cursor_rows)} furniture models as cursor envs and {len(sweep) - len(cursor_rows)} "
          f"as Sawyer impedance, B={SWEEP_B}, SimConfig({SWEEP_SIM}): all live; routes of the cursor models "
          f"{route_counts}; kernel 1 held on every model, worst {sweep_worst:.3g} where every env is inside "
          f"1e-4 (models with an env where the plain version's own spread exceeds 1e-4, held there to 10x "
          f"it: {chaotic}; of them with a lane on the contact threshold: {tied}); kernel 2 held at each "
          f"arm step's inputs, worst median {sweep_arm_worst:.3g}; launches free {sweep_free} arm {sweep_arm}")
    steps_ms = sorted(r["step_ms"] for r in cursor_rows)
    resets_ms = sorted(r["reset_ms"] for r in cursor_rows)
    print(f"[time] sweep cursor models B={SWEEP_B}: step ms median {steps_ms[len(steps_ms) // 2]:.1f} "
          f"(range {steps_ms[0]:.1f}-{steps_ms[-1]:.1f}), reset ms median {resets_ms[len(resets_ms) // 2]:.1f} "
          f"(range {resets_ms[0]:.1f}-{resets_ms[-1]:.1f}; first call of each model) | {card}")
    lane_routes = time_lane_routes(dev)
    for name, c in lane_routes.items():
        print(f"[time] lane solver route {c['route']}: {name} B={MAIN_B} K={c['K']} P={c['P']} "
              f"sweeps={c['sweeps']} ({c['lanes_with_contact']} lanes with a contact, "
              f"{c['lanes_with_mask_set']} with the mask set): {c['ms'][0]:.4f}, {c['ms'][1]:.4f} ms/launch "
              f"(in turns); bound {c['bound_ms']:.5f} ms ({c['bound_by']}), kernel at "
              f"{c['bound_ms'] / min(c['ms']):.4f} of it | {card}")
    sweep_s = time.perf_counter() - t_phase
    print(f"[clock] all-furniture sweep phase: {sweep_s:.1f} s", flush=True)

    # -- 3o. the command-line tools -----------------------------------------------------------
    stamp("command-line tools")
    t_phase = time.perf_counter()
    tools = drive_tools(dev)
    t = tools["run_demo_state_replay"]
    rd_state = json.loads(t["stdout"].strip().splitlines()[-1])
    t2 = tools["run_demo_actions"]
    rd_act = json.loads(t2["stdout"].strip().splitlines()[-1])
    print(f"[tools] run_demo --state_replay {TOOL_DEMO}: {rd_state} in {t['s']:.1f} s, launches free "
          f"{t['free_launches']} arm {t['arm_launches']}; action replay of its first {TOOL_REPLAY_ACTIONS} "
          f"actions: {rd_act} in {t2['s']:.1f} s, launches free {t2['free_launches']} arm {t2['arm_launches']}")
    if not (rd_state == {"steps": 1570, "num_connected": 4, "mode": "state_replay"}
            and (t["free_launches"], t["arm_launches"]) == (10, 0)):
        fail(f"run_demo --state_replay: {rd_state}, launches {(t['free_launches'], t['arm_launches'])}")
    if not (set(rd_act) == {"steps", "total_reward", "num_connected", "final_object_ob_l2"}
            and rd_act["steps"] == TOOL_REPLAY_ACTIONS and np.isfinite(rd_act["total_reward"])
            and np.isfinite(rd_act["final_object_ob_l2"])
            and (t2["free_launches"], t2["arm_launches"]) == (10, 3 * TOOL_REPLAY_ACTIONS)):
        fail(f"run_demo action replay: {rd_act}, launches {(t2['free_launches'], t2['arm_launches'])}")
    t = tools["run_manual"]
    n_keys = t["stdout"].count("key=")
    shot = [l for l in t["stdout"].splitlines() if l.startswith("screenshot -> ")]
    print(f"[tools] run_manual --script {TOOL_SCRIPT!r}: {n_keys} steps, {shot}, files written "
          f"{tools['files']}, launches free {t['free_launches']} in {t['s']:.1f} s")
    if not (n_keys == 5 and len(shot) == 1 and os.path.basename(shot[0][14:]) in tools["files"]
            and tools["files"][os.path.basename(shot[0][14:])] > 0 and t["free_launches"] == 10 + 2 * 5):
        fail("run_manual: steps, screenshot or launches wrong")
    t, bc = tools["eval_bc"], tools["bc_eval_json"]
    print(f"[tools] eval_bc --epochs 5 --episodes 8 --steps 20: {bc} in {t['s']:.1f} s, launches free "
          f"{t['free_launches']} arm {t['arm_launches']}")
    want_keys = {"n_demos", "n_transitions", "bc_final_mse", "episodes", "max_steps", "num_connects",
                 "success_rate", "n_success", "success_steps", "pool_offset", "criterion",
                 "furniture_name", "seed"}
    if not (set(bc) == want_keys and bc["n_demos"] == 12 and bc["episodes"] == 8
            and np.isfinite(bc["bc_final_mse"]) and (t["free_launches"], t["arm_launches"]) == (10, 60)):
        fail(f"eval_bc: output or launches wrong ({t['free_launches']}, {t['arm_launches']})")
    t = tools["fps"]
    for row in t["ret"]:
        print(f"[time] fps {row} | {card}")
    want_fps = (10 * 5 + 2 * 40, 3 * 40 * 2 + 40 * 2)
    print(f"[tools] fps --all: {len(t['ret'])} rows in {t['s']:.1f} s, launches free {t['free_launches']} "
          f"arm {t['arm_launches']} (expected {want_fps})")
    if not (len(t["ret"]) == 5 and all(r["steps_per_s"] > 0 and r["batch"] == 512 for r in t["ret"])
            and (t["free_launches"], t["arm_launches"]) == want_fps):
        fail("fps --all: rows or launches wrong")
    t = tools["resize"]
    print(f"[tools] resize table_lack_0825 --scale 1.3: {t['ret']} (a file in the real asset directory: "
          f"{t['in_real_assets']}); {t['stdout'].count('(x2.20)')} part masses x2.20 in {t['s']:.1f} s")
    if t["in_real_assets"] or t["stdout"].count("(x2.20)") != 5 or not str(t["ret"]).endswith(
            os.path.join("assets", "furniture", "table_lack_0825_x1p3.json")):
        fail("resize: wrong output or wrote into the real asset directory")
    t, pg = tools["profile_gen"], tools["profile_gen"]["ret"]
    print(f"[tools] profile_gen --batch {TOOL_GEN[0]} --max_steps {TOOL_GEN[1]}: funnel {pg['funnel']}, "
          f"connect histogram {pg['connect_histogram']} in {t['s']:.1f} s, launches free "
          f"{t['free_launches']} arm {t['arm_launches']}")
    if not (pg["batch"] == TOOL_GEN[0] and pg["max_steps"] == TOOL_GEN[1] and pg["funnel"]["lanes"] == TOOL_GEN[0]
            and (t["free_launches"], t["arm_launches"]) == (10, 3 * TOOL_GEN[1])):
        fail("profile_gen: output or launches wrong")
    t, pc = tools["profile_cursor"], tools["profile_cursor"]["ret"]
    print(f"[time] profile_cursor B={pc['batch']} H={pc['horizon']}: full {pc['full_ms_per_batchstep']:.3f} "
          f"ms/step ({pc['full_steps_per_s']:.1f} env steps/s), kernel {pc['kernel_ms_per_batchstep']:.3f}, "
          f"kernel1 {pc['kernel1_ms_per_batchstep']:.3f}, glue {pc['glue_ms_per_batchstep']:.3f} "
          f"({pc['glue_steps_per_s']:.1f} env steps/s); {t['s']:.1f} s, launches free {t['free_launches']} "
          f"(expected 490) | {card}")
    if not (pc["device"] == torch.cuda.get_device_name(0) and t["free_launches"] == 10 + 6 * 20 * 4
            and all(pc[k] > 0 for k in ("full_ms_per_batchstep", "kernel_ms_per_batchstep",
                                        "kernel1_ms_per_batchstep", "glue_ms_per_batchstep"))):
        fail("profile_cursor: rows or launches wrong")
    t, pi = tools["profile_ilqr"], tools["profile_ilqr"]["ret"]
    # reset; 4 solves of 64 + 5 x 64; 7 rollouts (6 timed, 1 for the line
    # search's reference); 6 line searches of 64 steps at B = 5
    want_il = 10 + 4 * 384 + 7 * 64 + 6 * 64
    print(f"[time] profile_ilqr H={pi['horizon']} x {pi['iterations']} iterations: solve {pi['full_solve_s']:.3f} s, "
          f"line search (5 alphas) {pi['linesearch5_s'] * 1e3:.1f} ms, linearize {pi['linearize_s'] * 1e3:.1f} ms, "
          f"backward {pi['backward_s'] * 1e3:.2f} ms, rollout64 {pi['rollout64_s'] * 1e3:.1f} ms, accounted "
          f"{pi['accounted_s']:.3f} s; {t['s']:.1f} s, launches free {t['free_launches']} (expected {want_il}) "
          f"| {card}")
    if not (pi["device"] == torch.cuda.get_device_name(0) and t["free_launches"] == want_il
            and all(pi[k] > 0 for k in ("full_solve_s", "linesearch5_s", "linearize_s", "backward_s",
                                        "rollout64_s"))):
        fail("profile_ilqr: rows or launches wrong")
    tool_keys = [k for k in tools if isinstance(tools[k], dict) and "free_launches" in tools[k]]
    # each kernel a tool launched, held at the inputs of its last call there
    for k in tool_keys:
        t = tools[k]
        for c, n_launch in (("MegaPhysics", t["free_launches"]), ("ArmMegaPhysics", t["arm_launches"])):
            if n_launch and not any(what.startswith(c + " ") for what, _ in t["holds"]):
                fail(f"tool {k}: {c}'s kernel launched {n_launch} times but no call of it was recorded")
        for what, h in t["holds"]:
            print(hold_line(f"tool {k}: {what}", h), flush=True)
            if h["problem"]:
                fail(f"tool {k}: {what} n={h['n']}: {h['problem']}")
    tool_holds = [h for k in tool_keys for _, h in tools[k]["holds"]]
    tools_free_worst = max((h["median"] for h in tool_holds if "n_touch" not in h), default=0.0)
    tools_arm_worst = max((h["median"] for h in tool_holds if "n_touch" in h), default=0.0)
    tools_free = sum(tools[k]["free_launches"] for k in tool_keys)
    tools_arm = sum(tools[k]["arm_launches"] for k in tool_keys)
    tools_s = time.perf_counter() - t_phase
    print(f"[clock] command-line tools phase: {tools_s:.1f} s ("
          + ", ".join(f"{k} {tools[k]['s']:.1f} + holds {tools[k]['hold_s']:.1f}" for k in tool_keys) + ")",
          flush=True)

    # -- 4. times ---------------------------------------------------------------
    stamp("cursor times")
    env = vec.env
    gen.manual_seed(3)
    state = env.reset_batch(MAIN_B, gen)
    for a in actions[:3]:
        state, *_ = env.step_batch(state, a)  # warm-up
    holder = [state]

    def step_once(it=iter(range(10**9))):
        holder[0] = env.step_batch(holder[0], actions[next(it) % STEPS])[0]

    (step_ms, step_host_ms), step_rounds = median_round(step_once, STEPS)
    steps_per_s = MAIN_B / (step_ms / 1e3)
    n = env.config.n_substeps
    parts = holder[0].parts
    group, gscale = holder[0].group.contiguous(), torch.ones((MAIN_B, P), device=dev)
    phys = env.physics
    phys.kernel_substeps(parts, group, gscale, n)  # warm-up
    kernel_ms = cuda_ms(lambda: phys.kernel_substeps(parts, group, gscale, n), 10)
    phys.plain_substeps(parts, group, gscale, n)  # warm-up
    plain_ms = cuda_ms(lambda: phys.plain_substeps(parts, group, gscale, n), 2)
    ops = phys.fp32_ops_per_env(n) * MAIN_B
    in_bytes = MAIN_B * P * 4 * (3 + 4 + 3 + 3 + 1 + 1)
    out_bytes = MAIN_B * P * 4 * (3 + 4 + 3 + 3)
    table_bytes = sum(t.numel() * t.element_size() for t in phys._dev.values())
    nbytes = in_bytes + out_bytes + table_bytes
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    scale = min(1.0, watts / FULL_POWER_W)
    print(f"[time] step_batch B={MAIN_B}: {step_ms:.3f} ms/step, {steps_per_s:.1f} env steps/s (the "
          f"median of three rounds of {STEPS} steps: {step_rounds} ms); the host took "
          f"{step_host_ms:.3f} ms a step to enqueue it")
    print(f"[time] kernel n={n} B={MAIN_B}: {kernel_ms:.4f} ms/launch; plain version "
          f"{plain_ms:.3f} ms; kernel share of a step {kernel_ms / step_ms:.3f}")
    print(f"[time] bound: {ops:.4g} FP32 ops -> {t_ops:.4f} ms at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s "
          f"({t_ops / scale:.4f} ms scaled to {watts:g} W); {nbytes} B -> {t_bytes:.5f} ms at "
          f"{PEAK_HBM_BYTES / 1e12:g} TB/s; kernel at {bound_ms / kernel_ms:.4f} of its bound")
    print("[time] library_ms: null (no single PyTorch call computes this function)")
    clocks = phys.phase_clocks(parts, group, gscale, n)
    floor_ms, resident, barriers, trip_us = latency_floor(phys, clocks, sm_count)
    print(f"[time] kernel latency floor: {barriers} block barriers counted in a launch of {n} substeps "
          f"({barriers / n:g} a substep) x "
          f"{-(-MAIN_B // (resident * sm_count))} waves ({resident} blocks an SM x {sm_count} SMs) x "
          f"{trip_us:.4f} us a bare barrier at that occupancy = {floor_ms:.4f} ms (bound "
          f"{bound_ms:.4f} ms, kernel {kernel_ms:.4f} ms, before its redesign {PREV_KERNEL_MS} ms)")
    shares, cycles = phase_shares(clocks, MEGA_PHASES, n)
    print("[time] kernel phases: " + ", ".join(f"{k} {v:.3f}" for k, v in zip(MEGA_PHASES, shares))
          + f" | {cycles:.0f} cycles a substep a block")
    # the same with parts welded: two recipe steps preassembled
    wenv = CursorEnv(EnvConfig(preassembled=(0, 1)), device=dev)
    gen.manual_seed(3)
    wstate = wenv.reset_batch(MAIN_B, gen)
    for a in actions[:3]:
        wstate, *_ = wenv.step_batch(wstate, a)
    wparts = PartState(*(t.contiguous() for t in wstate.parts))
    wgroup = wstate.group.contiguous()
    wenv.physics.kernel_substeps(wparts, wgroup, gscale, n)  # warm-up
    welded_ms = cuda_ms(lambda: wenv.physics.kernel_substeps(wparts, wgroup, gscale, n), 10)
    wshares, wcycles = phase_shares(wenv.physics.phase_clocks(wparts, wgroup, gscale, n),
                                    MEGA_PHASES, n)
    n_groups = wgroup[0].unique().numel()
    print(f"[time] kernel n={n} B={MAIN_B} welded (preassembled (0, 1), groups "
          f"{wgroup[0].tolist()}, {n_groups} groups of {P} parts): {welded_ms:.4f} ms/launch "
          f"beside {kernel_ms:.4f} ms with free parts")
    print("[time] kernel phases, welded: " + ", ".join(f"{k} {v:.3f}" for k, v in zip(MEGA_PHASES, wshares))
          + f" | {wcycles:.0f} cycles a substep a block")

    # -- 4b. arm times ----------------------------------------------------------
    stamp("arm times")
    arm_step = {}
    for control_type, nb in ARM_RUNS:
        avec, acts = arm_vecs[control_type]
        aenv = avec.env
        gen.manual_seed(3)
        astate = aenv.reset_batch(nb, gen)
        for a in acts[:2]:
            astate, *_ = aenv.step_batch(astate, a)  # warm-up
        aholder = [astate]

        def arm_step_once(it=iter(range(10**9)), aenv=aenv, acts=acts, aholder=aholder):
            aholder[0] = aenv.step_batch(aholder[0], acts[next(it) % STEPS])[0]

        (ms, host_ms), arm_rounds = median_round(arm_step_once, 10, 3 if control_type == "impedance" else 1)
        arm_step[control_type] = (ms, nb / (ms / 1e3), host_ms)
        print(f"[time] Sawyer {control_type} step_batch B={nb}: {ms:.3f} ms/step, "
              f"{nb / (ms / 1e3):.1f} env steps/s (rounds of 10 steps: {arm_rounds} ms); the host "
              f"took {host_ms:.3f} ms a step to enqueue it")
    avec, acts = arm_vecs["impedance"]
    aenv, aB = avec.env, ARM_RUNS[0][1]
    aph = aenv.physics
    astate = aenv.reset_batch(aB, gen)
    for a in acts[:2]:
        astate, *_ = aenv.step_batch(astate, a)
    ctrl = aenv._direct_ctrl(acts[2][:, :-1])
    an = aenv.config.n_substeps
    aargs = arm_inputs(aenv, astate, ctrl) + (an,)
    aph.kernel_control_step(*aargs)  # warm-up
    arm_kernel_ms = cuda_ms(lambda: aph.kernel_control_step(*aargs), 10)
    aph.plain_control_step(*aargs)  # warm-up
    arm_plain_ms = cuda_ms(lambda: aph.plain_control_step(*aargs), 2)
    dyn_ms = cuda_ms(lambda: K.joint_dyn_matrices(aenv.robot, astate.qpos, aenv.config.sim.timestep), 10)
    ik_vec, ik_acts = arm_vecs["ik"]
    ik_env, ik_B = ik_vec.env, ARM_RUNS[1][1]
    ik_state = ik_env.reset_batch(ik_B, gen)
    ik_ms = cuda_ms(lambda: ik_env._ik_prepare(ik_state, ik_acts[0]), 3)
    aP, NJ, NA = aenv._P, aenv.robot.nj, aenv.robot.na
    a_in = aB * 4 * (aP * (13 + 1 + 1) + 2 * NJ + NA + NJ + 2 * NJ * NJ)
    a_out = aB * (4 * (aP * 13 + 2 * NJ) + aph.NT)
    a_tables = sum(t.numel() * t.element_size() for t in aph._dev.values())
    a_bytes = a_in + a_out + a_tables
    a_ops = aph.fp32_ops_per_env(an) * aB
    a_t_ops = a_ops / PEAK_FP32_FLOPS * 1e3
    a_t_bytes = a_bytes / PEAK_HBM_BYTES * 1e3
    arm_bound_ms = max(a_t_ops, a_t_bytes)
    arm_bound_by = "operations" if a_t_ops >= a_t_bytes else "bytes"
    imp_ms = arm_step["impedance"][0]
    print(f"[time] arm kernel n={an} B={aB}: {arm_kernel_ms:.4f} ms/launch; plain version "
          f"{arm_plain_ms:.3f} ms; kernel share of an impedance step {arm_kernel_ms / imp_ms:.3f}; "
          f"joint_dyn_matrices {dyn_ms:.3f} ms; rest of the step "
          f"{imp_ms - arm_kernel_ms - dyn_ms:.3f} ms")
    print(f"[time] ik B={ik_B}: _ik_prepare (20 DLS iterations) {ik_ms:.3f} ms of the "
          f"{arm_step['ik'][0]:.3f} ms step")
    print(f"[time] arm bound: {a_ops:.4g} FP32 ops -> {a_t_ops:.4f} ms at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s "
          f"({a_t_ops / scale:.4f} ms scaled to {watts:g} W); {a_bytes} B -> {a_t_bytes:.5f} ms at "
          f"{PEAK_HBM_BYTES / 1e12:g} TB/s; kernel at {arm_bound_ms / arm_kernel_ms:.4f} of its bound")
    print("[time] arm library_ms: null (no single PyTorch call computes this function)")
    arm_clocks = aph.phase_clocks(*aargs)
    arm_floor_ms, arm_resident, arm_barriers, arm_trip_us = latency_floor(aph, arm_clocks, sm_count)
    print(f"[time] arm kernel latency floor: {arm_barriers} block barriers counted in a launch of {an} "
          f"substeps ({arm_barriers / an:g} a substep) x "
          f"{-(-aB // (arm_resident * sm_count))} waves ({arm_resident} block(s) an SM x {sm_count} SMs) x "
          f"{arm_trip_us:.4f} us a bare barrier at that occupancy = {arm_floor_ms:.4f} ms (bound "
          f"{arm_bound_ms:.4f} ms, kernel {arm_kernel_ms:.4f} ms, before its redesign "
          f"{PREV_ARM_KERNEL_MS} ms)")
    arm_shares, arm_cycles = phase_shares(arm_clocks, ARM_PHASES, an)
    print("[time] arm kernel phases: " + ", ".join(f"{k} {v:.3f}" for k, v in zip(ARM_PHASES, arm_shares))
          + f" | {arm_cycles:.0f} cycles a substep a block")

    # -- 4c. lane solver, lane path, planner and controller times ------------------
    stamp("lane, planner and controller times")
    gen.manual_seed(3)
    lstate = lenv.reset_batch(MAIN_B, gen)
    lstate = lenv.step_batch(lstate, actions[0])[0]  # warm-up
    lholder = [lstate]

    def lane_step_once(it=iter(range(10**9))):
        lholder[0] = lenv.step_batch(lholder[0], actions[next(it) % STEPS])[0]

    lane_step_ms = cuda_ms(lane_step_once, 3)
    lane_steps_per_s = MAIN_B / (lane_step_ms / 1e3)
    # the solver's inputs inside a substep of that path: parts resting on
    # the floor, gravity applied
    lparts = PartState(*(t.contiguous() for t in lholder[0].parts))
    lgroup = lholder[0].group.contiguous()
    largs = lenv.physics.solver_args(lparts, lgroup, torch.ones((MAIN_B, lenv._P), device=dev))
    lc = largs[0]
    LK, LP, liters = lc.depth.shape[1], lenv._P, largs[8]
    # the kernel alone on the path's own tables, then with every lane forced
    # into contact
    ltables = lenv.physics.lane_tables
    lane_solver.launch(ltables, *largs)  # warm-up
    lane_kernel_ms = cuda_ms(lambda: lane_solver.launch(ltables, *largs), 50)
    full = (lc._replace(mask=torch.ones_like(lc.mask), depth=lc.depth.abs() + 1e-3),) + largs[1:]
    lane_solver.launch(ltables, *full)  # warm-up
    lane_full_ms = cuda_ms(lambda: lane_solver.launch(ltables, *full), 50)
    lane_solver.solve_contacts_lane(*largs, tables=ltables)  # warm-up
    lane_wrapper_ms = cuda_ms(lambda: lane_solver.solve_contacts_lane(*largs, tables=ltables), 50)
    lane_plain_ms = cuda_ms(lambda: lane_solver.plain_solve_contacts_lane(*largs), 3)
    zeros_lam = torch.zeros((MAIN_B, LK, 3), device=dev)
    warm_solver_ms = cuda_ms(lambda: engine._solve_contacts(*largs, zeros_lam), 3)
    K_b = int((lc.part_b >= 0).sum())
    live = lc.mask & (lc.depth > -largs[10])
    mask_env = lc.mask.sum(-1).tolist()
    act_env = live.sum(-1).tolist()
    actb_env = (live & (lc.part_b >= 0)).sum(-1).tolist()
    n_masked, n_active, n_active_b = sum(mask_env), sum(act_env), sum(actb_env)
    # the work this run's data needs, env by env: the preparation and sweeps
    # of the lanes with a contact; every lane's mask, the depth of those with
    # the mask set, point and normal of those with a contact
    l_ops = sum(lane_solver.fp32_ops_per_env(LK, K_b, LP, liters, a, ab)
                for a, ab in zip(act_env, actb_env))
    l_ops_all = lane_solver.fp32_ops_per_env(LK, K_b, LP, liters) * MAIN_B
    l_bytes = sum(lane_solver.bytes_per_env(LK, LP, m, a) for m, a in zip(mask_env, act_env)) \
        + ltables.table_bytes()
    l_bytes_all = lane_solver.bytes_per_env(LK, LP) * MAIN_B + ltables.table_bytes()
    l_t_ops = l_ops / PEAK_FP32_FLOPS * 1e3
    l_t_bytes = l_bytes / PEAK_HBM_BYTES * 1e3
    lane_bound_ms = max(l_t_ops, l_t_bytes)
    lane_bound_by = "operations" if l_t_ops >= l_t_bytes else "bytes"
    l_t_ops_all = l_ops_all / PEAK_FP32_FLOPS * 1e3
    lane_clocks = lane_solver.phase_clocks(ltables, *largs)
    lane_floor_ms, lane_resident, lane_barriers, lane_trip_us = latency_floor(ltables, lane_clocks,
                                                                             sm_count)
    lane_shares, lane_cycles = phase_shares(lane_clocks, LANE_PHASES, 1)
    print(f"[time] lane path step_batch B={MAIN_B}: {lane_step_ms:.3f} ms/step, "
          f"{lane_steps_per_s:.1f} env steps/s ({lenv.config.n_substeps + 1} lane-solver launches a step)")
    print(f"[time] lane solver B={MAIN_B} K={LK} P={LP} sweeps={liters} ({n_masked} lanes with the mask "
          f"set, {n_active} with a contact, {n_active_b} of them between parts): kernel "
          f"{lane_kernel_ms:.4f} ms/launch (route {lane_solver.ROUTE_NAMES[ltables.route]}); "
          f"every lane in contact {lane_full_ms:.4f} ms; solve_contacts_lane on the card "
          f"{lane_wrapper_ms:.4f} ms; plain version {lane_plain_ms:.3f} ms; engine._solve_contacts "
          f"(the solve the lane path replaces) {warm_solver_ms:.3f} ms")
    print(f"[time] lane bound: {l_ops:.4g} FP32 ops -> {l_t_ops:.5f} ms at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s "
          f"(every lane in contact: {l_ops_all:.4g} ops, {l_t_ops_all:.5f} ms, {l_bytes_all} B, "
          f"{l_bytes_all / PEAK_HBM_BYTES * 1e3:.5f} ms); {l_bytes} B -> "
          f"{l_t_bytes:.5f} ms at {PEAK_HBM_BYTES / 1e12:g} TB/s; bound by {lane_bound_by} "
          f"({lane_bound_ms / scale:.5f} ms scaled to {watts:g} W); kernel at "
          f"{lane_bound_ms / lane_kernel_ms:.4f} of its bound")
    print(f"[time] lane kernel latency floor: {lane_barriers} block barriers counted in a launch of "
          f"{liters} sweeps x {-(-MAIN_B // (lane_resident * sm_count))} waves ({lane_resident} blocks an "
          f"SM x {sm_count} SMs) x {lane_trip_us:.4f} us a bare barrier at that occupancy = "
          f"{lane_floor_ms:.4f} ms (bound {lane_bound_ms:.5f} ms, kernel {lane_kernel_ms:.4f} ms)")
    print("[time] lane phases: " + ", ".join(f"{k} {v:.3f}" for k, v in zip(LANE_PHASES, lane_shares))
          + f" | {lane_cycles:.0f} cycles a launch a block")
    print("[time] lane library_ms: null (no single PyTorch call computes the solve)")
    print(f"[time] MPPI horizon {mcfg.horizon} x {mcfg.n_samples}: default backend "
          f"{1.0 / min(mppi_s[1:]):.3f} plans/s (best of plans 2 and 3; first {mppi_s[0]:.3f} s), "
          f"lane backend {1.0 / lane_plan_s:.3f} plans/s (one plan); CEM iteration {cem_s:.3f} s")
    cvec, cacts = ctrl_vecs["position_orientation"]
    cenv = cvec.env
    cholder = [cvec.state]

    def ctrl_step_once(it=iter(range(10**9))):
        cholder[0] = cenv.step_batch(cholder[0], cacts[next(it) % CTRL_STEPS])[0]

    ctrl_step_once()  # warm-up
    osc_step_ms = cuda_ms(ctrl_step_once, 5)
    osc_prepare_ms = cuda_ms(lambda: cenv._controller_prepare(cholder[0], cacts[0][:, :-1]), 5)
    # does the batched SVD wait for the card? Enqueue a long kernel, then
    # see when the SVD call returns on the host
    from furniture_tpu_torch.controllers.osc import _svd_clamped_inv

    mats = torch.rand((512, 3, 3), device=dev)
    mats = mats @ mats.transpose(1, 2)
    _svd_clamped_inv(mats)  # warm-up
    torch.cuda.synchronize()
    phys.kernel_substeps(parts, group, gscale, n)
    t_host = time.perf_counter()
    _svd_clamped_inv(mats)
    svd_host_ms = (time.perf_counter() - t_host) * 1e3
    torch.cuda.synchronize()
    svd_waits = svd_host_ms > 0.5 * kernel_ms
    print(f"[time] torch.linalg.svd on [512,3,3] called right after a {kernel_ms:.1f} ms kernel was "
          f"enqueued returned after {svd_host_ms:.3f} ms on the host: it "
          f"{'waits for the card (a host synchronisation)' if svd_waits else 'does not wait for the card'}")
    print(f"[time] Sawyer position_orientation step_batch B=512: {osc_step_ms:.3f} ms/step, "
          f"{512 / (osc_step_ms / 1e3):.1f} env steps/s; _controller_prepare (FK, mass matrix, three "
          f"SVD-clamped inverses) {osc_prepare_ms:.3f} ms of it")

    stamp("done")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "free_part_megakernel",
        "route": "cuda",
        "source": "furniture_tpu_torch/physics/csrc/megakernel.cu",
        "replaces": "furniture_tpu/physics/megakernel.py:428",
        "launches": launches + sum(il["launches"]) + rr["ppo_setup_launches"] + sum(ppo_launch)
        + sac["launches"] + ga["launches"] + ev["launches"] + tr["launches"] + render_mesh_free
        + sweep_free + tools_free,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "welded_ms": welded_ms,
        "latency_floor_ms": floor_ms,
        "barriers_per_launch": barriers,
        "resident_blocks_per_sm": resident,
        "phase_shares": dict(zip(MEGA_PHASES, shares)),
        "phase_shares_welded": dict(zip(MEGA_PHASES, wshares)),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bound_ms_at_power_limit": bound_ms / scale,
        "ill_conditioned_checks": [
            {"case": t, "max_abs_err": e, "plain_spread": sp} for t, e, sp in spread_cases
        ],
        "step_ms": step_ms,
        "step_host_enqueue_ms": step_host_ms,
        "env_steps_per_s": steps_per_s,
        "launches_on_arm_paths": free_launches_arm,
        "launches_on_generator_path": gen_free_launches,
        "launches_on_planner_paths": {"mppi": mppi_launches, "cem": cem_launches},
        "launches_on_ilqr_and_rl_paths": rl_launches,
        "launches_on_render_wrapper_and_mesh_paths": {
            "render_cursor500": render_launches["cursor_render500"][0],
            "render_sawyer200_resets": render_launches["sawyer_impedance_render200"][1],
            "wrapper_cursor": wr["IKEACursor-v0"]["launches"],
            "wrapper_sawyer_reset": wr["IKEASawyer-v0"]["free_launches"], **mesh_launches},
        "ilqr": il,
        "rl": rr,
        "launches_on_sweep_and_tools_paths": {
            "sweep": sweep_free, **{f"tool_{k}": tools[k]["free_launches"] for k in tool_keys}},
        "sweep_max_abs_err": sweep_worst,
        "tools_median_abs_err": tools_free_worst,
        "sweep": [{k: r[k] for k in ("agent", "name", "P", "K", "arm_K", "routes", "reset_ms", "step_ms")}
                  | {"hold_err": [h["err"] for _, h in r["holds"] if "n_touch" not in h]}
                  for r in sweep],
        "sweep_s": sweep_s,
        "tools_s": {k: tools[k]["s"] for k in tool_keys} | {"phase": tools_s},
        "fps": tools["fps"]["ret"],
        "profile_cursor": tools["profile_cursor"]["ret"],
        "profile_ilqr": tools["profile_ilqr"]["ret"],
    }, {
        "name": "arm_megakernel",
        "route": "cuda",
        "source": "furniture_tpu_torch/physics/csrc/arm_megakernel.cu",
        "replaces": "furniture_tpu/physics/arm_megakernel.py:459",
        "launches": arm_launches["impedance"] + arm_launches["ik"] + gen_arm_launches
        + ad["launches"] + render_mesh_arm + sweep_arm + tools_arm,
        "max_abs_err": arm_worst,
        "ms": arm_kernel_ms,
        "latency_floor_ms": arm_floor_ms,
        "barriers_per_launch": arm_barriers,
        "resident_blocks_per_sm": arm_resident,
        "phase_shares": dict(zip(ARM_PHASES, arm_shares)),
        "plain_ms": arm_plain_ms,
        "bound_ms": arm_bound_ms,
        "bound_by": arm_bound_by,
        "library_ms": None,
        "bound_ms_at_power_limit": arm_bound_ms / scale,
        "launches_by_path": dict(arm_launches, generator=gen_arm_launches,
                                 ilqr_arm_dynamics=ad["launches"],
                                 render_sawyer200=render_launches["sawyer_impedance_render200"][0],
                                 wrapper_sawyer=wr["IKEASawyer-v0"]["launches"], sweep=sweep_arm,
                                 **{f"tool_{k}": tools[k]["arm_launches"] for k in tool_keys}),
        "ilqr_arm_dynamics": ad,
        "sweep_median_abs_err": sweep_arm_worst,
        "tools_median_abs_err": tools_arm_worst,
        "ill_conditioned_checks": [
            {"case": t, "max_abs_err": e, "median_abs_err": m, "plain_spread_1e-7": s7,
             "plain_spread_1e-6": s6, "envs_over_bound": over}
            for t, e, m, s7, s6, over in arm_spread_cases
        ],
        "step_ms": {k: v[0] for k, v in arm_step.items()},
        "step_host_enqueue_ms": {k: v[2] for k, v in arm_step.items()},
        "env_steps_per_s": {k: v[1] for k, v in arm_step.items()},
        "joint_dyn_matrices_ms": dyn_ms,
        "ik_prepare_ms": ik_ms,
        "launches_on_controller_paths": ctrl_launches,
        "position_orientation_step_ms": osc_step_ms,
        "controller_prepare_ms": osc_prepare_ms,
        "svd_synchronises_host": svd_waits,
        "generator": {
            "batch": GEN_B,
            "step_ms_median": gen_step_t[0],
            "step_ms_spread": [gen_step_t[1], gen_step_t[2]],
            "scripted_action_ms_median": gen_policy_t[0],
            "scripted_action_ms_spread": [gen_policy_t[1], gen_policy_t[2]],
            "staged_connect_policy_steps": connected_at + 1,
            "entry_point_s": entry_s,
            "aten_ops": gen_ops,
        },
    }, {
        "name": "lane_solver",
        "route": "cuda",
        "source": "furniture_tpu_torch/physics/csrc/lane_solver.cu",
        "replaces": "furniture_tpu/physics/pallas_solver.py:165",
        "launches": lane_launches + mppi_lane_launches + lane_il["warm_up_launches"],
        "max_abs_err": lane_worst,
        "ms": lane_kernel_ms,
        "plain_ms": lane_plain_ms,
        "bound_ms": lane_bound_ms,
        "bound_by": lane_bound_by,
        "library_ms": None,
        "bound_ms_at_power_limit": lane_bound_ms / scale,
        "latency_floor_ms": lane_floor_ms,
        "barriers_per_launch": lane_barriers,
        "resident_blocks_per_sm": lane_resident,
        "phase_shares": dict(zip(LANE_PHASES, lane_shares)),
        "every_lane_in_contact_ms": lane_full_ms,
        "lanes_with_contact": n_active,
        "lanes_with_mask_set": n_masked,
        "launches_by_path": {"lane_cursor": lane_launches, "mppi_lane": mppi_lane_launches,
                             "ilqr_lane_solve": lane_il["warm_up_launches"]},
        "ilqr_lane": lane_il,
        "wrapper_ms": lane_wrapper_ms,
        "engine_solve_contacts_ms": warm_solver_ms,
        "gap_to_cold_engine_solve": {"lin": lane_cold_gap[0], "ang": lane_cold_gap[1]},
        "step_ms": lane_step_ms,
        "env_steps_per_s": lane_steps_per_s,
        "mppi_plans_per_s": {"default": 1.0 / min(mppi_s[1:]), "lane": 1.0 / lane_plan_s},
        "routes_at_bench_batch": lane_routes,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
