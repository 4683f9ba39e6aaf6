"""The on-card check of the PyTorch/CUDA port, and its kernel timings, on
one NVIDIA card.

    python3 chip_smoke.py              # the card tests, then the timings
    python3 chip_smoke.py --no-tests   # the timings alone

First it runs the card-only tests (``python -m pytest --noconftest -m gpu
tests/test_torch_*_gpu.py``): they drive every main path through
``make_vec_env`` with each kernel's launch count, and hold every kernel
against its plain version. Then it times what the benchmark's cells
(``python3 benchmark/run.py``) do not: each CUDA kernel of the port alone
at its cell's shapes, the figures of PERF.md §6, each held first against
its plain version on the same inputs (``tests/torch_gpu_holds.py``), so
that no time is kept of a kernel that is fast because it is wrong there;
and the paths that no cell runs yet. It imports nothing of JAX.

0. the card tests, in a process of their own, with their pass count;
1. build: every kernel source with ``nvcc``, kernels 1-3 also in their
   phase-clock builds (``-DFT_PHASE_CLOCKS``), nine at once, and each
   build's ``-Xptxas -v`` report;
2. each kernel alone, after a warm-up, by CUDA events: ms a launch as the
   host enqueues them (beside the host's ms a call), ms a launch queued
   behind a sleep (the device's own time), its plain PyTorch version's ms,
   and the bound, the larger of the call's FP32 operations over 67 TFLOP/s
   and its bytes over 3.35 TB/s (the published H100 SXM peaks at 700 W):
   kernel 1 (``megakernel.cu``, n = 50) on table_lack at B = 4096 after a
   reset and 3 random steps, free and welded (two recipe steps
   preassembled), held by ``hold_free`` after 5 substeps (1e-4) and 50
   (1e-3), and its cluster route on chair_balser at B = 1024 (held the same
   way; 3 CTAs an env), timed in turns with table_lack's; kernel
   2 (``arm_megakernel.cu``, n = 50) on Sawyer impedance at B = 512, held
   by ``hold_call`` (5e-4 after 5 substeps, 1e-3 after 50);
   kernel 3 (``lane_solver.cu``, 12 sweeps) on a lane
   step's contacts at B = 4096 and with every lane in contact, beside
   ``solve_contacts_lane`` as a whole and ``engine._solve_contacts``, held
   by ``hold_lane``, and its two routes in turns (``time_lane_routes``);
   kernel 4 (``arm_dynamics.cu``) on Sawyer at B = 512 and kernel 5
   (``arm_ik.cu``) on Sawyer ik at B = 256, each held to the float64 truth
   on the CPU (G1, G2 within 1e-4 of the truth's largest entry and 4x the
   plain gap; the IK's 90th percentile within 4x the plain one), each also
   at one block of 4 envs (its latency floor); kernel 6 (``assembly.cu``), the
   connect attempt of the cursor at B = 4096 on staged connects
   (``staged_connects``) on table_lack and on bookcase_besta_0170 (C = 40),
   and the cursor's snap-back move on table_lack, each held to its plain
   version on the same inputs (discrete outputs equal, floats within 1e-5)
   and at one block of 4 envs (its latency floor; latency-bound, so no
   bound is reported). For kernels 1-3 also the blocks an SM holds, the latency floor
   (the block barriers of a launch as the phase-clock build counts them x
   a bare barrier's round trip at that occupancy x the waves of blocks; on
   kernel 1's cluster route the clusters the card holds, and its cluster
   barriers x a bare cluster barrier's round trip beside them) and each
   phase's share of a block's clock;
3. paths no cell runs: the lane path's step at B = 4096; Sawyer's
   ``position_orientation`` step at B = 512 and its ``_controller_prepare``;
   the scripted generator's step and policy decision at B = 128 (medians of
   the last 20 of 30 steps); an MPPI plan of 64 steps x 256 samples on each
   backend; a render beside its step (Sawyer impedance, B = 128, 200 x 200;
   the cursor, B = 32, 500 x 500), and the peak memory.

Prints the tests' summary, ``[build]`` and ``[time]`` lines, the card's
name and power limit, a ``{"kernels": [...]}`` line and as its last line
``{"ok": true, "card_tests": {...}, "device": {...}}``. Any failure, a
failed card test, a broken hold or a launch's CUDA error among them, exits
non-zero without that line; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(HERE, "tests")

# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FULL_POWER_W = 700.0
MAIN_B, ARM_B, IK_B, GEN_B = 4096, 512, 256, 128
# phases of a substep (a launch, for kernel 3) as the phase-clock builds count them
MEGA_PHASES = ("frames+aggregates", "narrow phase+prep", "first pass (gates+counts+warm start)",
               "passes: group half", "passes: lane half", "integration+floor")
ARM_PHASES = ("joint update+chain+hand geoms | held clamp+frames+aggregates", "narrow phase+prep",
              "first pass (gates+counts+warm start | servo gates+actuators)",
              "passes: group half", "passes: lane half", "integration+floor+hand-geom forces")
LANE_PHASES = ("loads", "preparation+counts", "sweeps: lane half", "sweeps: group half")
# kernel 3's two routes, timed in turns: one lane a thread, global scratch
LANE_ROUTE_MODELS = ("table_lack_0825", "chair_balser_0115")
# kernel 1's cluster route at its cell's model and batch
# (chair_balser.random-b1024), timed in turns with table_lack's one lane a thread
CLUSTER_MODEL, CLUSTER_B = "chair_balser_0115", 1024


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_name_and_limit() -> tuple[str, float]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return out, float(out.split(",")[-1].strip().split()[0])


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
    """``cuda_ms``, and the ms per call the host took to enqueue the calls
    (host clock, before the synchronisation): where the two agree the host
    sets the pace."""
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


def queued_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls queued behind a
    sleep, so that no launch waits for the host: the device's own time."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e7))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_card_tests() -> dict:
    """The card-only test files in a process of their own; fails the run
    unless they all pass. Returns the summary line and the seconds."""
    files = sorted(glob.glob(os.path.join(TESTS, "test_torch_*_gpu.py")))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu", "-q",
                          "-p", "no:cacheprovider", *files], cwd=HERE, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    print(f"[tests] {len(files)} card test files: {summary} ({secs:.1f} s)", flush=True)
    if out.returncode != 0:
        print(out.stdout[-20000:], out.stderr[-4000:], sep="\n", flush=True)
        fail(f"the card tests exited with {out.returncode}")
    return {"files": len(files), "summary": summary, "seconds": secs}


def held(what: str, h: dict) -> None:
    """A ``[hold]`` line of a hold's numbers; fails the run where it broke a
    limit (``problem``)."""
    report(what, h, "hold")
    if h["problem"] is not None:
        fail(f"{what}: {h['problem']}")


def time_kernel(fn, plain, reps: int, plain_reps: int = 3) -> dict:
    """A kernel's launch ``fn`` and its plain version ``plain``, each after
    one warm-up call: ``ms`` and ``host_ms`` (``cuda_and_host_ms``),
    ``device_ms`` (``queued_ms``) and ``plain_ms``. The caller holds the
    kernel against ``plain`` on the same inputs first."""
    fn()
    ms, host_ms = cuda_and_host_ms(fn, reps)
    out = {"ms": ms, "host_ms": host_ms, "device_ms": queued_ms(fn, reps)}
    plain()
    out["plain_ms"] = cuda_ms(plain, plain_reps)
    return out


def bound(ops: float, nbytes: float, watts: float) -> dict:
    """The least time of a call of ``ops`` FP32 operations and ``nbytes``
    bytes at the published peaks, and scaled to a lower power limit."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    ms = max(t_ops, t_bytes)
    return {"ops": ops, "bytes": nbytes, "bound_ms": ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_at_power_limit": ms / min(1.0, watts / FULL_POWER_W)}


def clock_stats(obj, clocks, names, n: int, sm_count: int) -> dict:
    """From a phase-clock build's ``[B, phases + 1]`` clocks of a launch of
    ``n`` substeps: each phase's share of a block's clock (mean over the
    envs), the cycles a block spends on a substep, and the latency floor,
    the block barriers a block passed (the last column) x the measured round
    trip of a bare barrier with as many blocks of the kernel's size resident
    on every SM as ``obj`` has x the waves the blocks come in. On kernel 1's
    cluster route (``obj.layout.route``) the waves are of the clusters the
    card holds, and the floor adds the cluster barriers (column 6) x a bare
    cluster barrier's round trip and the passes' exchanges (``n`` x the
    solver's passes) x a bare exchange's round trip of as many group
    partials as the model has parts (each free), both at that occupancy."""
    c = clocks[:, : len(names)].double()
    shares = (c / c.sum(-1, keepdim=True).clamp(min=1)).mean(0).tolist()
    counts = clocks[:, -1]
    barriers = int(counts[0])
    if barriers <= 0 or not bool((counts == barriers).all()):
        fail(f"the blocks of a launch counted different numbers of barriers ({counts.unique().tolist()})")
    resident, probe_n = obj.resident_blocks(), 20000
    layout = getattr(obj, "layout", None)
    cluster = layout is not None and layout.route == "cluster"
    blocks = resident * (layout.cluster if cluster else sm_count)
    obj.barrier_probe(blocks, 100)  # warm-up
    trip_ms = cuda_ms(lambda: obj.barrier_probe(blocks, probe_n), 3) / probe_n
    waves = -(-clocks.shape[0] // (resident if cluster else blocks))
    out = {"phase_shares": dict(zip(names, shares)), "cycles_a_substep": c.sum(-1).mean().item() / n,
           "resident_blocks_per_sm": resident, "barriers_per_launch": barriers,
           "barrier_us": trip_ms * 1e3, "latency_floor_ms": waves * barriers * trip_ms}
    if cluster:
        cluster_barriers, exchanges = int(clocks[0, 6]), n * (obj.cfg.solver_iters + 1)
        trips = {}
        for groups in (0, obj.P):
            obj.cluster_probe(resident, 100, groups)  # warm-up
            trips[groups] = cuda_ms(lambda: obj.cluster_probe(resident, probe_n, groups), 3) / probe_n
        del out["resident_blocks_per_sm"]
        out |= {"resident_clusters": resident, "ctas_a_cluster": layout.cluster,
                "cluster_barriers_per_launch": cluster_barriers, "cluster_barrier_us": trips[0] * 1e3,
                "exchanges_per_launch": exchanges, "exchange_us": trips[obj.P] * 1e3,
                "latency_floor_ms": waves * (barriers * trip_ms + cluster_barriers * trips[0]
                                             + exchanges * trips[obj.P])}
    return out


def report(name: str, rec: dict, tag: str = "time") -> None:
    """One ``[time]`` (or ``[tag]``) line of a record's numbers."""
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        if isinstance(v, dict):
            return "{" + ", ".join(f"{k}: {fmt(x)}" for k, x in v.items()) + "}"
        return str(v)

    print(f"[{tag}] {name}: " + "; ".join(f"{k} {fmt(v)}" for k, v in rec.items()), flush=True)


def random_steps(env, state, n: int, seed: int):
    """``state`` after ``n`` steps of uniform random actions."""
    import torch

    gen = torch.Generator(device=state.parts.pos.device)
    gen.manual_seed(seed)
    for _ in range(n):
        a = torch.rand((state.parts.pos.shape[0], env.dof), generator=gen, device=gen.device) * 2 - 1
        state = env.step_batch(state, a)[0]
    return state


def reset(env, B: int, seed: int = 3):
    import torch

    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    return env.reset_batch(B, gen)


def ik_ops_per_env(robot, control_type: str) -> int:
    """FP32 operations of the IK control step for one env, as kernel 5
    (``csrc/arm_ik.cu``) does it, the yardstick of its bound (each add,
    multiply, divide, square root, max, min, sin, cos and arccos counts one;
    index arithmetic, copies and sign flips do not): per arm, the target's
    update and 21 forward kinematics along the hand's chain, and in each of
    20 iterations the pose error, the Jacobian columns, J J^T + damping I,
    the 6x6 factorisation, the two substitutions, J^T x and the clamps."""
    from furniture_tpu_torch.controllers.ik import ITERS, hand_chain
    from furniture_tpu_torch.robots.chain import HINGE

    qrot, qmul, qinv, qnorm = 30, 28, 12, 13
    # the move and its box (15); the orientation target: euler angles to a
    # quat, product, normalise (79), or normalise, product, normalise (54);
    # its 45-degree limit (47); the slerp (71); the position target (24)
    orient = 2 * qnorm + qmul if control_type == "ik_quaternion" else 6 + 12 + 20 + qmul + qnorm
    target = 15 + orient + (qinv + qmul + 7) + (3 * qnorm + 7 + 13 + 3 * 4) + 24
    err = 3 + qinv + qmul + 2 + 2 + 7 + 3 * 2
    chol = sum(2 * j + 1 + (5 - j) * (2 * j + 1) for j in range(6))
    solve = 2 * sum(2 * i + 1 for i in range(6))
    ops = 0
    for arm in robot.arms:
        fk = 0
        for c, b in enumerate(hand_chain(robot, arm)):
            j = int(robot.body_joint[b])
            fk += 0 if c == 0 else qrot + 3 + qmul
            if j >= 0:
                fk += 6 + qmul + 2 * qrot + 6 if int(robot.jnt_type[j]) == HINGE else qrot + 6
        na = len(robot.arm_joints[arm])
        jac = na * (2 * qrot + 3 + 12)
        jjt = 21 * 2 * na + 6
        step = na * (2 * 6 + 4)
        ops += target + (ITERS + 1) * fk + ITERS * (err + jac + jjt + chol + solve + step)
    return ops


def joint_dyn_ops_per_env(robot) -> int:
    """FP32 operations of the joint-dynamics function for one env, as kernel
    4 (``csrc/arm_dynamics.cu``) does it, the yardstick of its bound (each
    add, multiply, divide, square root, max, sin and cos counts one; index
    arithmetic does not): the chain, the bodies' and joints' world frames,
    M's upper triangle over the bodies both joints move, the factorisation,
    the NJ substitutions and G1, G2."""
    import numpy as np

    from furniture_tpu_torch.robots.chain import HINGE

    r = robot
    nb, nj = r.nb, r.nj
    hinge = np.asarray(r.jnt_type) == HINGE
    bj = np.asarray(r.body_joint)
    qrot, qmul = 30, 28
    chain = sum(
        (0 if r.parent[b] < 0 else qrot + 3 + qmul)
        + (0 if bj[b] < 0 else (4 + qmul + 2 * qrot + 6 if hinge[bj[b]] else qrot + 6))
        for b in range(nb)
    )
    frames = nb * (qrot + 3 + 13 + 39 + 90) + nj * (2 * qrot + 3)
    mass = 2 * nj                                                   # armature, dt·D
    for b in range(nb):
        js = np.flatnonzero(r.ancestor[b])
        for a, k in enumerate(js):
            for j in js[a:]:
                mass += 12 * (hinge[k] + hinge[j]) + 7 + (21 if hinge[k] and hinge[j] else 0)
    chol = sum(1 + (nj - k - 1) + (nj - k - 1) * (nj - k) for k in range(nj))
    solve = sum((nj - c) ** 2 + nj * nj for c in range(nj))
    return int(chain + frames + mass + chol + solve + nj * nj * (2 * nj + 1))


def build() -> None:
    """Every kernel source, and the phase-clock builds of kernels 1-3, with
    ``nvcc`` at once; each build's register, shared-memory and spill report."""
    from furniture_tpu_torch import _cuda
    from furniture_tpu_torch.controllers import ik
    from furniture_tpu_torch.envs import assembly
    from furniture_tpu_torch.physics import arm_dynamics, arm_megakernel, lane_solver, megakernel

    t0 = time.perf_counter()
    physics = [megakernel, arm_megakernel, lane_solver]
    builds = ([(m, ()) for m in physics + [arm_dynamics, ik, assembly]]
              + [(m, _cuda.PHASE_CLOCKS) for m in physics])
    procs = [_cuda.start_build(m.SOURCE, d) for m, d in builds]
    for p in procs:
        _cuda.finish_build(p)
    for m, d in builds:
        print(f"[build] {os.path.relpath(m.SOURCE, HERE)} {' '.join('-D' + x for x in d)} "
              f"({time.perf_counter() - t0:.1f} s):")
        for line in _cuda.build_log(m.SOURCE, d).splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print("   ", line.strip())
        m.library(*((d,) if d else ()))


def kernel1(dev, watts: float, sm_count: int) -> dict:
    """Kernel 1 at n = 50, after a reset and 3 random steps, in three cases:
    table_lack at B = ``MAIN_B``, free parts and welded by two recipe steps
    preassembled (one lane a thread), and ``CLUSTER_MODEL`` at B =
    ``CLUSTER_B``, whose every launch must take the cluster route.
    Each is held by ``hold_free`` and timed with its plain version and phase
    shares, the free cases with their bound. Then the two free cases' ms a
    launch timed in turns (table_lack, chair, chair, table_lack) by CUDA
    events."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.physics.state import PartState
    from torch_gpu_holds import hold_free

    cases = (("free", EnvConfig(), MAIN_B, (10, 2)),
             ("welded", EnvConfig(preassembled=(0, 1)), MAIN_B, (10, 2)),
             ("cluster", EnvConfig(furniture_name=CLUSTER_MODEL), CLUSTER_B, (3, 1)))
    out, runs = {}, {}
    for case, cfg, B, reps in cases:
        env = CursorEnv(cfg, device=dev)
        st = random_steps(env, reset(env, B), 3, 1)
        phys, n, P = env.physics, env.config.n_substeps, env._P
        args = (PartState(*(t.contiguous() for t in st.parts)), st.group.contiguous(),
                torch.ones((B, P), device=dev), n)
        name = f"kernel 1 {case}, {cfg.furniture_name}"
        for m, tol in ((5, 1e-4), (n, 1e-3)):
            held(f"{name}, n={m} B={B}", hold_free(phys, *args[:3], m, tol, chaotic=True))
        rec = {"K": phys.K, "slots": phys.slots["KS"]}
        rec |= time_kernel(lambda: phys.kernel_substeps(*args), lambda: phys.plain_substeps(*args), *reps)
        rec |= clock_stats(phys, phys.phase_clocks(*args), MEGA_PHASES, n, sm_count)
        if case != "welded":
            tables = sum(t.numel() * t.element_size() for t in phys._dev.values())
            rec |= bound(phys.fp32_ops_per_env(n) * B, B * P * 4 * (15 + 13) + tables, watts)
        if case == "cluster" and phys.cluster_launches != phys.launches:
            fail(f"{name}: {phys.cluster_launches} of {phys.launches} launches on the cluster route")
        rec["groups"] = st.group[0].tolist()
        report(f"{name}, n={n} B={B}", rec)
        out[case], runs[case] = rec, (phys, args)
    turns = ("free", "cluster", "cluster", "free")
    for case in turns:
        ph, a = runs[case]
        out[case].setdefault("ms_in_turns", []).append(cuda_ms(lambda: ph.kernel_substeps(*a), 5))
    report("kernel 1 in turns, table_lack and " + CLUSTER_MODEL,
           {case: out[case]["ms_in_turns"] for case in turns[:2]})
    return out


def kernel2(dev, watts: float, sm_count: int) -> dict:
    """Kernel 2 at n = 50 on Sawyer impedance, B = ``ARM_B``, after a reset
    and 2 random steps, under a random action."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.physics.state import PartState
    from furniture_tpu_torch.robots import kinematics as K
    from torch_gpu_holds import hold_call

    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device=dev)
    st = random_steps(env, reset(env, ARM_B), 2, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ctrl = env._direct_ctrl((torch.rand((ARM_B, env.dof), generator=gen, device=dev) * 2 - 1)[:, :-1])
    ph, n, P, NJ = env.physics, env.config.n_substeps, env._P, env.robot.nj
    G1, G2 = K.joint_dyn_matrices(env.robot, st.qpos, env.config.sim.timestep)
    args = (PartState(*(t.contiguous() for t in st.parts)), st.group, torch.ones((ARM_B, P), device=dev),
            st.qpos, st.qvel, ctrl, torch.zeros((ARM_B, NJ), device=dev), G1.contiguous(), G2.contiguous(), n)
    for h in hold_call(ph, args):
        held(f"kernel 2 Sawyer impedance, B={ARM_B}", h)
    rec = time_kernel(lambda: ph.kernel_control_step(*args), lambda: ph.plain_control_step(*args), 10, 2)
    nbytes = (ARM_B * 4 * (P * 15 + 3 * NJ + env.robot.na + 2 * NJ * NJ) + ARM_B * (4 * (P * 13 + 2 * NJ) + ph.NT)
              + sum(t.numel() * t.element_size() for t in ph._dev.values()))
    rec |= bound(ph.fp32_ops_per_env(n) * ARM_B, nbytes, watts)
    rec |= clock_stats(ph, ph.phase_clocks(*args), ARM_PHASES, n, sm_count)
    report(f"kernel 2 Sawyer impedance, n={n} B={ARM_B}", rec)
    return rec


def lane_work(c, args, tables, every=False) -> tuple:
    """(FP32 operations, bytes) kernel 3's launch on ``args`` needs, env by
    env: the preparation and sweeps of the lanes with a contact; every lane's
    mask, the depth of those with the mask set, point and normal of those
    with a contact. ``every``: as if every lane were in contact."""
    from furniture_tpu_torch.physics import lane_solver

    B, K = c.depth.shape
    P, iters, K_b = args[1].shape[1], args[8], int((c.part_b >= 0).sum())
    if every:
        return (lane_solver.fp32_ops_per_env(K, K_b, P, iters) * B,
                lane_solver.bytes_per_env(K, P) * B + tables.table_bytes())
    live = c.mask & (c.depth > -args[10])
    act, actb, masked = (x.sum(-1).tolist() for x in (live, live & (c.part_b >= 0), c.mask))
    ops = sum(lane_solver.fp32_ops_per_env(K, K_b, P, iters, a, ab) for a, ab in zip(act, actb))
    return ops, sum(lane_solver.bytes_per_env(K, P, m, a) for m, a in zip(masked, act)) + tables.table_bytes()


def kernel3(dev, watts: float, sm_count: int) -> dict:
    """Kernel 3 on the lane path's contacts after a step at B = ``MAIN_B``
    (default ``SimConfig``: 12 sweeps), the path's step itself, and the two
    routes (``time_lane_routes``)."""
    import torch

    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.physics import engine, lane_solver
    from furniture_tpu_torch.physics.state import PartState
    from torch_gpu_holds import hold_lane

    env = CursorEnv(EnvConfig(sim=SimConfig(use_pallas="lane")), device=dev)
    holder = [random_steps(env, reset(env, MAIN_B), 1, 1)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def step():
        a = torch.rand((MAIN_B, env.dof), generator=gen, device=dev) * 2 - 1
        holder[0] = env.step_batch(holder[0], a)[0]

    step_ms = cuda_ms(step, 3)
    st = holder[0]
    args = env.physics.solver_args(PartState(*(t.contiguous() for t in st.parts)), st.group.contiguous(),
                                   torch.ones((MAIN_B, env._P), device=dev))
    c, tables = args[0], env.physics.lane_tables
    hold_lane(tables, args, sweeps=(args[8],))
    report(f"kernel 3 B={MAIN_B} sweeps={args[8]}", {"problem": None}, "hold")
    rec = time_kernel(lambda: lane_solver.launch(tables, *args),
                      lambda: lane_solver.plain_solve_contacts_lane(*args), 50)
    rec["route"] = lane_solver.ROUTE_NAMES[tables.route]
    live = c.mask & (c.depth > -args[10])
    rec["lanes_with_mask_set"], rec["lanes_with_contact"] = int(c.mask.sum()), int(live.sum())
    rec |= bound(*lane_work(c, args, tables), watts)
    full = (c._replace(mask=torch.ones_like(c.mask), depth=c.depth.abs() + 1e-3),) + args[1:]
    lane_solver.launch(tables, *full)  # warm-up
    rec["every_lane_in_contact_ms"] = cuda_ms(lambda: lane_solver.launch(tables, *full), 50)
    rec["every_lane_in_contact_bound_ms"] = bound(*lane_work(c, args, tables, every=True), watts)["bound_ms"]
    lane_solver.solve_contacts_lane(*args, tables=tables)  # warm-up
    rec["wrapper_ms"] = cuda_ms(lambda: lane_solver.solve_contacts_lane(*args, tables=tables), 50)
    lam = torch.zeros(c.depth.shape + (3,), device=dev)
    rec["engine_solve_contacts_ms"] = cuda_ms(lambda: engine._solve_contacts(*args, lam), 3)
    rec |= clock_stats(tables, lane_solver.phase_clocks(tables, *args), LANE_PHASES, 1, sm_count)
    rec["lane_step_ms"], rec["lane_env_steps_per_s"] = step_ms, MAIN_B / (step_ms / 1e3)
    report(f"kernel 3 B={MAIN_B} K={c.depth.shape[1]} sweeps={args[8]} (and the lane path's step)", rec)
    rec["routes"] = time_lane_routes(dev, watts)
    for name, r in rec["routes"].items():
        report(f"kernel 3 route {r['route']}, {name}", r)
    return rec


def time_lane_routes(dev, watts: float) -> dict:
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

    cases, runs = {}, {}
    for name in LANE_ROUTE_MODELS:
        env = CursorEnv(EnvConfig(furniture_name=name), device=dev)
        st = reset(env, MAIN_B)
        ones = torch.ones((MAIN_B, env._P), device=dev)
        group = st.group.contiguous()
        parts = env.physics.substeps(PartState(*(t.contiguous() for t in st.parts)), group, ones, 50)
        lphys = make_batched_substeps(engine.physics_tables(env.model), SimConfig(use_pallas="lane"), dev)
        args = lphys.solver_args(PartState(*(t.contiguous() for t in parts)), group, ones)
        tables, c = lphys.lane_tables, args[0]
        lane_solver.launch(tables, *args)  # warm-up
        cases[name] = {"K": c.depth.shape[1], "P": env._P, "route": lane_solver.ROUTE_NAMES[tables.route],
                       "lanes_with_contact": int((c.mask & (c.depth > -args[10])).sum()),
                       **bound(*lane_work(c, args, tables), watts), "ms": []}
        runs[name] = (tables, args)
    for name in list(LANE_ROUTE_MODELS) + list(reversed(LANE_ROUTE_MODELS)):
        tables, args = runs[name]
        cases[name]["ms"].append(cuda_ms(lambda: lane_solver.launch(tables, *args), 20))
    return cases


def kernel4(dev, watts: float) -> dict:
    """Kernel 4 on Sawyer (velocity servos) at B = ``ARM_B``, joint
    positions drawn by numpy within the joint ranges, and at one block of 4
    envs (the launch and one env's chain of dependent steps: its latency
    floor)."""
    import numpy as np
    import torch

    from furniture_tpu_torch.config import SimConfig
    from furniture_tpu_torch.physics.arm_dynamics import ArmDynamics, library
    from furniture_tpu_torch.robots import compile_robot
    from furniture_tpu_torch.robots import kinematics as K
    from torch_gpu_holds import float64_twin

    r, dt = compile_robot("Sawyer"), SimConfig().timestep
    dyn = ArmDynamics(r, dt, dev)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(np.maximum(r.jnt_range[:, 0], -2.0), np.minimum(r.jnt_range[:, 1], 2.0),
                                    size=(ARM_B, r.nj)).astype(np.float32), device=dev)
    q1 = q[:4].contiguous()
    truth = K.joint_dyn_matrices(float64_twin(r), q.cpu().double(), dt)
    gap = lambda x, t: ((x.cpu().double() - t).abs().max() / t.abs().max()).item()
    for name, g, p, t in zip(("G1", "G2"), dyn.matrices(q), K.joint_dyn_matrices(r, q, dt), truth):
        err, plain_err = gap(g, t), gap(p, t)
        ok = err < 1e-4 and err <= 4 * plain_err
        held(f"kernel 4 {name} B={ARM_B}", {"err": err, "plain_err": plain_err,
                                            "problem": None if ok else "over 1e-4 or 4x the plain gap"})
    rec = time_kernel(lambda: dyn.matrices(q), lambda: K.joint_dyn_matrices(r, q, dt), 200, 5)
    rec["latency_floor_ms"] = queued_ms(lambda: dyn.matrices(q1), 200)
    nbytes = ARM_B * 4 * (r.nj + 2 * r.nj * r.nj) + sum(x.numel() * x.element_size() for x in dyn._dev.values())
    rec |= bound(joint_dyn_ops_per_env(r) * ARM_B, nbytes, watts)
    rec["smem_bytes"] = library().arm_dyn_smem_bytes(r.nb, r.nj)
    report(f"kernel 4 Sawyer B={ARM_B}", rec)
    return rec


def kernel5(dev, watts: float) -> dict:
    """Kernel 5 on Sawyer ik at B = ``IK_B``, from a reset under a random
    action, and at one block of 4 envs (its latency floor)."""
    import torch

    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.controllers.ik import ik_prepare, library
    from furniture_tpu_torch.envs.arm import ArmEnv
    from torch_gpu_holds import float64_twin, p90_gap

    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="ik"), device=dev)
    st, ik = reset(env, IK_B), env.ik
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    act = torch.rand((IK_B, env.dof), generator=gen, device=dev) * 2 - 1
    args = (st.qpos.contiguous(), st.ik_target_pos.contiguous(), st.hand_quat_init.contiguous(), act)
    one = tuple(x[:4].contiguous() for x in args)
    plain = lambda: ik_prepare(env.robot, ik.control_type, ik.move_speed, ik.rotate_speed, *ik.box, *args)
    truth = ik_prepare(float64_twin(env.robot), ik.control_type, ik.move_speed, ik.rotate_speed,
                       *(b.cpu().double() for b in ik.box), *(x.cpu().double() for x in args))
    for name, g, p, t in zip(("ik_target_pos", "hand_quat_init", "q_cmd"), ik.prepare(*args), plain(), truth):
        err, plain_err = p90_gap(g, t), p90_gap(p, t)
        held(f"kernel 5 {name} B={IK_B}", {"p90": err, "plain_p90": plain_err,
                                          "problem": None if err <= 4 * plain_err else "over 4x the plain p90"})
    rec = time_kernel(lambda: ik.prepare(*args), plain, 200)
    rec["latency_floor_ms"] = queued_ms(lambda: ik.prepare(*one), 200)
    nbytes = (sum(x.numel() * 4 for x in args) + IK_B * 4 * (env.robot.nj + 7 * env.n_arms)
              + sum(t.numel() * t.element_size() for t in ik._dev.values()))
    rec |= bound(ik_ops_per_env(env.robot, env.control_type) * IK_B, nbytes, watts)
    rec["smem_bytes"] = library().arm_ik_smem_bytes(env.n_arms, env.robot.nj)
    report(f"kernel 5 Sawyer ik B={IK_B}", rec)
    return rec


def kernel6(dev) -> dict:
    """Kernel 6, the cursor's connect attempt at B = ``MAIN_B`` on staged
    connects on table_lack and on bookcase_besta_0170 (the most sites), and
    its snap-back move on table_lack, each held first to its plain version
    on the same inputs and timed with it, and at one block of 4 envs (its
    latency floor)."""
    import torch

    from furniture_tpu_torch.envs.assembly import AssemblyOps, library
    from torch_gpu_holds import staged_connects

    def card(x):
        return type(x)(*map(card, x)) if isinstance(x, tuple) else x.to(dev)

    def leaves(x):
        return [t for f in x for t in leaves(f)] if isinstance(x, tuple) else [x]

    def hold(what, got, want):
        gap, same = 0.0, True
        for g, w in zip(leaves(got), leaves(want)):
            if g.is_floating_point():
                gap = max(gap, (g - w).abs().max().item())
            else:
                same = same and torch.equal(g, w)
        held(what, {"float_gap": gap, "discrete_equal": same,
                    "problem": None if same and gap <= 1e-5 else "discrete outputs differ or floats over 1e-5"})

    out = {}
    for name in ("table_lack_0825", "bookcase_besta_0170"):
        cpu_ops, st, connect, held_parts, _, _ = staged_connects(name, MAIN_B, seed=MAIN_B)
        ops = AssemblyOps(cpu_ops.model, cpu_ops.config, dev)
        st, connect, held_parts = card(st), connect.to(dev), held_parts.to(dev)
        one = [card(x) for x in staged_connects(name, 4, seed=4)[1:4]]
        hold(f"kernel 6 attempt {name} B={MAIN_B}", ops.attempt(st, connect, held=held_parts),
             ops.plain_attempt(st, connect, held=held_parts))
        rec = time_kernel(lambda: ops.attempt(st, connect, held=held_parts),
                          lambda: ops.plain_attempt(st, connect, held=held_parts), 200)
        rec["latency_floor_ms"] = queued_ms(lambda: ops.attempt(one[0], one[1], held=one[2]), 200)
        rec["smem_bytes"] = library().connect_smem_bytes(ops._P, ops._C, ops.conn_angles.shape[1])
        report(f"kernel 6 cursor attempt {name} B={MAIN_B}", rec)
        out[name] = rec
        if name == "table_lack_0825":
            hold(f"kernel 6 snap-back move {name} B={MAIN_B}", ops.snap_move(st), ops.plain_snap_move(st))
            rec = time_kernel(lambda: ops.snap_move(st), lambda: ops.plain_snap_move(st), 200)
            rec["latency_floor_ms"] = queued_ms(lambda: ops.snap_move(one[0]), 200)
            report(f"kernel 6 cursor snap-back move {name} B={MAIN_B}", rec)
            out[name + " snap-back move"] = rec
    return out


def paths(dev) -> dict:
    """The paths no benchmark cell runs yet, by CUDA events or the host's
    clock around synchronised work."""
    import numpy as np
    import torch

    import furniture_tpu_torch as ft
    from furniture_tpu_torch.config import EnvConfig, SimConfig
    from furniture_tpu_torch.envs.arm import ArmEnv
    from furniture_tpu_torch.envs.cursor import CursorEnv
    from furniture_tpu_torch.planning import MPPIConfig, make_mppi
    from furniture_tpu_torch.render import frontview, make_render_fn

    out = {}
    gen = torch.Generator(device=dev)
    rand = lambda B, env: torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1

    # Sawyer under position_orientation: the step and its controller's share
    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="position_orientation"), device=dev)
    holder = [random_steps(env, reset(env, ARM_B), 1, 1)]
    gen.manual_seed(5)

    def step():
        holder[0] = env.step_batch(holder[0], rand(ARM_B, env))[0]

    a = rand(ARM_B, env)
    osc = {"step_ms": cuda_ms(step, 5),
           "controller_prepare_ms": cuda_ms(lambda: env._controller_prepare(holder[0], a[:, :-1]), 5)}
    report(f"Sawyer position_orientation B={ARM_B}", osc)
    out["position_orientation"] = osc

    # the scripted demo generator: the step and the policy's decision apart
    genv = ft.make_vec_env("IKEASawyerGen-v0", num_envs=GEN_B, seed=0).env
    gen.manual_seed(5)
    gst = genv.reset_batch(GEN_B, gen)
    pol = genv.init_policy_state(gst, gen)
    step_ms, policy_ms = [], []
    for _ in range(30):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        ga, pol = genv.scripted_action(pol, gst)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        gst = genv.step_batch(gst, ga)[0]
        torch.cuda.synchronize()
        policy_ms.append((t_b - t_a) * 1e3)
        step_ms.append((time.perf_counter() - t_b) * 1e3)
    g = {"step_ms_median": float(np.median(step_ms[-20:])), "step_ms_range": [min(step_ms[-20:]), max(step_ms[-20:])],
         "scripted_action_ms_median": float(np.median(policy_ms[-20:])),
         "scripted_action_ms_range": [min(policy_ms[-20:]), max(policy_ms[-20:])]}
    g["scripted_env_steps_per_s"] = GEN_B / ((g["step_ms_median"] + g["scripted_action_ms_median"]) / 1e3)
    report(f"generator (ik) B={GEN_B}, the last 20 of 30 steps", g)
    out["generator"] = g

    # an MPPI plan at bench.py's configuration on each backend
    cfg = MPPIConfig(horizon=64, n_samples=256, sigma=0.3)
    plans = {}
    for backend in ("auto", "lane"):
        penv = CursorEnv(EnvConfig(sim=SimConfig(timestep=0.02, solver_iters=8, use_pallas=backend)), device=dev)
        pstate, plan = reset(penv, 1, 0), make_mppi(penv, cfg)
        mean = torch.zeros((cfg.horizon, penv.dof), device=dev)
        secs = []
        for i in range(3):
            gen.manual_seed(10 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean = plan(pstate, mean, gen)[0]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        plans[backend] = {"plans_per_s": 1.0 / min(secs[1:]), "first_plan_s": secs[0]}
    report(f"MPPI {cfg.horizon} x {cfg.n_samples} (best of plans 2 and 3)", plans)
    out["mppi"] = plans

    # the reference's two render-on workloads (bench.py:118-160, :304-309):
    # a rollout of random actions, a step then a render, 3 rounds of 5 steps
    renders = {}
    for kind, B, side in (("sawyer_impedance_render200", 128, 200), ("cursor_render500", 32, 500)):
        env = (ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device=dev)
               if kind.startswith("sawyer") else CursorEnv(EnvConfig(), device=dev))
        rf = make_render_fn(env, frontview(side, side))
        gen.manual_seed(1)
        st = env.step_batch(reset(env, B, 1), rand(B, env))[0]
        rf(st)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rounds = []
        for _ in range(3):
            marks = []
            for _ in range(5):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                st = env.step_batch(st, rand(B, env))[0]
                ev[1].record()
                rf(st)
                ev[2].record()
                marks.append(ev)
            torch.cuda.synchronize()
            rounds.append((sum(e[0].elapsed_time(e[1]) for e in marks) / 5,
                           sum(e[1].elapsed_time(e[2]) for e in marks) / 5))
        steps, frames = sorted(r[0] for r in rounds), sorted(r[1] for r in rounds)
        renders[kind] = {"batch": B, "side": side, "step_ms": steps[1], "render_ms": frames[1],
                         "step_ms_rounds": steps, "render_ms_rounds": frames,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        report(f"render rollout {kind}", renders[kind])
    out["render"] = renders
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-tests", action="store_true", help="the timings alone, without the card tests")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path[:0] = [HERE, TESTS]
    import furniture_tpu_torch as ft

    if not os.path.abspath(ft.__file__).startswith(os.path.join(HERE, "furniture_tpu_torch")):
        fail(f"imported the port from {ft.__file__}, not from this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card, watts = card_name_and_limit()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}", flush=True)
    tests = None if opts.no_tests else run_card_tests()
    t0 = time.perf_counter()
    build()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {"free_part_megakernel": kernel1(dev, watts, sm_count), "arm_megakernel": kernel2(dev, watts, sm_count),
               "lane_solver": kernel3(dev, watts, sm_count), "arm_joint_dynamics": kernel4(dev, watts),
               "arm_ik": kernel5(dev, watts), "connect": kernel6(dev)}
    sources = ("megakernel.cu", "arm_megakernel.cu", "lane_solver.cu", "arm_dynamics.cu", "arm_ik.cu",
               "assembly.cu")
    timed_paths = paths(dev)
    print(f"{card} | {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "source": f"furniture_tpu_torch/physics/csrc/{src}", **rec}
        for (name, rec), src in zip(kernels.items(), sources)], "paths": timed_paths}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
              "power_limit_w": watts}
    print(json.dumps({"ok": True, "card_tests": tests, "device": device}), flush=True)


if __name__ == "__main__":
    main()
