"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``furniture_tpu_torch``; nothing of JAX or of the JAX
package is imported) on the card:

1. build: compiles every CUDA kernel of the port from the sources in the
   checkout (one ``nvcc`` per source, started together: the free-part
   kernel ``megakernel.cu`` and the arm kernel ``arm_megakernel.cu``, both
   on the shared header ``physics_common.cuh``) and prints the
   ``-Xptxas -v`` report;
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
   held to 10x it where that exceeds the bound.
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
   where the part is gripped;
3. main paths, each with the launch counts set to 0 before it and read
   after it: ``make_vec_env("IKEACursor-v0", num_envs=4096)``, reset and 20
   steps of uniform random actions; ``make_vec_env("IKEASawyer-v0",
   num_envs=512, control_type="impedance")`` and the same id with
   ``control_type="ik"`` at 256 envs, reset and 20 steps each. The counts
   must be what the code implies (the settle launches of the free-part
   kernel; one arm-kernel launch per impedance step, ``action_repeat`` = 3
   per ik step); the state must stay finite and in range, and a small batch
   must agree with the port's CPU run (the plain versions);
4. times with CUDA events after a warm-up: env steps/s of ``step_batch``
   for the cursor (B = 4096) and for Sawyer impedance (B = 512) and ik
   (B = 256), each kernel's ms per launch at n = 50, its plain version's
   ms, and the bound from its bytes and FP32 operations; for the Sawyer
   step also ``joint_dyn_matrices`` and the IK solve.

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
STEPS = 20
ARM_RUNS = (("impedance", 512), ("ik", 256))   # bench.py's Sawyer sizes


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def max_err(a, b) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a, b))


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
    from furniture_tpu_torch.physics import arm_megakernel, megakernel
    from furniture_tpu_torch.robots import kinematics as K
    from furniture_tpu_torch.physics.state import PartState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card, watts = card_name_and_limit()
    print(f"card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}", flush=True)

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    sources = [megakernel.SOURCE, arm_megakernel.SOURCE]
    procs = [_cuda.start_build(s) for s in sources]
    for p in procs:
        _cuda.finish_build(p)
    for s in sources:
        print(f"[build] {os.path.relpath(s, HERE)} ({time.perf_counter() - t0:.1f} s):")
        for line in _cuda.build_log(s).splitlines():
            if "ptxas" in line:
                print("   ", line.strip())
    megakernel.library()
    arm_megakernel.library()

    # -- 2. kernel vs plain -------------------------------------------------------
    worst = 0.0   # over the checks held at their stated bounds
    spread_cases = []
    gen = torch.Generator(device=dev)

    def hold(env, parts, group, gscale, tag, checks=((5, 1e-4), (50, 1e-3)), chaotic_at=()):
        """Kernel vs plain after n substeps within tol, for each (n, tol)
        of ``checks``. Where n is in ``chaotic_at`` the motion is chaotic:
        there the plain version's own spread under a 1e-7 input
        perturbation is measured and the kernel is held to 10x that spread
        where it exceeds tol."""
        nonlocal worst
        phys = env.physics
        for n, tol in checks:
            ref = phys.plain_substeps(parts, group, gscale, n)
            out = phys.kernel_substeps(parts, group, gscale, n)
            torch.cuda.synchronize()
            for name, b in zip(PartState._fields, out):
                if not torch.isfinite(b).all():
                    fail(f"{tag} n={n}: kernel {name} not finite")
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
            print(f"[check] {tag} n={n}: max|kernel-plain| {err:.3g} (bound {tol:.3g}{note}) {per}",
                  flush=True)
            if not err <= tol:
                fail(f"{tag} n={n}: kernel disagrees with its plain version ({err} > {tol})")

    for name in ("table_lack_0825", "chair_balser_0115"):
        env = CursorEnv(EnvConfig(furniture_name=name), device=dev)
        gen.manual_seed(0)
        state = env.reset_batch(CHECK_B, gen)
        P = env._P
        nf, smem, in_smem = env.physics.lane_buffer()
        print(f"[check] {name}: P={P} K={env.physics.K} lane working set in "
              f"{'shared memory' if in_smem else 'global scratch'} ({smem} B shared/block)")
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
    arm_worst = 0.0      # over the checks held at their stated bounds
    arm_spread_cases = []
    ARM_FIELDS = PartState._fields + ("qpos", "qvel")

    def arm_inputs(env, state, ctrl, n):
        B = ctrl.shape[0]
        G1, G2 = K.joint_dyn_matrices(env.robot, state.qpos, env.config.sim.timestep)
        return (
            PartState(*(t.contiguous() for t in state.parts)), state.group,
            torch.ones((B, env._P), device=dev), state.qpos, state.qvel, ctrl,
            torch.zeros((B, env.robot.nj), device=dev), G1.contiguous(), G2.contiguous(), n,
        )

    def per_env(a, b):
        """max |a - b| per env and field: {field: [B]}."""
        B = a[1].shape[0]
        pairs = list(zip(a[0], b[0])) + [(a[1], b[1]), (a[2], b[2])]
        return {f: (x - y).abs().reshape(B, -1).amax(-1) for f, (x, y) in zip(ARM_FIELDS, pairs)}

    def hold_arm(env, state, ctrl, tag, checks, pinched, want_touch):
        """Arm kernel vs plain after n substeps for each (n, tol). A
        ``pinched`` case is ill-conditioned in a few envs: its median over
        the envs is held to tol, at most a tenth of the envs may exceed tol,
        and its maximum is held to 10x the plain version's own spread under
        position noise."""
        nonlocal arm_worst
        ph = env.physics
        for n, tol in checks:
            args = arm_inputs(env, state, ctrl, n)
            ref = ph.plain_control_step(*args)
            out = ph.kernel_control_step(*args)
            torch.cuda.synchronize()
            for t in list(out[0]) + [out[1], out[2]]:
                if not torch.isfinite(t).all():
                    fail(f"{tag} n={n}: arm kernel output not finite")
            errs = per_env(ref, out)
            err = max(v.max().item() for v in errs.values())
            med = max(v.median().item() for v in errs.values())
            n_touch = int(out[3].sum())
            if not torch.equal(ref[3], out[3]):
                fail(f"{tag} n={n}: touch flags differ between arm kernel and plain version")
            if want_touch and n_touch == 0:
                fail(f"{tag} n={n}: no touch flag set")
            note = ""
            bound = tol
            if pinched:
                # the plain version's own spread: three draws of position
                # noise at 1e-7 and at 1e-6. One substep of summing ~1000
                # lanes in another order already moves the velocities by up
                # to 7e-5 (the n = 1 checks), which 1e-7 of position noise
                # does not always reproduce
                spreads = {}
                for mag in (1e-7, 1e-6):
                    worst_sp = 0.0
                    for seed in (7, 8, 9):
                        g2 = torch.Generator(device=dev)
                        g2.manual_seed(seed)
                        eps = (torch.rand(args[0].pos.shape, generator=g2, device=dev) - 0.5) * 2 * mag
                        ref2 = ph.plain_control_step(args[0]._replace(pos=args[0].pos + eps), *args[1:])
                        worst_sp = max(worst_sp, max(v.max().item() for v in per_env(ref, ref2).values()))
                    spreads[mag] = worst_sp
                spread = max(spreads.values())
                bound = max(tol, 10 * spread)
                over = int((torch.stack(list(errs.values())).amax(0) > tol).sum())
                arm_spread_cases.append((f"{tag} n={n}", err, med, spreads[1e-7], spreads[1e-6], over))
                note = (f", median over envs {med:.3g} (bound {tol:.3g}), {over} of {CHECK_B} envs over "
                        f"{tol:.3g}, plain vs plain(pos + noise) {spreads[1e-7]:.3g} at 1e-7 and "
                        f"{spreads[1e-6]:.3g} at 1e-6")
                if not med <= tol:
                    fail(f"{tag} n={n}: median error {med} > {tol}")
                if over > CHECK_B // 10:
                    fail(f"{tag} n={n}: {over} envs over {tol}")
                arm_worst = max(arm_worst, med)
            else:
                arm_worst = max(arm_worst, err)
            per = {f: round(v.max().item(), 9) for f, v in errs.items()}
            print(f"[check] arm {tag} n={n}: max|kernel-plain| {err:.3g} (bound {bound:.3g}{note}), "
                  f"touch flags equal, {n_touch} set {per}", flush=True)
            if not err <= bound:
                fail(f"{tag} n={n}: arm kernel disagrees with its plain version ({err} > {bound})")

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
          f"{'shared memory' if in_smem else 'global scratch'} ({smem} B shared/block)")
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

    # -- 3. main path -----------------------------------------------------------
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
    for t in s.parts:
        if not torch.isfinite(t).all():
            fail("main path state not finite")
    P, W = env._P, env._W
    checks = {
        "group": ((s.group >= 0) & (s.group < P)).all(),
        "selected": ((s.selected >= -1) & (s.selected < P)).all(),
        "num_connected": ((s.num_connected >= 0) & (s.num_connected <= W)).all(),
        "connect_step": ((s.connect_step >= 0) & (s.connect_step <= env.config.num_connect_steps)).all(),
        "subtask": ((s.subtask >= -1) & (s.subtask < P)).all(),
        "t": ((s.t >= 0) & (s.t <= STEPS)).all(),
        "cursor": (s.cursor_pos.abs() <= env.config.cursor_boundary).all(),
        "quat_norm": ((s.parts.quat.norm(dim=-1) - 1).abs() < 1e-3).all(),
    }
    bad = [k for k, v in checks.items() if not bool(v)]
    if bad:
        fail(f"main path state out of range: {bad}")
    print(f"[main] state finite and in range; mean reward of last step {rew.mean().item():.4f}")

    # a small batch through the card and through the CPU (plain version)
    from furniture_tpu_torch.convert import cursor_state_from_numpy, cursor_state_to_numpy

    cpu_env = CursorEnv(EnvConfig(), device="cpu")
    gen.manual_seed(2)
    st_gpu = env.reset_batch(8, gen)
    st_cpu = cursor_state_from_numpy(cursor_state_to_numpy(st_gpu), "cpu")
    for i in range(3):
        a = actions[i][:8]
        st_gpu, _, r_gpu, d_gpu, _ = env.step_batch(st_gpu, a)
        st_cpu, _, r_cpu, d_cpu, _ = cpu_env.step_batch(st_cpu, a.cpu())
    g, c = cursor_state_to_numpy(st_gpu), cursor_state_to_numpy(st_cpu)
    for k in ("group", "selected", "num_connected", "connect_step", "t"):
        if not np.array_equal(g[k], c[k]):
            fail(f"small batch: {k} differs between card and CPU")
    err_small = max(float(np.abs(g[k] - c[k]).max()) for k in ("pos", "quat", "lin_vel", "ang_vel"))
    print(f"[main] B=8, 3 steps: card vs CPU plain version max|diff| {err_small:.3g} (bound 1e-3)")
    if not err_small <= 1e-3:
        fail(f"small batch: card and CPU differ by {err_small}")

    # -- 3b. arm main paths ---------------------------------------------------
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

    # -- 4. times ---------------------------------------------------------------
    env = vec.env
    gen.manual_seed(3)
    state = env.reset_batch(MAIN_B, gen)
    for a in actions[:3]:
        state, *_ = env.step_batch(state, a)  # warm-up
    holder = [state]

    def step_once(it=iter(range(10**9))):
        holder[0] = env.step_batch(holder[0], actions[next(it) % STEPS])[0]

    step_ms = cuda_ms(step_once, STEPS)
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
    print(f"[time] step_batch B={MAIN_B}: {step_ms:.3f} ms/step, {steps_per_s:.1f} env steps/s")
    print(f"[time] kernel n={n} B={MAIN_B}: {kernel_ms:.4f} ms/launch; plain version "
          f"{plain_ms:.3f} ms; kernel share of a step {kernel_ms / step_ms:.3f}")
    print(f"[time] bound: {ops:.4g} FP32 ops -> {t_ops:.4f} ms at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s "
          f"({t_ops / scale:.4f} ms scaled to {watts:g} W); {nbytes} B -> {t_bytes:.5f} ms at "
          f"{PEAK_HBM_BYTES / 1e12:g} TB/s; kernel at {bound_ms / kernel_ms:.4f} of its bound")
    print("[time] library_ms: null (no single PyTorch call computes this function)")

    # -- 4b. arm times ----------------------------------------------------------
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

        ms = cuda_ms(arm_step_once, 10)
        arm_step[control_type] = (ms, nb / (ms / 1e3))
        print(f"[time] Sawyer {control_type} step_batch B={nb}: {ms:.3f} ms/step, "
              f"{nb / (ms / 1e3):.1f} env steps/s")
    avec, acts = arm_vecs["impedance"]
    aenv, aB = avec.env, ARM_RUNS[0][1]
    aph = aenv.physics
    astate = aenv.reset_batch(aB, gen)
    for a in acts[:2]:
        astate, *_ = aenv.step_batch(astate, a)
    ctrl = aenv._direct_ctrl(acts[2][:, :-1])
    an = aenv.config.n_substeps
    aargs = arm_inputs(aenv, astate, ctrl, an)
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

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "free_part_megakernel",
        "route": "cuda",
        "source": "furniture_tpu_torch/physics/csrc/megakernel.cu",
        "replaces": "furniture_tpu/physics/megakernel.py:428",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bound_ms_at_power_limit": bound_ms / scale,
        "ill_conditioned_checks": [
            {"case": t, "max_abs_err": e, "plain_spread": sp} for t, e, sp in spread_cases
        ],
        "step_ms": step_ms,
        "env_steps_per_s": steps_per_s,
        "launches_on_arm_paths": free_launches_arm,
    }, {
        "name": "arm_megakernel",
        "route": "cuda",
        "source": "furniture_tpu_torch/physics/csrc/arm_megakernel.cu",
        "replaces": "furniture_tpu/physics/arm_megakernel.py:459",
        "launches": arm_launches["impedance"] + arm_launches["ik"],
        "max_abs_err": arm_worst,
        "ms": arm_kernel_ms,
        "plain_ms": arm_plain_ms,
        "bound_ms": arm_bound_ms,
        "bound_by": arm_bound_by,
        "library_ms": None,
        "bound_ms_at_power_limit": arm_bound_ms / scale,
        "launches_by_path": arm_launches,
        "ill_conditioned_checks": [
            {"case": t, "max_abs_err": e, "median_abs_err": m, "plain_spread_1e-7": s7,
             "plain_spread_1e-6": s6, "envs_over_bound": over}
            for t, e, m, s7, s6, over in arm_spread_cases
        ],
        "step_ms": {k: v[0] for k, v in arm_step.items()},
        "env_steps_per_s": {k: v[1] for k, v in arm_step.items()},
        "joint_dyn_matrices_ms": dyn_ms,
        "ik_prepare_ms": ik_ms,
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
