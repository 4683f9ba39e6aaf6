"""PyTorch port: the scripted demo generator on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card. A
first connect from reset takes about 210 scripted steps at the default
``SimConfig`` (50 substeps a control step), too long for the CPU plain
versions; so do a rollout at ``tools/generate_demos.py``'s batch and a
staged connect. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gen_gpu.py
"""

import os

import numpy as np
import pytest
import torch
from torch_gpu_holds import card, float64_twin, p90_gap


@pytest.mark.gpu
def test_generate_demos_first_connect(tmp_path):
    """``generate_demos(1, batch=16, max_steps=360)`` with ``num_connects=1``
    through the CLI's function: at least one scripted episode connects a
    leg, its demo is saved and reads back through ``load_demo`` and the
    trajectory store, the stats keep their schema, and restoring its
    pre-connect state and stepping the recorded action reproduces the
    connect."""
    card()
    from furniture_tpu_torch.config import EnvConfig
    from furniture_tpu_torch.envs.sawyer_gen import FurnitureSawyerGenEnv
    from furniture_tpu_torch.tools.generate_demos import generate
    from furniture_tpu_torch.utils.demo import load_demo
    from furniture_tpu_torch.utils.traj_store import TrajStore

    store = str(tmp_path / "demos.ftr")
    demos, stats = generate(n_demos=1, batch=16, seed=0, max_steps=360, num_connects=1,
                            out=store, demo_dir=str(tmp_path))
    assert demos, f"no first-connect demo in 360 steps (stats {stats})"
    assert stats["success_rate"] > 0 and stats["n_demos_saved"] == 1
    want = {"batch": int, "max_steps": int, "seed": int, "success_rate": float,
            "connect_histogram": list, "mean_num_connected": float,
            "first_success_steps": list, "furniture_name": str, "n_demos_saved": int}
    assert {k: type(v) for k, v in stats.items()} == want
    assert sum(stats["connect_histogram"]) == 16 and stats["max_steps"] == 360
    demo = demos[0]
    assert demo["num_connected"] >= 1
    saved = load_demo(os.path.join(tmp_path, "Sawyer_table_lack_0825_0000.pkl"))
    assert len(saved["obs"]) == len(saved["actions"]) + 1 == len(demo["actions"]) + 1
    with TrajStore(store, "r") as ts:
        actions, rewards, _ = ts.read(0)
    np.testing.assert_array_equal(actions, demo["actions"])

    nconn = np.array([int(s["num_connected"]) for s in demo["states"]])
    t_conn = int(np.argmax(nconn >= 1)) - 1       # the action that connected
    assert demo["connect_actions"][t_conn], "the connect step has no connect bit"
    env = FurnitureSawyerGenEnv(EnvConfig(agent_type="Sawyer", control_type="ik", num_connects=1))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    state = env.restore_snapshot(env.reset_batch(1, gen), demo["states"][t_conn])
    action = torch.as_tensor(demo["actions"][t_conn], device="cuda")[None]
    state = env.step_batch(state, action)[0]
    assert int(state.num_connected[0]) == int(nconn[t_conn + 1]), (
        "the recorded connect did not reproduce under state replay"
    )


@pytest.mark.gpu
def test_generator_rollout_and_ik_kernel():
    """``make_vec_env("IKEASawyerGen-v0")`` (ik, default ``SimConfig``) at
    128 envs: ``reset_batch`` and 30 steps of ``scripted_action`` +
    ``step_batch`` launch kernel 1 10 times (the reset), kernel 2 3 times a
    step and kernel 5 once a step; state, reward and action finite, no env
    unstable, some env past the phase it started in. Then kernel 5 at the
    generator's last state and action, one launch: no further from the
    float64 truth (the plain version on the CPU) than 4x the plain float32
    path, by the rows' 90th percentile of their largest gap."""
    import furniture_tpu_torch as ft
    from furniture_tpu_torch.controllers.ik import ik_prepare

    dev = card()
    B, steps = 128, 30
    env = ft.make_vec_env("IKEASawyerGen-v0", num_envs=B, seed=0).env
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for c in (env.physics, env.physics.free, env.ik):
        c.launches = 0
    state = env.reset_batch(B, gen)
    pol = env.init_policy_state(state, gen)
    start_phase = pol.phase.clone()
    left_start = torch.zeros_like(start_phase, dtype=torch.bool)
    for _ in range(steps):
        action, pol = env.scripted_action(pol, state)
        state, _, rew, _, info = env.step_batch(state, action)
        left_start |= pol.phase != start_phase
    assert (env.physics.launches, env.physics.free.launches, env.ik.launches) == (
        env.config.action_repeat * steps, 10, steps)
    for t in list(state.parts) + [state.qpos, state.qvel, rew, action]:
        assert bool(torch.isfinite(t).all())
    assert not bool(info["unstable"].any())
    assert bool(left_start.any()), "no env left the phase it started in"
    ik = env.ik
    args = (state.qpos.contiguous(), state.ik_target_pos.contiguous(),
            state.hand_quat_init.contiguous(), action.contiguous())
    got = ik.prepare(*args)
    assert ik.launches == steps + 1
    plain = ik_prepare(env.robot, ik.control_type, ik.move_speed, ik.rotate_speed, *ik.box, *args)
    truth = ik_prepare(float64_twin(env.robot), ik.control_type, ik.move_speed, ik.rotate_speed,
                       *(b.cpu().double() for b in ik.box), *(x.cpu().double() for x in args))
    for name, g, p, t in zip(("ik_target_pos", "hand_quat_init", "q_cmd"), got, plain, truth):
        assert p90_gap(g, t) <= 4 * p90_gap(p, t), name


@pytest.mark.gpu
def test_staged_connect_and_its_replay():
    """8 generator envs with the first recipe leg placed between the fingers
    and 8 closing steps hold it; from ``ALIGN_CONN`` the scripted policy
    connects it in some env within 250 steps; that env's pre-connect state,
    restored with ``restore_snapshot`` and stepped with the recorded
    action, connects again."""
    import furniture_tpu_torch as ft
    from furniture_tpu_torch.envs import sawyer_gen as SG
    from furniture_tpu_torch.robots import kinematics as K

    dev = card()
    B = 8
    env = ft.make_vec_env("IKEASawyerGen-v0", num_envs=B, seed=0).env
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    state = env.reset_batch(B, gen)
    grip_pos, _ = K.site_world(env.robot, K.fk(env.robot, state.qpos), "right")
    leg = int(env._st["leg"][0])
    sub0 = torch.zeros(B, dtype=torch.long, device=dev)
    gl = env._site_pos(state.parts, env._stt["gl"][sub0])
    gr = env._site_pos(state.parts, env._stt["gr"][sub0])
    pos = state.parts.pos.clone()
    pos[:, leg] += grip_pos - 0.5 * (gl + gr)
    state = state._replace(parts=state.parts._replace(pos=pos))
    close = torch.zeros((B, env.dof), device=dev)
    close[:, 6] = 1.0
    for _ in range(8):
        state = env.step_batch(state, close)[0]
    assert bool((state.touch_l[:, 0, leg] & state.touch_r[:, 0, leg]).any()), "the gripper held the leg nowhere"
    pol = env.init_policy_state(state, gen)
    pol = pol._replace(phase=torch.full_like(pol.phase, SG.ALIGN_CONN))
    for _ in range(250):
        action, pol = env.scripted_action(pol, state)
        before = state
        state = env.step_batch(state, action)[0]
        if bool((state.num_connected >= 1).any()):
            break
    assert bool((state.num_connected >= 1).any()), "no env connected in 250 policy steps"
    b = int(torch.nonzero(state.num_connected >= 1)[0, 0])
    snap = {k: v[b].cpu().numpy() for k, v in env.state_snap(before).items()}
    gen.manual_seed(7)
    replay = env.restore_snapshot(env.reset_batch(1, gen), snap)
    replay = env.step_batch(replay, action[b:b + 1])[0]
    assert int(replay.num_connected[0]) == int(state.num_connected[b])
