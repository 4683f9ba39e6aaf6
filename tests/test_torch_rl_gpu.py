"""PyTorch port: the RL stack and the multi-device layer on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_rl_gpu.py

* on the cursor (table_lack, default ``SimConfig``), with kernel 1's
  launches counted (10 more for each step with a done): PPO at
  ``PPOConfig()`` and a checkpoint round trip of its state on the card;
  SAC at ``SACConfig()``; one GAIL iteration; BC on the committed demos;
  ``make_evaluate`` at 64 episodes x 200 steps; ``train_rl.train``;
* the mesh: sharded MPPI (64 steps x 256 samples) at world size 1 on nccl
  against ``make_mppi`` on the same noise; then two ranks spawned on the
  one card with gloo over CUDA tensors (NCCL refuses two ranks on one
  device), each the same plan and one sharded PPO iteration at
  ``PPOConfig()`` with identical networks on both ranks; each path's
  kernel 1 held at its own recorded inputs.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch_gpu_holds import assert_held, card, recording

from furniture_tpu_torch import rl
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.parallel import make_mesh, mpi_min
from furniture_tpu_torch.planning import MPPIConfig, make_mppi, make_sharded_mppi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2 = 2 * 64             # PPOConfig().rollout_len steps, 2 launches of kernel 1 each
EVAL = 10 + 2 * 200     # a reset and 200 steps of make_evaluate's 64 episodes
WORLD, SPAWN_TIMEOUT_S = 2, 420


def resets_ok(got: int, base: int) -> bool:
    """``got`` launches are ``base`` and 10 for each reset of a done."""
    return got >= base and (got - base) % 10 == 0


def finite(metrics) -> bool:
    return all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.gpu
def test_ppo_and_its_checkpoint(tmp_path):
    """``PPOConfig()`` (256 envs x 64 steps): 20 launches to set up (the
    probe's and the lanes' resets), 128 an iteration, metrics finite; the
    state saved and loaded into a fresh one comes back on the card bit for
    bit (networks, optimizer, generator, env states)."""
    from furniture_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint

    card()
    env = CursorEnv(EnvConfig(), device="cuda")
    env.physics.launches = 0
    init, train = rl.make_ppo(env, rl.PPOConfig())
    st = init(0)
    assert env.physics.launches == 20
    for _ in range(2):
        env.physics.launches = 0
        st, m = train(st)
        assert resets_ok(env.physics.launches, T2) and finite(m), (env.physics.launches, m)
    save_checkpoint(str(tmp_path), st, st.step)
    back = load_checkpoint(latest_checkpoint(str(tmp_path)), init(7))
    assert back.step == st.step and str(back.env_states.parts.pos.device).startswith("cuda")
    for a, b in zip(st.params.state_dict().values(), back.params.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(st.generator.get_state(), back.generator.get_state())
    tensors = lambda s: [t for t in s.env_states if isinstance(t, torch.Tensor)] + list(s.env_states.parts)
    assert all(torch.equal(a, b) for a, b in zip(tensors(st), tensors(back)))
    sa, sb = st.opt_state.state_dict()["state"], back.opt_state.state_dict()["state"]
    for k in sa:
        assert sa[k]["count"] == sb[k]["count"]
        assert torch.equal(sa[k]["mu"], sb[k]["mu"]) and torch.equal(sa[k]["nu"], sb[k]["nu"])


@pytest.mark.gpu
def test_sac_gail_bc_and_evaluate():
    """20 SAC iterations at ``SACConfig()`` (64 envs; 16 of warm-up): 2
    launches an iteration, the buffer 1,280 transitions, metrics finite; one
    GAIL iteration on expert arrays of the cursor's widths from a seed (2
    discriminator updates, then PPO on its reward): 128 launches, the reward
    positive; BC on the committed demos: the loss falls over 5 epochs;
    ``make_evaluate`` at 64 episodes x 200 steps: 410 launches."""
    from furniture_tpu_torch.utils.demo import load_demo

    dev = card()
    env = CursorEnv(EnvConfig(), device=dev)
    phys = env.physics
    scfg = rl.SACConfig()
    sinit, strain = rl.make_sac(env, scfg)
    sst = sinit(1)
    phys.launches = 0
    warm = 0
    for _ in range(20):
        warm += sst.step * scfg.num_envs < scfg.warmup
        sst, sm = strain(sst)
    assert resets_ok(phys.launches, 2 * 20) and finite(sm)
    assert sst.buffer.size == 20 * 64 and warm == 16

    pcfg = rl.PPOConfig()
    pst = rl.make_ppo(env, pcfg)[0](0)
    rng = np.random.default_rng(0)
    obs_d = rl.obs_dim(env.observe(pst.env_states))
    e_obs = rng.standard_normal((1024, obs_d)).astype(np.float32)
    e_act = rng.uniform(-1, 1, (1024, env.dof)).astype(np.float32)
    g_init, disc_reward, disc_update, g_make_ppo = rl.make_gail(env, pcfg, rl.GAILConfig(), e_obs, e_act)
    ds, policy_seed = g_init(2)
    ginit, gtrain = g_make_ppo(env, pcfg, reward_fn=lambda o, a, r: disc_reward(ds.params)(o, a, r))
    gst = ginit(policy_seed)
    phys.launches = 0
    obs = rl.flatten_obs(env.observe(gst.env_states))
    with torch.no_grad():
        acts = gst.params["pi"].sample(obs, gst.generator)[0]
    _, dm = disc_update(ds, obs, acts)
    gst, gm = gtrain(gst)
    assert resets_ok(phys.launches, T2) and finite({**dm, **gm}) and float(gm["reward_per_step"]) > 0

    files = sorted(glob.glob(os.path.join(ROOT, "demos", "generated", "*.pkl")))
    X, Y = rl.demos_to_dataset([load_demo(fn) for fn in files])
    binit, bfit, bpredict = rl.make_bc(X.shape[-1], Y.shape[-1], rl.BCConfig(lr=3e-4), device=dev)
    Xd, Yd = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    bst, mses = binit(0), []
    for _ in range(5):
        bst, bm = bfit(bst, Xd, Yd)
        mses.append(float(bm["mse"]))
    assert mses[-1] < mses[0] and bpredict(bst.params, Xd[:64]).shape[0] == 64

    egen = torch.Generator(device=dev)
    egen.manual_seed(3)
    evaluate = rl.make_evaluate(env, rl.ppo_act, 64, 200)
    phys.launches = 0
    em = evaluate(pst.params, egen)
    assert phys.launches == EVAL and np.isfinite(float(em["mean_reward"]))


@pytest.mark.gpu
def test_train_rl_entry_point(tmp_path):
    """``train_rl.train`` for 2 PPO iterations at its defaults: 20 + 2 x 128
    + 410 launches and 10 for each reset of a done, the metrics lines of
    both iterations and of the evaluation, and ``result.json`` naming the
    card."""
    from furniture_tpu_torch.tools import train_rl

    card()
    args = train_rl.parse_args(["--algo", "ppo", "--iters", "2", "--run_dir", str(tmp_path)])
    _, tenv = train_rl.train(args)
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    result = json.load(open(tmp_path / "result.json"))
    assert resets_ok(tenv.physics.launches, 20 + 2 * T2 + EVAL), tenv.physics.launches
    assert [line["iter"] for line in lines] == [0, 1, "eval"]
    assert result["device"].startswith("cuda")


def _plan_inputs(dev):
    """The MPPI problem both mesh tests plan on: ``bench.py``'s planner env,
    one reset state, the zero mean and one draw of noise."""
    cfg = MPPIConfig(horizon=64, n_samples=256, sigma=0.3)
    env = CursorEnv(EnvConfig(sim=SimConfig(timestep=0.02, solver_iters=8)), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.reset_batch(1, gen)
    gen.manual_seed(7)
    noise = torch.randn((cfg.n_samples, cfg.horizon, env.dof), generator=gen, device=dev) * cfg.sigma
    return env, cfg, state, torch.zeros((cfg.horizon, env.dof), device=dev), noise


@pytest.mark.gpu
def test_sharded_mppi_world_size_1_nccl(tmp_path):
    """At world size 1 on nccl the sharded plan equals ``make_mppi``'s on the
    same noise within 1e-5, its best cost too, with 128 launches; kernel 1
    held at the last step's inputs of one more plan."""
    dev = card()
    dist.init_process_group("nccl", init_method="file://" + str(tmp_path / "store"), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device=dev)
        env, cfg, state, mean, noise = _plan_inputs(dev)
        splan = make_sharded_mppi(env, cfg, mesh)
        env.physics.launches = 0
        smean, sinfo = splan(state, mean, None, noise=noise)
        assert env.physics.launches == 128 and dist.get_backend() == "nccl"
        pmean, pinfo = make_mppi(env, cfg)(state, mean, None, noise=noise)
        assert (smean - pmean).abs().max().item() <= 1e-5
        best, plain_best = sinfo["best_cost"].item(), pinfo["best_cost"].item()
        assert abs(best - plain_best) <= 1e-5 * max(1.0, abs(plain_best))
        with recording(env, keep=2) as calls:
            splan(state, mean, None, noise=noise)
    finally:
        dist.destroy_process_group()
    assert_held(env.physics, calls, "sharded MPPI, world size 1")


def _flat_call(call):
    """A recorded call ``(parts, group, gscale, n)`` as tensors and an int,
    which ``torch.load`` reads with ``weights_only``."""
    return tuple(call[0]) + tuple(call[1:])


def _rank(rank: int, store: str, out_dir: str) -> None:
    """One of ``WORLD`` ranks on the one card (gloo over CUDA tensors): the
    sharded plan against ``make_mppi`` on the same noise, then one sharded
    PPO iteration at ``PPOConfig()``, the networks compared across ranks (a
    MIN and a MAX all-reduce); then one more plan and PPO rollout with the
    physics inputs of their last step recorded. Writes ``rank<r>.json`` and
    ``inputs<r>.pt`` to ``out_dir``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh(WORLD, backend="gloo", device=dev)
        env, cfg, state, mean, noise = _plan_inputs(dev)
        env.physics.launches = 0
        smean, _ = make_sharded_mppi(env, cfg, mesh)(state, mean, None, noise=noise)
        plan_launches = env.physics.launches
        pmean, _ = make_mppi(env, cfg)(state, mean, None, noise=noise)
        penv = CursorEnv(EnvConfig(), device=dev)
        init, train = rl.make_ppo(penv, rl.PPOConfig(), mesh=mesh)
        st = init(0)
        penv.physics.launches = 0
        st, m = train(st)
        flat = torch.cat([p.detach().reshape(-1) for p in st.params.parameters()])
        out = {"plan_err": (smean - pmean).abs().max().item(), "plan_launches": plan_launches,
               "ppo_launches": penv.physics.launches, "ppo_lanes": st.env_states.group.shape[0],
               "ppo_loss": float(m["loss"]), "ppo_reward_per_step": float(m["reward_per_step"]),
               "params_identical": (torch.equal(mpi_min(mesh, flat), flat)
                                    and torch.equal(-mpi_min(mesh, -flat), flat)),
               "params_sum": flat.double().sum().item()}
        with recording(env, keep=2) as mppi_calls:
            make_sharded_mppi(env, cfg, mesh)(state, mean, None, noise=noise)
        with recording(penv, keep=2) as ppo_calls:
            train.rollout(st.params, st.env_states, st.generator)
        torch.save({"mppi": [_flat_call(c) for c in mppi_calls], "ppo": [_flat_call(c) for c in ppo_calls]},
                   os.path.join(out_dir, f"inputs{rank}.pt"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card(tmp_path):
    """Each rank's sharded plan equals ``make_mppi``'s within 1e-5 (128
    launches); one sharded PPO iteration runs 128 lanes a rank with 128
    launches (10 more for each reset of a done), the loss finite, the
    networks identical on both ranks and the reduced metrics equal; kernel
    1 held at rank 0's recorded plan and rollout steps."""
    from furniture_tpu_torch.physics.state import PartState

    dev = card()
    ctx = mp.spawn(_rank, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(WORLD)]
    for r in ranks:
        assert r["plan_err"] <= 1e-5 and r["plan_launches"] == 128 and r["params_identical"], r
        assert r["ppo_lanes"] == 128 and resets_ok(r["ppo_launches"], 128) and np.isfinite(r["ppo_loss"]), r
    assert len({r["params_sum"] for r in ranks}) == 1
    assert len({r["ppo_reward_per_step"] for r in ranks}) == 1
    rank0 = torch.load(tmp_path / "inputs0.pt", map_location=dev)
    unflat = lambda c: (PartState(*c[:4]),) + tuple(c[4:])
    assert_held(_plan_inputs(dev)[0].physics, [unflat(c) for c in rank0["mppi"]], "sharded MPPI, rank 0")
    assert_held(CursorEnv(EnvConfig(), device=dev).physics, [unflat(c) for c in rank0["ppo"]],
                "sharded PPO, rank 0")
