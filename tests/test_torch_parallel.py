"""PyTorch port: the multi-device layer (``parallel.mesh``), sharded MPPI
and data-parallel PPO and GAIL, on two CPU processes joined by gloo.

One spawn of two ranks for the whole file (``torch.multiprocessing``, the
group met through a ``file://`` store under the test's temporary
directory, so that parallel test workers never share a port) runs every
multi-rank check; each rank writes what it saw, and the tests below read it.
A rank that fails, or a spawn that outlives its timeout, fails them all.

* the collectives: ``mpi_average``, ``mpi_sum``, ``mpi_min`` on known
  tensors; ``shard_batch`` then ``gather_batch`` round-trips;
* sharded MPPI (``horizon=3``, ``n_samples=4``, ``SimConfig(control_freq=
  100)``, a leg held by cursor 0) against the port's single-device plan on
  the same noise: the mean within 1e-6, ``best_cost`` exact, the same on
  both ranks; and against the JAX package's ``make_sharded_mppi`` on a
  2-device mesh of this suite's 8 host devices, the port fed the noise the
  JAX plan draws from its key: the mean within 1e-4, ``best_cost`` within
  1e-3 (``tests/test_torch_planning.py``'s bounds);
* PPO: one ``update`` (``epochs=1``, ``num_minibatches=1``) at world size
  2 over the two halves of fixed trajectories equals one at world size 1
  over the whole batch within 1e-5; after a full ``train_iter`` the
  networks are identical bit for bit on both ranks; the mirror of
  ``tests/test_rl.py:43-57`` (16 lanes, 2 steps, 2 minibatches: the loss
  finite, 16 lanes after ``gather_batch``);
* GAIL's discriminator stays identical on both ranks; ``train_rl --mesh 2``
  trains, only rank 0 writes, and it resumes from its checkpoint;
* ``make_mesh`` without a process group raises, also for one device.
"""

import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from furniture_tpu_torch import rl
from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.convert import cursor_state_from_numpy, cursor_state_to_numpy
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.parallel import (
    gather_batch,
    make_mesh,
    mpi_average,
    mpi_min,
    mpi_sum,
    shard_batch,
)
from furniture_tpu_torch.planning import MPPIConfig, make_mppi, make_sharded_mppi
from furniture_tpu_torch.rl.ppo import Transition, gae, probe_dims

torch.set_num_threads(1)

WORLD = 2
H, S, SIGMA = 3, 4, 0.3
SPAWN_TIMEOUT_S = 300
MPPI = MPPIConfig(horizon=H, n_samples=S, sigma=SIGMA)
PPO_FIXED = rl.PPOConfig(num_envs=4, rollout_len=2, epochs=1, num_minibatches=1, hidden=(16, 16))
PPO_MIRROR = rl.PPOConfig(num_envs=16, rollout_len=2, epochs=1, num_minibatches=2, hidden=(16, 16))


def _flat(module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def _fixed_traj(obs_d: int, act_d: int, seed: int = 0):
    """Trajectories [T=2, B=4] from a numpy seed, with a done in one lane."""
    rng = np.random.default_rng(seed)
    T, B = PPO_FIXED.rollout_len, PPO_FIXED.num_envs
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    done = torch.zeros(T, B, dtype=torch.bool)
    done[0, 1] = True
    traj = Transition(f(T, B, obs_d), torch.from_numpy(rng.uniform(-1, 1, (T, B, act_d)).astype(np.float32)),
                      f(T, B), f(T, B), f(T, B), done)
    adv, ret = gae(traj, f(B), PPO_FIXED.gamma, PPO_FIXED.lam)
    return traj, adv, ret


def _worker(rank: int, init_file: str, out_dir: str, inputs: dict):
    """One rank: every multi-rank check, its observations pickled to
    ``out_dir/rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        mesh = make_mesh(WORLD, device="cpu")
        out["mesh"] = (mesh.rank, mesh.world_size, str(mesh.device))
        for bad in (dict(n_devices=3, device="cpu"), dict(backend="nccl", device="cpu")):
            try:
                make_mesh(**bad)
                out.setdefault("mesh_raises", []).append(False)
            except ValueError:
                out.setdefault("mesh_raises", []).append(True)

        # the collectives
        x = torch.tensor([rank + 1.0, 10.0 * (rank + 1)])
        out["avg"], out["sum"], out["min"] = (f(mesh, x).tolist() for f in (mpi_average, mpi_sum, mpi_min))
        tree = {"a": torch.arange(24.0).reshape(8, 3),
                "b": (torch.arange(8) % 3 == 0, torch.arange(8, dtype=torch.int32))}
        mine = shard_batch(mesh, tree)
        back = gather_batch(mesh, mine)
        out["shard_rows"] = mine["a"][:, 0].tolist()
        out["round_trip"] = (torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])
                             and torch.equal(back["b"][1], tree["b"][1]) and back["b"][0].dtype == torch.bool)

        # sharded MPPI against the single-device plan, on the JAX draw
        env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
        state = cursor_state_from_numpy(inputs["staged"], "cpu")
        mean, noise = torch.from_numpy(inputs["mean"]), torch.from_numpy(inputs["noise"])
        smean, sinfo = make_sharded_mppi(env, MPPI, mesh)(state, mean, None, noise=noise)
        pmean, pinfo = make_mppi(env, MPPI)(state, mean, None, noise=noise)
        out["mppi"] = {"mean": smean.numpy(), "best": sinfo["best_cost"].item(),
                       "plain_mean": pmean.numpy(), "plain_best": pinfo["best_cost"].item(),
                       "costs_spread": (pinfo["costs"].max() - pinfo["costs"].min()).item()}
        g = torch.Generator().manual_seed(3)                        # the plan's own draw
        out["mppi_drawn"] = make_sharded_mppi(env, MPPI, mesh)(state, mean, g)[0].numpy()

        # PPO: world size 2 over halves against world size 1 over the whole
        penv = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100, solver_iters=2)), device="cpu")
        traj, adv, ret = _fixed_traj(*probe_dims(penv))
        init1, train1 = rl.make_ppo(penv, PPO_FIXED)
        init2, train2 = rl.make_ppo(penv, PPO_FIXED, mesh=mesh)
        st1, st2 = init1(0), init2(0)
        out["init_same"] = torch.equal(_flat(st1.params), _flat(st2.params))
        out["lanes_per_rank"] = st2.env_states.parts.pos.shape[0]
        half = slice(rank * 2, rank * 2 + 2)
        train1.update(st1.params, st1.opt_state, traj, adv, ret, st1.generator)
        train2.update(st2.params, st2.opt_state, Transition(*(x[:, half] for x in traj)),
                      adv[:, half], ret[:, half], st2.generator)
        out["update_gap"] = (_flat(st1.params) - _flat(st2.params)).abs().max().item()
        out["update_moved"] = (_flat(st1.params) - _flat(init1(0).params)).abs().max().item()
        st2, m = train2(st2)
        flat = _flat(st2.params)
        out["iter_params"] = flat.numpy()
        out["iter_min_max_equal"] = (torch.equal(mpi_min(mesh, flat), flat)
                                     and torch.equal(-mpi_min(mesh, -flat), flat))
        out["iter_metrics"] = {k: float(v) for k, v in m.items()}

        # the mirror of tests/test_rl.py:43-57
        init16, train16 = rl.make_ppo(penv, PPO_MIRROR, mesh=mesh)
        st16, m16 = train16(init16(1))
        out["mirror_loss"] = float(m16["loss"])
        out["mirror_lanes"] = gather_batch(mesh, st16.env_states).parts.pos.shape[0]
        out["mirror_step"] = st16.step

        # GAIL: the discriminator on rank-dependent policy batches
        rng = np.random.default_rng(rank)
        obs_d, act_d = probe_dims(penv)
        e_obs = np.random.default_rng(9).standard_normal((32, obs_d)).astype(np.float32)
        e_act = np.random.default_rng(10).uniform(-1, 1, (32, act_d)).astype(np.float32)
        g_init, _, disc_update, g_make_ppo = rl.make_gail(
            penv, PPO_FIXED, rl.GAILConfig(hidden=(16, 16), batch_size=8), e_obs, e_act, mesh=mesh)
        ds, _ = g_init(0)
        ds, dm = disc_update(ds, torch.from_numpy(rng.standard_normal((4, obs_d)).astype(np.float32)),
                             torch.from_numpy(rng.uniform(-1, 1, (4, act_d)).astype(np.float32)))
        out["disc_params"] = _flat(ds.params).numpy()
        out["gail_make_ppo_mesh"] = g_make_ppo.keywords.get("mesh") is mesh

        # the entry point
        from furniture_tpu_torch.tools import train_rl

        argv = ["--algo", "ppo", "--platform", "cpu", "--mesh", str(WORLD), "--num_envs", "4",
                "--rollout_len", "2", "--eval_episodes", "0", "--run_dir", inputs["run_dir"]]
        result, _ = train_rl.train(train_rl.parse_args(argv + ["--iters", "1"]))
        out["train_rl"] = result
        dist.barrier()                                  # rank 0's checkpoint is on disk
        result, _ = train_rl.train(train_rl.parse_args(argv + ["--iters", "2", "--resume"]))
        out["train_rl_resumed"] = result

        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _staged(env) -> dict:
    """One env with cursor 0 holding leg 1 at z = 0.1 (the state of
    ``tests/test_torch_planning.py``)."""
    d = cursor_state_to_numpy(env.reset_batch(1, torch.Generator().manual_seed(0)))
    d["pos"][0, 1, 2] = 0.1
    d["cursor_pos"][0, 0] = d["pos"][0, 1]
    d["selected"][0] = [1, -1]
    return d


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax

    env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
    mean = np.zeros((H, env.dof), np.float32)
    mean[:, 6] = 0.5
    key = jax.random.PRNGKey(5)
    return {
        "staged": _staged(env),
        "mean": mean,
        "key": key,
        # what the JAX plan draws from the key (furniture_tpu/planning/mppi.py:157)
        "noise": np.array(jax.random.normal(key, (S, H, env.dof)) * SIGMA),
        "run_dir": str(tmp_path_factory.mktemp("train_rl")),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' observations, from one spawn."""
    base = tmp_path_factory.mktemp("ranks")
    sent = {k: v for k, v in inputs.items() if k != "key"}
    ctx = mp.spawn(_worker, args=(str(base / "store"), str(base), sent), nprocs=WORLD, join=False)
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
    out = []
    for r in range(WORLD):
        with open(base / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_make_mesh_without_a_group_raises(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert not dist.is_initialized()
    for kwargs in ({}, {"n_devices": 1, "device": "cpu"}, {"n_devices": 2, "device": "cpu"}):
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh(**kwargs)
    assert not dist.is_initialized()


def test_mesh_and_collectives(ranks):
    for r, out in enumerate(ranks):
        assert out["mesh"] == (r, WORLD, "cpu")
        assert out["mesh_raises"] == [True, True]
        assert out["avg"] == [1.5, 15.0] and out["sum"] == [3.0, 30.0] and out["min"] == [1.0, 10.0]
        assert out["shard_rows"] == [12.0 * r + 3.0 * i for i in range(4)]
        assert out["round_trip"]


def test_sharded_mppi_matches_single_device_plan(ranks):
    for out in ranks:
        m = out["mppi"]
        assert np.abs(m["mean"] - m["plain_mean"]).max() < 1e-6
        assert m["best"] == m["plain_best"]
        assert m["costs_spread"] > 1e-3            # the held leg was carried
    assert np.array_equal(ranks[0]["mppi"]["mean"], ranks[1]["mppi"]["mean"])
    assert np.array_equal(ranks[0]["mppi_drawn"], ranks[1]["mppi_drawn"])


def test_sharded_mppi_matches_jax(ranks, inputs):
    import jax
    import jax.numpy as jnp

    from furniture_tpu.config import EnvConfig as JEnvConfig, SimConfig as JSimConfig
    from furniture_tpu.envs.cursor import CursorEnv as JCursorEnv
    from furniture_tpu.parallel.mesh import make_mesh as jmake_mesh
    from furniture_tpu.planning import mppi as jmppi

    jenv = JCursorEnv(JEnvConfig(sim=JSimConfig(control_freq=100)))
    d = inputs["staged"]
    like = jenv._initial_state(jenv._sample_parts(jax.random.PRNGKey(0)))
    parts = like.parts._replace(**{f: jnp.asarray(d[f][0], jnp.float32)
                                   for f in ("pos", "quat", "lin_vel", "ang_vel")})
    jstate = like._replace(parts=parts, **{f: jnp.asarray(d[f][0], getattr(like, f).dtype)
                                           for f in like._fields if f != "parts"})
    plan = jmppi.make_sharded_mppi(jenv, jmppi.MPPIConfig(horizon=H, n_samples=S, sigma=SIGMA),
                                   jmake_mesh(WORLD))
    jmean, jinfo = jax.jit(plan)(jstate, jnp.asarray(inputs["mean"]), inputs["key"])
    for out in ranks:
        assert np.abs(np.asarray(jmean) - out["mppi"]["mean"]).max() < 1e-4
        assert abs(float(jinfo["best_cost"]) - out["mppi"]["best"]) < 1e-3


def test_ppo_two_ranks_match_one(ranks):
    for out in ranks:
        assert out["init_same"] and out["lanes_per_rank"] == 2
        assert out["update_moved"] > 1e-4
        assert out["update_gap"] < 1e-5


def test_ppo_iteration_keeps_ranks_identical(ranks):
    assert np.array_equal(ranks[0]["iter_params"], ranks[1]["iter_params"])
    assert all(out["iter_min_max_equal"] for out in ranks)
    for k in ("reward_per_step", "done_frac"):              # reduced across the ranks
        assert ranks[0]["iter_metrics"][k] == ranks[1]["iter_metrics"][k]


def test_ppo_sharded_mesh(ranks):
    """The mirror of ``tests/test_rl.py::test_ppo_sharded_mesh``."""
    for out in ranks:
        assert np.isfinite(out["mirror_loss"])
        assert out["mirror_lanes"] == PPO_MIRROR.num_envs
        assert out["mirror_step"] == 1


def test_gail_discriminator_stays_replicated(ranks):
    assert np.array_equal(ranks[0]["disc_params"], ranks[1]["disc_params"])
    assert all(out["gail_make_ppo_mesh"] for out in ranks)


def test_train_rl_mesh(ranks, inputs):
    run_dir = inputs["run_dir"]
    for out in ranks:
        assert out["train_rl"]["world_size"] == WORLD and np.isfinite(out["train_rl"]["reward_per_step"])
    assert ranks[0]["train_rl"]["reward_per_step"] == ranks[1]["train_rl"]["reward_per_step"]
    lines = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [l["iter"] for l in lines] == [0, 1]             # rank 0 alone wrote; then resumed at 1
    assert json.load(open(os.path.join(run_dir, "result.json")))["world_size"] == WORLD
    assert os.path.exists(os.path.join(run_dir, "ckpt_0.pt")) and os.path.exists(os.path.join(run_dir, "ckpt_1.pt"))
    assert ranks[0]["train_rl_resumed"]["reward_per_step"] == ranks[1]["train_rl_resumed"]["reward_per_step"]
