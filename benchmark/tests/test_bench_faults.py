"""``correct`` comes out false when the timed path is broken underneath, and
for the control: the harness's whole run on the CPU dry path (its look for
a card skipped), at a size a test run holds, with the cells' own limits.

Faults, for each cell that can have them: a step (or plan) that returns its
state (or mean) unchanged; half of the batch (of the samples) left out, the
mean taken over the rest; an answer altered where it is produced. A cell on
one chip has no exchange between chips to leave out.

The receding-horizon MPPI cell is kept ready in the benchmark's files
(``traffic/mpc.py``, ``traffic/mpc-s256-h64.json``, ``metrics/*.plan.json``)
but not in ``BENCHMARK.json``; its tests run it from a copy of the manifest
that lists it."""

import json
import os

import pytest
import torch

import furniture_tpu_torch.planning as planning
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.assembly import tree_where
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.planning.mppi import assembly_cost, rollout_costs

from benchmark import core

STEP_SHRINK = {"mix": {"batch": 4, "warmup_steps": 2, "compare_steps": 2},
               "sim": {"control_freq": 100}}
MPC_SHRINK = {"mix": {"horizon": 4, "n_samples": 8,
                      "planner_sim": {"timestep": 0.02, "solver_iters": 8, "control_freq": 50}},
              "sim": {"control_freq": 100}}
CELLS = {
    "cursor.random-b4096": (CursorEnv, STEP_SHRINK),
    "sawyer.impedance-b512": (ArmEnv, {**STEP_SHRINK, "mix": {**STEP_SHRINK["mix"], "batch": 2}}),
}


MPC_CELL = "cursor.mpc-s256-h64"


def _run(workload, shrink, control=False, root=core.ROOT):
    return core.run_cell(workload, 2147483659, 0.3, False, "cpu", shrink=shrink,
                         control=control, root=root)


@pytest.fixture
def mpc_root(tmp_path):
    """A checkout whose manifest adds the MPPI cell and its ``plans_per_s``."""
    m = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": MPC_CELL, "config": "cursor-table_lack",
                           "traffic": "mpc-s256-h64", "chips": 1, "why": "MPPI"})
    m["end_to_end"].append({"name": "plans_per_s", "unit": "plans/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": [MPC_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    os.symlink(core.ROOT / "benchmark", tmp_path / "benchmark")
    return tmp_path


def _unchanged(orig):
    def step_batch(self, states, actions):
        _, _, rew, done, info = orig(self, states, actions)
        return states, self.observe(states), rew, done, info
    return step_batch


def _half(orig):
    def step_batch(self, states, actions):
        s, _, rew, done, info = orig(self, states, actions)
        B = rew.shape[0]
        left = torch.arange(B, device=rew.device) >= B // 2
        s = tree_where(left, states, s)
        return s, self.observe(s), rew, done, info
    return step_batch


def _altered(orig):
    def step_batch(self, states, actions):
        s, obs, rew, done, info = orig(self, states, actions)
        rew = rew.clone()
        rew[0] = rew[0] + 1.0
        return s, obs, rew, done, info
    return step_batch


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_and_control(workload):
    cls, shrink = CELLS[workload]
    r = _run(workload, shrink, control=True)
    assert r["correct"], r["checks"]
    assert all(v == 0.0 for v in r["numbers"].values())
    limits = core.Cell(workload).mix["checks"]
    assert any(r["control"][k] > lim for k, lim in limits.items()), (r["control"], limits)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_step_faults_fail(workload, fault, monkeypatch):
    cls, shrink = CELLS[workload]
    monkeypatch.setattr(cls, "step_batch", fault(cls.step_batch))
    assert not _run(workload, shrink)["correct"]


def _broken_mppi(kind):
    real = planning.make_mppi

    def make_mppi(env, cfg, cost_fn=None):
        plan = real(env, cfg, cost_fn)
        cost_fn = cost_fn or assembly_cost(env)

        def broken(state, mean, generator, noise=None):
            if kind == "unchanged":
                new_mean, info = plan(state, mean, generator, noise=noise)
                return mean.clone(), info
            if kind == "half":
                samples = torch.clamp(mean[None] + noise, -1.0, 1.0)[: cfg.n_samples // 2]
                costs = rollout_costs(env, cost_fn, state, samples, cfg.gamma)
                w = torch.softmax(-costs / cfg.temperature, dim=0)
                return torch.einsum("s,shd->hd", w, samples), {"costs": costs}
            new_mean, info = plan(state, mean, generator, noise=noise)
            new_mean = new_mean.clone()
            new_mean[0, 0] += 0.5
            return new_mean, info

        return broken

    return make_mppi


def test_mpc_sound_run_and_control(mpc_root):
    r = _run(MPC_CELL, MPC_SHRINK, control=True, root=mpc_root)
    assert r["correct"], r["checks"]
    assert "plans_per_s" in r["metrics"]
    limits = core.Cell(MPC_CELL, mpc_root).mix["checks"]
    assert any(r["control"][k] > lim for k, lim in limits.items()), (r["control"], limits)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_mpc_faults_fail(kind, monkeypatch, mpc_root):
    monkeypatch.setattr(planning, "make_mppi", _broken_mppi(kind))
    assert not _run(MPC_CELL, MPC_SHRINK, root=mpc_root)["correct"]
