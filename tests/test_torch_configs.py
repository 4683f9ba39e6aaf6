"""PyTorch port: the benchmark's configurations and cells, on the CPU.

Each configuration under ``benchmark/configs/`` states the widths its model
compiles to; on each cell of ``BENCHMARK.json`` the port's plain path agrees
with the benchmark's frozen plain reference (``benchmark.reference``) from
the same draws, and the harness's dry path comes out ``correct``. A cell
added to the manifest is tested here with no new code. No JAX is imported
or compiled here.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import SimConfig
from furniture_tpu_torch.physics.megakernel import MAX_SMEM

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark.reference as R  # noqa: E402
from benchmark import checks, core  # noqa: E402
from benchmark.reference.config import EnvConfig as RefEnvConfig  # noqa: E402
from benchmark.reference.config import SimConfig as RefSimConfig  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
# floats a lane slot keeps in the physics kernel of an env: kernel 1
# (csrc/physics_common.cuh NF) for the cursor, kernel 2 for an arm. A model
# whose slots' working set is over the shared memory a block may have keeps
# it in a global scratch buffer: of the configurations, these alone
SLOT_FLOATS = {"IKEACursor-v0": 24, "IKEASawyer-v0": 25, "IKEABaxter-v0": 25}
GLOBAL_SCRATCH = {"cursor-chair_balser", "baxter-swivel_chair"}
SHRINK = {"mix": {"batch": 2, "warmup_steps": 2, "compare_steps": 2}, "sim": {"control_freq": 100}}
EXACT = ("group", "num_connected", "connect_step", "conn_connected", "weld_active")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(workload):
    """(configuration, keyword arguments of ``make_vec_env``) of a cell."""
    cell = core.Cell(workload)
    kw = {"furniture_name": cell.config["env"]["furniture_name"]}
    if cell.mix.get("control_type"):
        kw["control_type"] = cell.mix["control_type"]
    return cell.config, kw


def _widths(env) -> dict:
    """What the env's model compiles to, under the names of a
    configuration's ``widths``."""
    ph = env.physics
    w = {"parts": ph.P, "floor_lanes": ph.Kf, "sat_lanes": ph.Ke, "contact_lanes": ph.K,
         "contact_slots": int(ph.slots["KS"])}
    if hasattr(env, "robot"):
        r = env.robot
        return w | {"joints": r.nj, "actuators": r.na, "bodies": r.nb, "arms": env.n_arms,
                    "hand_geoms": ph.NRG, "action_dim_impedance": env.dof}
    return w | {"geoms": len(np.asarray(env.tables["geom_part"])), "geom_pairs": ph.Ke,
                "pair_lanes": ph.Kp, "connection_sites": env._C,
                "connects_to_finish": env.success_num_connects, "action_dim": env.dof}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_compiled_widths_match_the_config(name):
    """The default ``SimConfig`` compiles each configuration to its
    ``widths`` (an arm's under impedance control), and the models that
    ``GLOBAL_SCRATCH`` names, alone, hold more lane slots than a block's
    shared memory, so that their physics kernel takes its global-scratch
    route on the card."""
    cfg = CONFIGS[name]
    kw = {"furniture_name": cfg["env"]["furniture_name"]}
    if cfg["env_id"] != "IKEACursor-v0":
        kw["control_type"] = "impedance"
    env = ft.make_vec_env(cfg["env_id"], 1, device="cpu", sim=SimConfig(), **kw).env
    got = _widths(env)
    assert {k: got[k] for k in cfg["widths"]} == cfg["widths"]
    slot_bytes = 4 * SLOT_FLOATS[cfg["env_id"]] * got["contact_slots"]
    assert (slot_bytes > MAX_SMEM) == (name in GLOBAL_SCRATCH)


@pytest.mark.parametrize("workload", CELLS)
def test_plain_path_agrees_with_the_reference(workload):
    """B = 2, 5 substeps a step: the port's reset and 3 steps of the cell's
    env against the reference's from the same seed; state, observation and
    reward within 1e-5, done, groups, connect counters and the cursor's
    selection equal."""
    cfg, kw = _cell(workload)
    B, seed = 2, 2147483701
    sim = dict(control_freq=100)
    vec = ft.make_vec_env(cfg["env_id"], B, seed=seed, device="cpu", sim=SimConfig(**sim), **kw)
    vec.reset()
    ref = R.make(cfg["env_id"], RefEnvConfig(sim=RefSimConfig(**sim), **kw), "cpu")
    rs = ref.reset_batch(B, torch.Generator().manual_seed(seed))
    assert float(checks.row_gaps(vec.state, rs, B).max()) <= 1e-5
    exact = EXACT + (("selected",) if cfg["env_id"] == "IKEACursor-v0" else ())
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(3):
        a = torch.rand((B, vec.env.dof), generator=g) * 2 - 1
        s, obs, rew, done, info = vec.env.step_batch(vec.state, a)
        rs, robs, rrew, rdone, rinfo = ref.step_batch(checks.rebuild(vec.state, rs), a)
        assert float(checks.row_gaps(s, rs, B).max()) <= 1e-5
        assert float(checks.row_gaps(obs, robs, B).max()) <= 1e-5
        assert float((rew - rrew).abs().max()) <= 1e-5
        assert torch.equal(done, rdone)
        for f in exact:
            assert torch.equal(getattr(s, f), getattr(rs, f)), f
        assert torch.equal(info["num_connected"], rinfo["num_connected"])
        vec.step(a)
        rs = checks.rebuild(vec.state, rs)


@pytest.mark.parametrize("workload", CELLS)
def test_dry_path_is_correct(workload):
    """The harness's whole run of each cell on the CPU dry path at B = 2 and
    5 substeps a step, with the cell's own limits."""
    r = core.run_cell(workload, 2147483659, 0.3, False, "cpu", shrink=SHRINK)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert {"env_steps_per_s", "setup_s"} <= set(r["metrics"])


def test_steps_import_no_jax():
    """Importing the port and stepping every configuration's env once loads
    neither jax nor the JAX package (fresh interpreter: this process may
    have imported jax already)."""
    envs = [(c["env_id"], c["env"]["furniture_name"]) for c in CONFIGS.values()]
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import furniture_tpu_torch as ft\n"
        "from furniture_tpu_torch.config import SimConfig\n"
        f"for env_id, name in {envs!r}:\n"
        "    kw = {} if env_id == 'IKEACursor-v0' else {'control_type': 'impedance'}\n"
        "    vec = ft.make_vec_env(env_id, 1, device='cpu', furniture_name=name,\n"
        "                          sim=SimConfig(control_freq=100), **kw)\n"
        "    vec.reset()\n"
        "    vec.step(torch.zeros(1, vec.env.dof))\n"
        "    assert torch.isfinite(vec.state.parts.pos).all()\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'furniture_tpu'})\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
