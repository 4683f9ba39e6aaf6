"""PyTorch port: Baxter bimanual on swivel_chair_0700, on the CPU.

The benchmark's configuration ``benchmark/configs/baxter-swivel_chair.json``
states the widths the model compiles to; the port's plain path agrees with
the benchmark's frozen plain reference (``benchmark.reference``) from the
same draws; and the harness's dry path comes out ``correct`` on the cells
that run this configuration and the Sawyer ik mix. No JAX is imported or
compiled here.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import SimConfig

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark.reference as R  # noqa: E402
from benchmark import checks, core  # noqa: E402
from benchmark.reference.config import EnvConfig as RefEnvConfig  # noqa: E402
from benchmark.reference.config import SimConfig as RefSimConfig  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "baxter-swivel_chair.json").read_text())
KW = dict(control_type="impedance", furniture_name="swivel_chair_0700")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compiled_widths_match_the_config():
    """The default ``SimConfig`` compiles Baxter on swivel_chair to the
    configuration's ``widths``: over the shared memory a block of kernel 2
    may have (25 floats a slot x 2560 slots), so it takes the global-scratch
    route on the card."""
    env = ft.make_vec_env(CONFIG["env_id"], 1, device="cpu", sim=SimConfig(), **KW).env
    ph, r = env.physics, env.robot
    got = {
        "parts": ph.P, "joints": r.nj, "actuators": r.na, "bodies": r.nb, "arms": env.n_arms,
        "hand_geoms": ph.NRG, "floor_lanes": ph.Kf, "sat_lanes": ph.Ke, "contact_lanes": ph.K,
        "contact_slots": int(ph.slots["KS"]), "action_dim_impedance": env.dof,
    }
    assert got == CONFIG["widths"]
    assert CONFIG["env"]["furniture_name"] == KW["furniture_name"]
    assert 25 * 4 * got["contact_slots"] > ph.smem_limit


def _field_gaps(got, want, B):
    return float(checks.row_gaps(got, want, B).max())


def test_plain_path_agrees_with_the_reference():
    """B = 2, 5 substeps a step: the port's reset and 3 impedance steps
    against the reference's from the same seed; state, observation and
    reward within 1e-5, done, groups and connect counters equal."""
    B, seed = 2, 2147483701
    sim = dict(control_freq=100)
    vec = ft.make_vec_env(CONFIG["env_id"], B, seed=seed, device="cpu", sim=SimConfig(**sim), **KW)
    vec.reset()
    ref = R.make(CONFIG["env_id"], RefEnvConfig(sim=RefSimConfig(**sim), **KW), "cpu")
    rs = ref.reset_batch(B, torch.Generator().manual_seed(seed))
    assert _field_gaps(vec.state, rs, B) <= 1e-5
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(3):
        a = torch.rand((B, vec.env.dof), generator=g) * 2 - 1
        s, obs, rew, done, info = vec.env.step_batch(vec.state, a)
        rs, robs, rrew, rdone, rinfo = ref.step_batch(checks.rebuild(vec.state, rs), a)
        assert _field_gaps(s, rs, B) <= 1e-5
        assert _field_gaps(obs, robs, B) <= 1e-5
        assert float((rew - rrew).abs().max()) <= 1e-5
        assert torch.equal(done, rdone)
        for f in ("group", "num_connected", "connect_step", "conn_connected", "weld_active"):
            assert torch.equal(getattr(s, f), getattr(rs, f)), f
        assert torch.equal(info["num_connected"], rinfo["num_connected"])
        vec.step(a)
        rs = checks.rebuild(vec.state, rs)


@pytest.mark.parametrize("workload", ["baxter.impedance-b512", "sawyer.ik-b256"])
def test_dry_path_is_correct(workload):
    """The harness's whole run on the CPU dry path at B = 2 and 5 substeps
    a step, with the cell's own limits."""
    shrink = {"mix": {"batch": 2, "warmup_steps": 2, "compare_steps": 2},
              "sim": {"control_freq": 100}}
    r = core.run_cell(workload, 2147483659, 0.3, False, "cpu", shrink=shrink)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert {"env_steps_per_s", "setup_s"} <= set(r["metrics"])


def test_baxter_step_imports_no_jax():
    """Importing the port and stepping Baxter on swivel_chair loads neither
    jax nor the JAX package (fresh interpreter: this process has imported
    jax already)."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import furniture_tpu_torch as ft\n"
        "from furniture_tpu_torch.config import SimConfig\n"
        "vec = ft.make_vec_env('IKEABaxter-v0', 1, device='cpu', control_type='impedance',\n"
        "                      furniture_name='swivel_chair_0700', sim=SimConfig(control_freq=100))\n"
        "vec.reset()\n"
        "obs, rew, done, info = vec.step(torch.zeros(1, vec.env.dof))\n"
        "assert torch.isfinite(vec.state.qpos).all() and vec.env.physics.K == 2145\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'furniture_tpu'})\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
