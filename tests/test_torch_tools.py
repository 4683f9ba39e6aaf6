"""PyTorch port: the command-line tools (``furniture_tpu_torch/tools/``).

Each tool against its JAX counterpart under ``tools/`` where the two share
a pure helper (``run_manual.token_to_action``, ``profile_gen.analyze``,
held exactly), and each driven on the CPU at a tiny size (B <= 2,
``SimConfig(control_freq=100)`` where the tool takes a config; the kernels'
plain versions): ``run_demo`` replaying a committed demo's states and
actions, ``run_manual`` on a key script with its screenshot, ``eval_bc``'s
output keys and dataset, ``fps.measure`` on every row of ``--all``,
``resize`` into a temporary asset copy, and the two profilers. One fresh
interpreter runs every tool's ``--help`` in both of its forms (path and
``-m``) and checks that neither JAX nor the JAX package was imported; the
flags of each JAX tool must be among its port's. No JAX function is
compiled here.
"""

import importlib.util
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from furniture_tpu_torch.config import SimConfig
from furniture_tpu_torch.tools import eval_bc, fps, profile_cursor, profile_gen, profile_ilqr
from furniture_tpu_torch.tools import resize, run_demo, run_manual

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIM = SimConfig(control_freq=100)
DEMO = ROOT / "demos" / "generated" / "Sawyer_table_lack_0825_0000.pkl"
TOOLS = ("run_demo", "run_manual", "eval_bc", "fps", "resize", "profile_gen",
         "profile_cursor", "profile_ilqr")


def _jax_tool(name):
    """A JAX tool's module (its top level imports numpy only)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = fn(*args, **kw)
    return ret, buf.getvalue()


# -- imports and flags -----------------------------------------------------------------


@pytest.fixture(scope="module")
def helps():
    """``--help`` of every tool as a path and as a module, in one fresh
    interpreter, with the modules the tools import on call loaded too."""
    code = (
        "import contextlib, io, json, runpy, sys\n"
        f"tools = {TOOLS!r}\n"
        "out = {}\n"
        "for name in tools:\n"
        "    for form in ('path', 'module'):\n"
        "        buf = io.StringIO()\n"
        "        sys.argv = [name, '--help']\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            try:\n"
        "                if form == 'path':\n"
        "                    runpy.run_path(f'furniture_tpu_torch/tools/{name}.py', run_name='__main__')\n"
        "                else:\n"
        "                    runpy.run_module(f'furniture_tpu_torch.tools.{name}', run_name='__main__')\n"
        "            except SystemExit as e:\n"
        "                assert e.code == 0, (name, form, e.code)\n"
        "        out[f'{name}/{form}'] = buf.getvalue()\n"
        "import furniture_tpu_torch.api, furniture_tpu_torch.rl, furniture_tpu_torch.planning\n"
        "import furniture_tpu_torch.envs.sawyer_dense, furniture_tpu_torch.envs.sawyer_gen\n"
        "import furniture_tpu_torch.utils.demo, furniture_tpu_torch.utils.init_pool\n"
        "import furniture_tpu_torch.utils.video_recorder, furniture_tpu_torch.render\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'furniture_tpu'))\n"
        "print(json.dumps({'helps': out, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_tools_import_no_jax(helps):
    assert helps["bad"] == [], helps["bad"]


@pytest.mark.parametrize("name", TOOLS)
def test_tool_keeps_the_jax_flags(helps, name):
    """Both forms run, and every flag of the JAX tool is a flag of the port's,
    which also takes ``--platform`` where it runs on a device."""
    src = (ROOT / "tools" / f"{name}.py").read_text()
    flags = set(re.findall(r"add_argument\(\s*\"(-[-\w]+)\"", src))
    for form in ("path", "module"):
        text = helps["helps"][f"{name}/{form}"]
        assert text.startswith("usage:"), (name, form)
        for flag in flags:
            assert flag in text, (name, form, flag)
        if name != "resize":
            assert "--platform" in text, (name, form)


# -- run_manual ------------------------------------------------------------------------


@pytest.mark.parametrize("agent", ["Cursor", "Baxter", "Sawyer"])
def test_token_to_action_matches_jax(agent):
    """Every token x both cursors x both flag states, exactly as the JAX
    tool's."""
    jt = _jax_tool("run_manual")
    assert run_manual.KEY2TOKEN == jt.KEY2TOKEN
    dof = {"Cursor": 15, "Baxter": 15, "Sawyer": 8}[agent]
    for token in sorted(set(jt.KEY2TOKEN.values()) | {"noop"}):
        for cursor_idx in (0, 1):
            for flag in ([-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]):
                for d in (dof, 9):
                    a = run_manual.token_to_action(token, agent, "ik", d, cursor_idx, list(flag))
                    b = jt.token_to_action(token, agent, "ik", d, cursor_idx, list(flag))
                    np.testing.assert_array_equal(a, b)


def test_run_manual_script_and_screenshot(tmp_path, monkeypatch):
    """A key script on the cursor steps the env, records a demo and writes a
    PNG screenshot; without imageio the frame goes to ``.npz``."""
    args = run_manual.parse_args([
        "--script", "w w e SPACE c t y x", "--platform", "cpu", "--screen_width", "16",
        "--screen_height", "16", "--out_dir", str(tmp_path), "--record_demo",
        "--demo_dir", str(tmp_path / "demos"),
    ])
    _, out = _stdout(run_manual.run, args, sim=SIM)
    assert out.count("key=") == 5 and "connected=0" in out
    png = tmp_path / "table_lack_0825.png"
    assert f"screenshot -> {png}" in out and png.stat().st_size > 0
    with open(tmp_path / "demos" / "Cursor_manual_0000.pkl", "rb") as f:
        demo = pickle.load(f)
    assert len(demo["actions"]) == 5 and len(demo["obs"]) == 6
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = run_manual.write_image(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "shot"))
    assert path.endswith(".npz") and np.load(path)["frame"].shape == (4, 4, 3)


# -- run_demo --------------------------------------------------------------------------


def test_run_demo_state_replay(tmp_path):
    """State replay of the last 20 recorded states of a committed demo, with
    a video: the demo's final connect count, one frame a state."""
    with open(DEMO, "rb") as f:
        demo = pickle.load(f)
    demo["states"] = demo["states"][-20:]
    path = tmp_path / "demo.pkl"
    with open(path, "wb") as f:
        pickle.dump(demo, f)
    _, out = _stdout(run_demo.main, [
        str(path), "--env", "IKEASawyer-v0", "--state_replay", "--platform", "cpu",
        "--video", str(tmp_path / "vid"), "--screen_width", "16", "--screen_height", "16",
    ])
    lines = out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res == {"steps": 20, "num_connected": int(demo["states"][-1]["num_connected"]),
                   "mode": "state_replay"}
    video = lines[-2].split("video -> ")[1]
    assert video.startswith(str(tmp_path / "vid" / "video"))
    if video.endswith(".npz"):
        assert np.load(video)["frames"].shape == (20, 16, 16, 3)


def test_run_demo_action_replay(tmp_path):
    """Action replay of a committed demo's first 3 actions: the JAX tool's
    output keys."""
    with open(DEMO, "rb") as f:
        demo = pickle.load(f)
    demo["actions"] = demo["actions"][:3]
    path = tmp_path / "demo.pkl"
    with open(path, "wb") as f:
        pickle.dump(demo, f)
    args = run_demo.parse_args([str(path), "--env", "IKEASawyer-v0", "--platform", "cpu"])
    res = run_demo.replay(args, sim=SIM)
    assert set(res) == {"steps", "total_reward", "num_connected", "final_object_ob_l2"}
    assert res["steps"] == 3 and res["num_connected"] == 0
    assert np.isfinite(res["total_reward"]) and np.isfinite(res["final_object_ob_l2"])


# -- eval_bc ---------------------------------------------------------------------------


def test_eval_bc_keys_and_dataset():
    """One epoch and 2 episodes x 2 steps: the output has the committed
    ``runs/bc_eval.json``'s keys plus the two the JAX tool writes since
    (``pool_offset``, ``criterion``, ``tools/eval_bc.py:158-161``); the
    dataset equals the JAX package's ``rl.demos_to_dataset``'s."""
    from furniture_tpu import rl as jax_rl

    args = eval_bc.parse_args(["--epochs", "1", "--episodes", "2", "--steps", "2",
                               "--platform", "cpu"])
    out = eval_bc.evaluate(args, sim=SIM)
    with open(ROOT / "runs" / "bc_eval.json") as f:
        committed = json.load(f)
    assert set(out) == set(committed) | {"pool_offset", "criterion"}
    assert out["episodes"] == 2 and out["max_steps"] == 2 and out["n_demos"] == 12
    assert out["criterion"] == "env_success" and 0.0 <= out["success_rate"] <= 1.0
    demos, X, Y = eval_bc.load_dataset(str(ROOT / "demos" / "generated" / "*.pkl"))
    jdemos = []
    for p in sorted((ROOT / "demos" / "generated").glob("*.pkl")):
        with open(p, "rb") as f:
            jdemos.append(pickle.load(f))
    jX, jY = jax_rl.demos_to_dataset(jdemos)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)
    assert out["n_transitions"] == X.shape[0]


def test_eval_bc_pool_offset():
    """``--pool_offset`` evaluates from near-success demo states and scores an
    additional connect."""
    args = eval_bc.parse_args(["--epochs", "1", "--episodes", "2", "--steps", "1",
                               "--pool_offset", "5", "--platform", "cpu"])
    out = eval_bc.evaluate(args, sim=SIM)
    assert out["criterion"] == "additional_connect" and out["pool_offset"] == 5


# -- fps -------------------------------------------------------------------------------


@pytest.mark.parametrize("agent,control", fps.COMBOS)
def test_fps_measure(agent, control):
    """Every row of ``--all`` (the JAX tool's matrix) at horizon 1, 1 rep."""
    assert fps.COMBOS == [("Cursor", "ik"), ("Sawyer", "ik"), ("Sawyer", "impedance"),
                          ("Baxter", "ik"), ("Baxter", "impedance")]
    rate = fps.measure(agent, control, "table_lack_0825", 2, horizon=1, reps=1, device="cpu",
                       sim=SIM)
    assert np.isfinite(rate) and rate > 0


# -- resize ----------------------------------------------------------------------------


def test_resize_into_temporary_assets(tmp_path, monkeypatch):
    """The scaled spec lands in the (temporary) asset directory, equal to
    the JAX package's ``scale_spec``; masses scale by the cube."""
    from furniture_tpu.models import load_spec as jax_load_spec
    from furniture_tpu.models import scale_spec as jax_scale_spec
    from furniture_tpu_torch import models
    from furniture_tpu_torch.models import compiler

    assets = tmp_path / "assets"
    shutil.copytree(models.ASSET_DIR, assets)
    real = sorted(p.name for p in (models.ASSET_DIR / "furniture").iterdir())
    monkeypatch.setattr(models, "ASSET_DIR", assets)
    monkeypatch.setattr(compiler, "ASSET_DIR", assets)
    out_path, out = _stdout(resize.main, ["table_lack_0825", "--scale", "1.3"])
    assert out_path == assets / "furniture" / "table_lack_0825_x1p3.json"
    assert f"wrote {out_path}" in out and out.count("(x2.20)") == 5
    with open(out_path) as f:
        spec = json.load(f)
    ref = jax_scale_spec(jax_load_spec("furniture", "table_lack_0825"), 1.3)
    ref["model"] = "table_lack_0825_x1p3"
    assert spec == json.loads(json.dumps(ref))
    assert sorted(p.name for p in (ROOT / "furniture_tpu" / "assets" / "furniture").iterdir()) == real


# -- profile_gen -----------------------------------------------------------------------


def _synthetic_traj(T_, B, S, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 12, (T_, B)).astype(np.int8),
        rng.random((T_, B)) < 0.3,
        rng.integers(0, 3, (T_, B)).astype(np.int8),
        rng.uniform(0, 1.0, (T_, B)).astype(np.float32),
        rng.random((T_, B)) < 0.1,
        rng.exponential(0.7, (T_, B)).astype(np.float32),
        np.sort(rng.integers(0, S + 1, (T_, B)), axis=0).astype(np.int8),
        rng.integers(0, S + 1, (T_, B)).astype(np.int8),
    )


def _close(a, b, path="out"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-6, (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_profile_gen_analyze_matches_jax(seed):
    """``analyze`` on a synthetic trajectory (numpy seed) equals the JAX
    tool's: JSON-equal, floats within 1e-6."""
    traj = _synthetic_traj(60, 16, 4, seed)
    ours = json.loads(json.dumps(profile_gen.analyze(traj, 4)))
    ref = json.loads(json.dumps(_jax_tool("profile_gen").analyze(traj, 4)))
    _close(ours, ref)


def test_profile_gen_rollout(tmp_path):
    """The scripted rollout's eight records at batch 2 x 3 steps, analyzed."""
    args = profile_gen.parse_args(["--batch", "2", "--max_steps", "3", "--platform", "cpu",
                                   "--out", str(tmp_path / "p.json")])
    out = profile_gen.profile(args, control_freq=100)
    assert out["batch"] == 2 and out["max_steps"] == 3
    assert sum(out["connect_histogram"]) == 2 and out["funnel"]["lanes"] == 2
    assert out["furniture_name"] == "table_lack_0825" and out["seed"] == 2


# -- profile_cursor, profile_ilqr ------------------------------------------------------


def test_profile_cursor_rows():
    out = profile_cursor.profile(batch=2, horizon=2, device="cpu", reps=1, sim=SIM)
    for k in ("full", "kernel", "glue"):
        assert out[f"{k}_steps_per_s"] > 0 and out[f"{k}_ms_per_batchstep"] > 0
    assert out["kernel1_ms_per_batchstep"] > 0 and out["device"] == "cpu"
    assert out["n_substeps"] == 5 and out["batch"] == 2


def test_profile_ilqr_rows():
    out = profile_ilqr.profile(horizon=3, iterations=1, substeps=2, device="cpu", reps=1,
                               control_freq=100)
    for k in ("full_solve_s", "rollout64_s", "linesearch5_s", "linearize_s", "backward_s"):
        assert out[k] > 0, k
    assert out["n_state"] == 41 and out["n_ctrl"] == 15 and out["n_alphas"] == 5
