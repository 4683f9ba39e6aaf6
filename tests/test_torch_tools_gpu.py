"""PyTorch port: every command-line tool's ``main()`` on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_tools_gpu.py

Each tool of ``furniture_tpu_torch/tools/`` runs through its ``main()``
with small arguments and its outputs in a temporary directory: its output
checked, the launches of the kernel wrappers it made counted, and each of
those kernels held against its plain version at the inputs of its last call
in the tool (``assert_held``; each reset's settle among them).
"""

import contextlib
import io
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from torch_gpu_holds import assert_held, card, record_calls

from furniture_tpu_torch.physics.arm_megakernel import ArmMegaPhysics
from furniture_tpu_torch.physics.megakernel import MegaPhysics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "demos", "generated", "Sawyer_table_lack_0825_0000.pkl")
METHODS = {MegaPhysics: "substeps", ArmMegaPhysics: "control_step"}


class made_objects:
    """``with made_objects() as made:`` appends to ``made[A]`` every kernel
    wrapper of class ``A`` (of ``METHODS``) made inside the block, as ``(obj,
    calls)``, ``calls`` keeping the inputs of its last call: how a test finds
    the wrappers of the envs a tool builds for itself."""

    def __enter__(self):
        self.made = {c: [] for c in METHODS}
        self.inits = {c: c.__init__ for c in METHODS}
        for c, init in self.inits.items():
            def wrapped(obj, *args, _init=init, _c=c, **kw):
                _init(obj, *args, **kw)
                self.made[_c].append((obj, record_calls(obj, METHODS[_c], 1)))
            c.__init__ = wrapped
        return self.made

    def __exit__(self, *exc):
        for c, init in self.inits.items():
            c.__init__ = init
        return False


def run_tool(main, argv):
    """``main(argv)`` with its stdout captured: ``(returned, stdout,
    (kernel-1 launches, kernel-2 launches))``, each kernel the tool launched
    held at its last call's inputs."""
    buf = io.StringIO()
    with made_objects() as made, contextlib.redirect_stdout(buf):
        ret = main(argv)
    torch.cuda.synchronize()
    launches = tuple(sum(o.launches for o, _ in made[c]) for c in METHODS)
    for c, n in zip(METHODS, launches):
        wrappers = [(o, calls) for o, calls in made[c] if calls]
        assert wrappers or not n, f"{c.__name__} launched {n} times but no call of it was recorded"
        for o, calls in wrappers:
            assert_held(o, calls, c.__name__)
    return ret, buf.getvalue(), launches


@pytest.mark.gpu
def test_run_demo_state_and_action_replay(tmp_path):
    """State replay of a committed demo (1,570 states, 4 connects; one
    reset), then action replay of its first 30 actions (ik: 3 launches of
    kernel 2 a step)."""
    from furniture_tpu_torch.tools import run_demo

    card()
    _, out, launches = run_tool(run_demo.main, [DEMO, "--env", "IKEASawyer-v0", "--state_replay"])
    assert json.loads(out.strip().splitlines()[-1]) == {"steps": 1570, "num_connected": 4,
                                                        "mode": "state_replay"}
    assert launches == (10, 0)
    with open(DEMO, "rb") as f:
        cut = pickle.load(f)
    cut["actions"] = cut["actions"][:30]
    with open(tmp_path / "cut.pkl", "wb") as f:
        pickle.dump(cut, f)
    _, out, launches = run_tool(run_demo.main, [str(tmp_path / "cut.pkl"), "--env", "IKEASawyer-v0"])
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == {"steps", "total_reward", "num_connected", "final_object_ob_l2"} and res["steps"] == 30
    assert np.isfinite(res["total_reward"]) and np.isfinite(res["final_object_ob_l2"])
    assert launches == (10, 3 * 30)


@pytest.mark.gpu
def test_run_manual_with_a_screenshot(tmp_path):
    """A 5-key script on the cursor and its screenshot: one reset and 5
    steps."""
    from furniture_tpu_torch.tools import run_manual

    card()
    _, out, launches = run_tool(run_manual.main, ["--script", "w w e SPACE c t", "--out_dir", str(tmp_path),
                                                  "--demo_dir", str(tmp_path / "demos")])
    shot = [line[len("screenshot -> "):] for line in out.splitlines() if line.startswith("screenshot -> ")]
    assert out.count("key=") == 5 and len(shot) == 1 and os.path.getsize(shot[0]) > 0
    assert launches == (10 + 2 * 5, 0)


@pytest.mark.gpu
def test_eval_bc(tmp_path):
    """5 epochs, 8 episodes x 20 steps of the dense Sawyer under ik: the
    output's keys, one reset and 3 launches of kernel 2 a step."""
    from furniture_tpu_torch.tools import eval_bc

    card()
    path = tmp_path / "bc_eval.json"
    demos = os.path.join(ROOT, "demos", "generated", "*.pkl")
    _, _, launches = run_tool(eval_bc.main, ["--demos", demos, "--epochs", "5", "--episodes", "8",
                                             "--steps", "20", "--out", str(path)])
    bc = json.load(open(path))
    assert set(bc) == {"n_demos", "n_transitions", "bc_final_mse", "episodes", "max_steps", "num_connects",
                       "success_rate", "n_success", "success_steps", "pool_offset", "criterion",
                       "furniture_name", "seed"}
    assert bc["n_demos"] == 12 and bc["episodes"] == 8 and np.isfinite(bc["bc_final_mse"])
    assert launches == (10, 60)


@pytest.mark.gpu
def test_fps_all():
    """``fps --all`` at its batch of 512: five rows, Baxter under ik and
    impedance among them."""
    from furniture_tpu_torch.tools import fps

    card()
    rows, _, launches = run_tool(fps.main, ["--all"])
    assert len(rows) == 5 and all(r["steps_per_s"] > 0 and r["batch"] == 512 for r in rows)
    assert launches == (10 * 5 + 2 * 40, 3 * 40 * 2 + 40 * 2)


@pytest.mark.gpu
def test_resize_into_a_copy_of_the_assets(tmp_path):
    """``resize table_lack_0825 --scale 1.3`` into a copy of the assets:
    five part masses scaled by 1.3^3, nothing written into the real ones."""
    from furniture_tpu_torch import models
    from furniture_tpu_torch.models import compiler
    from furniture_tpu_torch.tools import resize

    card()
    real = models.ASSET_DIR
    shutil.copytree(real, tmp_path / "assets")
    models.ASSET_DIR = compiler.ASSET_DIR = type(real)(tmp_path / "assets")
    try:
        ret, out, _ = run_tool(resize.main, ["table_lack_0825", "--scale", "1.3"])
    finally:
        models.ASSET_DIR = compiler.ASSET_DIR = real
    assert str(ret).endswith(os.path.join("assets", "furniture", "table_lack_0825_x1p3.json"))
    assert out.count("(x2.20)") == 5
    assert not os.path.exists(os.path.join(real, "furniture", "table_lack_0825_x1p3.json"))


@pytest.mark.gpu
def test_profilers(tmp_path):
    """``profile_gen`` at 16 envs x 30 steps (one reset, 3 launches of
    kernel 2 a step), and ``profile_cursor`` and ``profile_ilqr`` at their
    bench sizes: their rows positive and naming the card, the launches what
    their phases imply."""
    from furniture_tpu_torch.tools import profile_cursor, profile_gen, profile_ilqr

    card()
    pg, _, launches = run_tool(profile_gen.main, ["--batch", "16", "--max_steps", "30",
                                                  "--out", str(tmp_path / "gen.json")])
    assert pg["batch"] == 16 and pg["max_steps"] == 30 and pg["funnel"]["lanes"] == 16
    assert launches == (10, 3 * 30)
    name = torch.cuda.get_device_name(0)
    pc, _, launches = run_tool(profile_cursor.main, ["--out", str(tmp_path / "cursor.json")])
    assert pc["device"] == name and launches == (10 + 6 * 20 * 4, 0)
    assert all(pc[k] > 0 for k in ("full_ms_per_batchstep", "kernel_ms_per_batchstep",
                                   "kernel1_ms_per_batchstep", "glue_ms_per_batchstep"))
    pi, _, launches = run_tool(profile_ilqr.main, ["--out", str(tmp_path / "ilqr.json")])
    # a reset; 4 solves of 64 + 5 x 64; 7 rollouts (6 timed, 1 for the line
    # search's reference); 6 line searches of 64 steps
    assert pi["device"] == name and launches == (10 + 4 * 384 + 7 * 64 + 6 * 64, 0)
    assert all(pi[k] > 0 for k in ("full_solve_s", "linesearch5_s", "linearize_s", "backward_s", "rollout64_s"))
