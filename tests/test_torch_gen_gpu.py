"""PyTorch port: the scripted demo generator's first connect, on the card.

Card-only (``gpu`` marker): the test skips itself without a CUDA card. A
first connect from reset takes about 210 scripted steps at the default
``SimConfig`` (50 substeps a control step), too long for the CPU plain
versions. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gen_gpu.py
"""

import os

import numpy as np
import pytest
import torch


@pytest.mark.gpu
def test_generate_demos_first_connect(tmp_path):
    """``generate_demos(1, batch=16, max_steps=360)`` with ``num_connects=1``
    through the CLI's function: at least one scripted episode connects a
    leg, its demo is saved and reads back through ``load_demo`` and the
    trajectory store, and restoring its pre-connect state and stepping the
    recorded action reproduces the connect."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the arm kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
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
