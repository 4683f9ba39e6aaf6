"""PyTorch port: demo recording and loading, and the native trajectory store.

* ``load_demo`` of the port and of the JAX package give equal dicts on two
  committed pickles (one of ``demos/generated``, one of
  ``demos/generated_blocks``);
* a ``DemoRecorder`` episode saved by the port loads back through both
  packages' ``load_demo`` with the reference schema;
* ``TrajStore`` built from ``native/traj_store.cpp`` into the port's build
  directory: records written and read back bit for bit, with and without
  extras.
"""

import os

import numpy as np
import pytest

from furniture_tpu.utils.demo import load_demo as jax_load_demo
from furniture_tpu_torch.utils import traj_store
from furniture_tpu_torch.utils.demo import DemoRecorder, load_demo
from furniture_tpu_torch.utils.traj_store import TrajStore

DEMOS = os.path.join(os.path.dirname(__file__), "..", "demos")
PICKLES = [
    os.path.join(DEMOS, "generated", "Sawyer_table_lack_0825_0000.pkl"),
    os.path.join(DEMOS, "generated_blocks", "Sawyer_three_blocks_0000.pkl"),
]


def assert_same(a, b, where="demo"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), where


@pytest.mark.parametrize("path", PICKLES, ids=["table_lack", "three_blocks"])
def test_load_demo_matches_jax(path):
    mine = load_demo(path)
    assert_same(mine, jax_load_demo(path))
    for k in ("states", "obs", "actions", "rewards", "low_level_obs", "low_level_actions",
              "connect_actions", "metadata"):
        assert k in mine, k
    assert len(mine["obs"]) == len(mine["actions"]) + 1
    assert all(isinstance(a, np.ndarray) for a in mine["actions"])


def test_demo_recorder_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    rec = DemoRecorder(str(tmp_path), metadata={"agent": "Sawyer", "seed": 3})
    T = 5
    for t in range(T):
        rec.add(ob={"robot_ob": rng.normal(size=7).astype(np.float32)},
                state={"qpos": rng.normal(size=9).astype(np.float32)},
                action=rng.uniform(-1, 1, 8).astype(np.float32), reward=float(t),
                connect_action=bool(t % 2))
    rec.add(ob={"robot_ob": np.zeros(7, np.float32)}, state={"qpos": np.zeros(9, np.float32)})
    path = rec.save("Sawyer_test_")
    assert path.endswith("Sawyer_test_0000.pkl")
    assert rec.save("Sawyer_test_").endswith("Sawyer_test_0001.pkl")  # numbered, buffer reset
    demo = load_demo(path)
    assert_same(demo, jax_load_demo(path))
    assert len(demo["obs"]) == T + 1 and len(demo["states"]) == T + 1
    assert demo["rewards"] == [float(t) for t in range(T)]
    assert demo["connect_actions"] == [False, True, False, True, False]
    assert demo["metadata"] == {"agent": "Sawyer", "seed": 3}


def test_traj_store_round_trip(tmp_path):
    assert traj_store.library_path().parent == traj_store.BUILD_DIR
    rng = np.random.default_rng(1)
    recs = [(rng.normal(size=(n, 8)).astype(np.float32), rng.normal(size=n).astype(np.float32),
             rng.normal(size=(n, 3)).astype(np.float32) if i % 2 else None)
            for i, n in enumerate((4, 1, 17))]
    path = tmp_path / "demos.ftr"
    with TrajStore(path, "w") as ts:
        for a, r, e in recs:
            ts.append(a, r, e)
        ts.flush()
    assert traj_store.library_path().exists()
    with TrajStore(path, "r") as ts:
        assert len(ts) == len(recs)
        for i, (a, r, e) in enumerate(recs):
            ra, rr, re = ts.read(i)
            np.testing.assert_array_equal(ra, a)
            np.testing.assert_array_equal(rr, r)
            assert re.shape == ((len(a), 3) if e is not None else (len(a), 0))
            if e is not None:
                np.testing.assert_array_equal(re, e)
        with pytest.raises(IndexError):
            ts.read(len(recs))
    with pytest.raises(ValueError):
        with TrajStore(tmp_path / "bad.ftr", "w") as ts:
            ts.append(np.zeros((3, 2), np.float32), np.zeros(2, np.float32))
