"""PyTorch port: the static tables are exactly the JAX package's.

numpy only on both sides: the port's ``physics_tables`` and the free-part
kernel's constant tables against JAX's ``physics_tables`` and
``MegaPhysics`` attributes, bit for bit (``np.array_equal``).
"""

import numpy as np
import pytest
import torch

from furniture_tpu.config import SimConfig as JSimConfig
from furniture_tpu.models import compile_model as jax_compile_model
from furniture_tpu.physics.engine import physics_tables as jax_physics_tables
from furniture_tpu.physics.megakernel import MegaPhysics as JaxMega
from furniture_tpu_torch.config import SimConfig
from furniture_tpu_torch.models import compile_model, furniture_names
from furniture_tpu_torch.physics.engine import physics_tables
from furniture_tpu_torch.physics.megakernel import MegaPhysics

torch.set_num_threads(1)

MODELS = ["table_lack_0825", "chair_agne_0010", "toy_table", "chair_balser_0115"]


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    nan = a.dtype.kind == "f"  # free-angle recipe rows carry NaN
    assert np.array_equal(a, b, equal_nan=nan), what


def test_registry_matches_jax():
    from furniture_tpu.models import furniture_names as jax_names

    assert furniture_names == jax_names


@pytest.mark.parametrize("name", MODELS)
def test_model_and_physics_tables_equal(name):
    jm, tm = jax_compile_model(name), compile_model(name)
    for f in jm.__dataclass_fields__:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(a, np.ndarray):
            _eq(a, b, f)
        elif f != "recipe_raw":
            assert a == b, f
    jt, tt = jax_physics_tables(jm), physics_tables(tm)
    assert set(jt) == set(tt)
    for k in jt:
        _eq(jt[k], tt[k], k)


@pytest.mark.parametrize("name", MODELS)
def test_megakernel_tables_equal(name):
    cfg_j, cfg_t = JSimConfig(), SimConfig()
    jt = jax_physics_tables(jax_compile_model(name))
    tt = physics_tables(compile_model(name))
    jm = JaxMega(jt, cfg_j, interpret=True)
    tm = MegaPhysics(tt, cfg_t, "cpu")
    for k in ("_floor_beta", "_pair_beta"):
        _eq(jt[k], tt[k], k)
    for k in ("Kf", "Kp", "Ke", "K", "P"):
        assert getattr(jm, k) == getattr(tm, k), k
    for k in (
        "lf_corner", "lf_part", "lf_fric", "lane_beta", "lp_corner",
        "lp_part_a", "lp_part_b", "lp_fric", "lp_dst_pos", "lp_dst_quat",
        "lp_dst_size", "ep_a", "ep_b", "lane_fric", "mass", "com_l", "inertia_l",
    ):
        _eq(getattr(jm, k), getattr(tm, k), k)
    # the TPU's one-hot lane->part matrices become index arrays
    _eq(np.argmax(jm.OA, 1), tm.part_a, "part_a")
    has_b = jm.OB.any(1)
    _eq(np.where(has_b, np.argmax(jm.OB, 1), -1), tm.part_b, "part_b")
    jm._consts()
    pc, lpc = jm._const_arrays[0], jm._const_arrays[10]
    _eq(pc, tm.part_const, "part_const")
    _eq(lpc, tm.lp_const, "lp_const")
    # the kernel's packed lane table carries the same numbers
    Kf, Kp = tm.Kf, tm.Kp
    lc = tm.lane_const
    _eq(lc[:Kf, :3], jm.lf_corner, "lane_const floor")
    _eq(lc[Kf : Kf + Kp, :13], lpc, "lane_const pair")
    _eq(lc[Kf + Kp :, :10], jm.ep_a, "lane_const edge a")
    _eq(lc[Kf + Kp :, 10:20], jm.ep_b, "lane_const edge b")
    _eq(lc[:, 20], jm.lane_fric, "lane_const friction")
    _eq(lc[:, 21], jm.lane_beta, "lane_const beta")
    # per-part lane lists: the columns of OA (side a, floor lanes first) and
    # OB (side b), the floor-lane count the columns of the floor mask
    for p in range(tm.P):
        ent = tm.part_ent[tm.part_off[p] : tm.part_off[p + 1]]
        a = np.flatnonzero(jm.OA[:, p])
        b = np.flatnonzero(jm.OB[:, p])
        _eq(ent, np.concatenate([a << 1, (b << 1) | 1]), f"part {p} lanes")
        assert tm.part_nfloor[p] == int(jm.floor_mask_p[p].sum()), p
