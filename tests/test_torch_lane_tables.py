"""PyTorch port: the static tables the lane solver's kernel reads.

The kernel (``csrc/lane_solver.cu``) reads its lanes in slot order: sorted
by a-side part into 16 segments a block (``megakernel.slot_tables``), every
slot of a segment on one part, padded with empty slots; the b sides go to
entries ordered by b-side part (an octet of slots whose b sides share a part
folds them into one); one warp per rigid group adds its members' segment
partials and b entries. These tests hold the tables against the
lanes in lane order on the CPU (numpy only, nothing compiled), and replay
one sweep's sums through them against the plain version's membership form.
"""

import numpy as np
import pytest
import torch

from furniture_tpu_torch.config import SimConfig
from furniture_tpu_torch.models import compile_model
from furniture_tpu_torch.physics import engine, lane_solver
from furniture_tpu_torch.physics.lane_solver import (
    ROUTE_MEMORY,
    ROUTE_REGS,
    SEGMENT_WIDTH,
    SEGMENTS,
    THREADS,
    LaneTables,
)
from furniture_tpu_torch.physics.megakernel import LanePhysics
from furniture_tpu_torch.physics.state import PartState

torch.set_num_threads(1)

NAMES = ("table_lack_0825", "chair_balser_0115", "bookcase_grevback_0484")


def _model(name):
    """The lane backend of a model on the CPU and the lanes of one state
    (their static fields are the model's)."""
    tb = engine.physics_tables(compile_model(name))
    phys = LanePhysics(tb, SimConfig(use_pallas="lane"), "cpu")
    P = len(tb["part_mass"])
    z = torch.zeros((1, P, 3))
    parts = PartState(z, torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(1, P, 1), z, z)
    c = phys.solver_args(parts, torch.arange(P, dtype=torch.int32)[None], torch.ones((1, P)))[0]
    return phys, c, P


@pytest.fixture(scope="module")
def models():
    return {name: _model(name)[1:] for name in NAMES}


CASES = [
    ("table_lack_0825", None, ROUTE_REGS),
    ("table_lack_0825", ROUTE_MEMORY, ROUTE_MEMORY),
    ("chair_balser_0115", None, ROUTE_MEMORY),
    ("bookcase_grevback_0484", None, ROUTE_MEMORY),   # P = 14, the most parts of the 64
]


@pytest.mark.parametrize("name,route,want", CASES, ids=lambda v: str(v))
def test_slot_order(models, name, route, want):
    """Every lane in exactly one slot; a thread's slots and a segment's
    slots on one a-side part; each part's segments contiguous, in part
    order; the padding empty; the route's rounds a thread."""
    c, P = models[name]
    t = LaneTables.of(c, P, route)
    pa, pb = c.part_a.numpy(), c.part_b.numpy()
    K = len(pa)
    segw = SEGMENT_WIDTH
    assert t.route == want and t.K == K
    assert t.KS == THREADS * t.lpt
    if want == ROUTE_REGS:
        assert t.lpt == 1
    else:
        assert 1 <= t.lpt <= lane_solver.MAX_ROUNDS
    los = t.lane_of_slot
    assert sorted(los[los >= 0].tolist()) == list(range(K))
    # slot of round r of thread (warp w, lane l): (w * lpt + r) * 32 + l;
    # its segment: w * (32 // segw) + l // segw
    slot = np.arange(t.KS)
    lane, rest = slot % 32, slot // 32
    seg = (rest // t.lpt) * (32 // segw) + lane // segw
    assert seg.max() == SEGMENTS - 1
    seg_part = np.full(SEGMENTS, -1)
    for s_, k in zip(seg, los):
        if k >= 0:
            assert seg_part[s_] in (-1, pa[k])
            seg_part[s_] = pa[k]
    so = t.seg_off_np
    assert so[0] == 0 and np.all(np.diff(so) >= 0) and so[-1] <= SEGMENTS
    for p in range(P):
        assert np.all(seg_part[so[p] : so[p + 1]] == p)
        assert (so[p + 1] > so[p]) == bool(np.any(pa == p))
    # padding slots: no lane, no b side, no friction or beta; a b entry only
    # as a slot of a folded octet
    pad = los < 0
    word = t.slot_i_np[pad, 3]
    assert np.all(t.slot_i_np[pad, 2] == -1) and not t.slot_f_np[pad].any()
    assert np.all((word == -1) | ((word & lane_solver.ENTRY_FOLDED) != 0))
    assert t.slot_i_np.dtype == np.int32 and t.slot_f_np.dtype == np.float32


@pytest.mark.parametrize("name", ["table_lack_0825", "chair_balser_0115"])
def test_b_buffer_order(models, name):
    """Each lane with a side b has one b entry on its b part; an entry is
    one lane's or an octet's (8 consecutive slots whose lanes with a side b,
    at least two, share that part: every slot of the octet carries the
    entry and the fold flag); the entries are ordered by b-side part with
    offsets ``b_off``."""
    c, P = models[name]
    t = LaneTables.of(c, P)
    pb = c.part_b.numpy()
    be = t.b_entry_of_lane
    has_b = pb >= 0
    assert np.all((be >= 0) == has_b)
    assert sorted(set(be[has_b].tolist())) == list(range(t.NBE))
    part_of_entry = np.full(t.NBE, -1)
    for k in np.flatnonzero(has_b):
        assert part_of_entry[be[k]] in (-1, pb[k])
        part_of_entry[be[k]] = pb[k]
    assert np.all(np.diff(part_of_entry) >= 0)
    np.testing.assert_array_equal(t.b_off_np, np.concatenate([[0], np.cumsum(np.bincount(part_of_entry, minlength=P))]))
    word = t.slot_i_np[:, 3].astype(np.int64)
    folded = (word >= 0) & ((word & lane_solver.ENTRY_FOLDED) != 0)
    entry = np.where(word >= 0, word & (lane_solver.ENTRY_FOLDED - 1), -1)
    for o in range(t.KS // 8):
        octet = slice(o * 8, o * 8 + 8)
        lanes = t.lane_of_slot[octet]
        b_lanes = lanes[(lanes >= 0) & (pb[np.maximum(lanes, 0)] >= 0)]
        if folded[octet].any():
            assert folded[octet].all() and len(set(entry[octet])) == 1 and len(b_lanes) >= 2
            assert t.entry_folded[entry[o * 8]]
            assert len(set(pb[b_lanes])) == 1
        else:
            assert len(b_lanes) < 2 or len(set(pb[b_lanes])) > 1
    # the slot rows name the b entry of their lane
    used = (t.lane_of_slot >= 0) & (entry >= 0) & ~folded
    np.testing.assert_array_equal(entry[used], be[t.lane_of_slot[used]])
    # table_lack: the 20 vertex blocks of 8 fold, the 10 SAT lanes do not
    if name == "table_lack_0825":
        assert (t.NBE, int(t.entry_folded.sum())) == (30, 20)


GROUPS = {
    "free": [0, 1, 2, 3, 4],
    "welded": [0, 2, 2, 3, 2],       # table_lack with two recipe steps preassembled
    "one group": [1, 1, 1, 1, 1],    # labels need not be part indices
}


def _group_lists(group):
    """The kernel's group list: groups in the order of their first parts,
    every part's first part."""
    first = [min(q for q in range(len(group)) if group[q] == group[i]) for i in range(len(group))]
    return [i for i in range(len(group)) if first[i] == i], first


@pytest.mark.parametrize("route", [ROUTE_REGS, ROUTE_MEMORY])
@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_group_sums_through_tables(models, groups, route):
    """One sweep's sums replayed through the tables as the kernel takes them
    (a partial per segment, b entries in b-part order with octets folded,
    one sum per rigid group over its members' partials and entries, the
    same sum for every member) equal the plain version's membership products
    ``(mem_a - mem_b)^T imp`` and ``mem_a^T tq_a + mem_b^T tq_b``."""
    c, P = models["table_lack_0825"]
    t = LaneTables.of(c, P, route)
    pa, pb = c.part_a.numpy(), c.part_b.numpy()
    K = len(pa)
    rng = np.random.default_rng(5)
    imp = rng.normal(size=(K, 3))
    r_a, r_b = rng.normal(size=(K, 3)), rng.normal(size=(K, 3))
    tq_a, tq_b = np.cross(r_a, imp), np.cross(r_b, -imp)
    group = np.asarray(GROUPS[groups])
    # plain form
    mem_a = (group[pa][:, None] == group[None, :]).astype(float)
    mem_b = ((group[np.maximum(pb, 0)][:, None] == group[None, :]) & (pb >= 0)[:, None]).astype(float)
    want_lin = (mem_a - mem_b).T @ imp
    want_ang = mem_a.T @ tq_a + mem_b.T @ tq_b
    # through the tables
    segw = SEGMENT_WIDTH
    slot = np.arange(t.KS)
    seg = (slot // 32 // t.lpt) * (32 // segw) + (slot % 32) // segw
    part = np.zeros((SEGMENTS, 6))
    for s_, k in zip(seg, t.lane_of_slot):
        if k >= 0:
            part[s_] += np.concatenate([imp[k], tq_a[k]])
    bbuf = np.zeros((t.NBE, 6))
    for k in np.flatnonzero(pb >= 0):
        bbuf[t.b_entry_of_lane[k]] += np.concatenate([-imp[k], tq_b[k]])
    leads, first = _group_lists(group)
    got = np.full((P, 6), np.nan)
    for lead in leads:
        members = [q for q in range(P) if first[q] == lead]
        s_ = sum(part[t.seg_off_np[q] : t.seg_off_np[q + 1]].sum(0) + bbuf[t.b_off_np[q] : t.b_off_np[q + 1]].sum(0)
                 for q in members)
        got[members] = s_
    np.testing.assert_allclose(got[:, :3], want_lin, atol=1e-9)
    np.testing.assert_allclose(got[:, 3:], want_ang, atol=1e-9)


def test_route_choice_and_limits(models):
    """A model whose lanes fit one a thread takes the register route, the
    register route refuses more lanes than that, and a model with more
    parts than the kernel takes is refused."""
    c, P = models["chair_balser_0115"]
    args = [t.numpy() for t in (c.part_a, c.part_b, c.friction, c.beta)]
    with pytest.raises(ValueError):
        LaneTables(*args, P, ROUTE_REGS)
    small = [a[:40] for a in args]
    assert LaneTables(*small, P).route == ROUTE_REGS
    with pytest.raises(ValueError):
        LaneTables(*args, lane_solver.MAX_PARTS + 1)


def test_tables_built_once_at_set_up():
    """The lane backend builds its model's tables once, when it is set up,
    on its device, equal to the tables of any state's lanes (the static
    fields do not depend on the state), and keeps them: no solve builds
    tables again."""
    phys, c, P = _model("table_lack_0825")
    t = phys.lane_tables
    assert isinstance(t, LaneTables) and phys._substep.lane_tables is t
    assert (t.K, t.P, t.route, t.device) == (c.depth.shape[1], P, ROUTE_REGS, torch.device("cpu"))
    fresh = LaneTables.of(c, P)
    for f in ("slot_i_np", "slot_f_np", "seg_off_np", "b_off_np", "entry_folded"):
        np.testing.assert_array_equal(getattr(t, f), getattr(fresh, f), err_msg=f)
    B = 2
    z = torch.zeros((B, P, 3))
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(B, P, 1)
    group = torch.arange(P, dtype=torch.int32).repeat(B, 1)
    phys.substeps(PartState(z, quat, z, z), group, torch.ones((B, P)), 2)
    assert phys.lane_tables is t
    # the other backend builds none
    tb = engine.physics_tables(compile_model("table_lack_0825"))
    assert engine.make_substep(tb, SimConfig(), torch.device("cpu")).lane_tables is None
