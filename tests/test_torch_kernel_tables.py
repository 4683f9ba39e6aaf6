"""PyTorch port: the slot-order tables the two physics kernels read.

The CUDA kernels (``csrc/megakernel.cu``, ``csrc/arm_megakernel.cu``) read
their lanes in slot order: sorted by a-side part and dealt to the block's
threads so that the lanes of a segment of a warp share that part, with
masked dummy slots as padding. The permutation is built once, in
``megakernel.slot_tables`` (over a thread-block cluster's CTAs in
``megakernel.cluster_tables``); these tests hold it against the tables in
lane order on the CPU (numpy only, nothing compiled), check kernel 1's route
for every model, and check that the plain versions, which read the
lane-order tables, are untouched by it.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from furniture_tpu_torch.config import EnvConfig, SimConfig
from furniture_tpu_torch.envs.arm import ArmEnv
from furniture_tpu_torch.envs.cursor import CursorEnv
from furniture_tpu_torch.models import compile_model, furniture_names
from furniture_tpu_torch.physics import arm_megakernel, megakernel
from furniture_tpu_torch.physics.engine import physics_tables
from furniture_tpu_torch.physics.megakernel import (
    CLUSTER_THREADS,
    KIND_FLOOR,
    KIND_PAD,
    KIND_ROBOT1,
    KIND_ROBOT2,
    KIND_SAT,
    KIND_VERTEX,
    LANE_CONST_COLS,
    MAX_CLUSTER,
    MAX_SMEM,
    ROUTE_CLUSTER,
    ROUTE_REGS,
    ROUTE_SMEM,
    SEGMENT,
    MegaPhysics,
    block_words,
    cluster_tables,
    cluster_words,
    pack_slot,
    slot_tables,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def free_physics():
    return CursorEnv(EnvConfig(), device="cpu").physics


@pytest.fixture(scope="module")
def arm_physics():
    env = ArmEnv(EnvConfig(agent_type="Sawyer", control_type="impedance"), device="cpu")
    return env.physics


def _layouts():
    return [("free", megakernel.THREADS, megakernel.SEGMENT),
            ("arm", arm_megakernel.THREADS, arm_megakernel.SEGMENT)]


@pytest.fixture(params=_layouts(), ids=lambda p: p[0])
def layout(request, free_physics, arm_physics):
    which, threads, segw = request.param
    return (free_physics if which == "free" else arm_physics), threads, segw


def _unpack(pk):
    """(part_a, part_b, kind, b-buffer index) of packed slot words."""
    pk = np.asarray(pk).astype(np.int64) & 0xFFFFFFFF
    return pk & 0xFF, ((pk >> 8) & 0xFF) - 1, (pk >> 16) & 0x7, ((pk >> 19) & 0x1FFF) - 1


def _segment_of_slot(slot, lpt, segw):
    """Segment of the thread that owns ``slot`` (thread (warp w, lane l),
    round r, has slot (w * lpt + r) * 32 + l)."""
    w, l = (slot // 32) // lpt, slot % 32
    return w * (32 // segw) + l // segw


def test_slot_permutation_is_a_permutation(layout):
    """Every lane has exactly one slot, every used slot one lane, and the
    block's slots are threads x rounds."""
    ph, threads, _ = layout
    sl = ph.slots
    assert sl["KS"] == threads * sl["lpt"]
    assert sl["lane_of_slot"].shape == (sl["KS"],)
    used = sl["lane_of_slot"] >= 0
    assert np.array_equal(np.sort(sl["lane_of_slot"][used]), np.arange(ph.K))
    assert np.array_equal(sl["lane_of_slot"][sl["slot_of_lane"]], np.arange(ph.K))


def test_segments_share_their_a_side_part(layout):
    """Every lane of a segment has the same ``part_a``, that part owns the
    segment in ``seg_off``, and the rounds are the fewest that fit."""
    ph, threads, segw = layout
    sl = ph.slots
    lpt, nseg = sl["lpt"], threads // segw
    seg = _segment_of_slot(np.arange(sl["KS"]), lpt, segw)
    used = np.flatnonzero(sl["lane_of_slot"] >= 0)
    part_of_seg = np.full(nseg, -1)
    for s, k in zip(seg[used], sl["lane_of_slot"][used]):
        assert part_of_seg[s] in (-1, ph.part_a[k]), s
        part_of_seg[s] = ph.part_a[k]
    assert sl["seg_off"][0] == 0 and sl["seg_off"][-1] <= nseg
    for p in range(ph.P):
        owned = np.arange(sl["seg_off"][p], sl["seg_off"][p + 1])
        assert np.all(part_of_seg[owned] == p), p
        n_p = int(np.sum(ph.part_a == p))
        assert len(owned) == -(-n_p // (segw * lpt)), p
    counts = np.bincount(ph.part_a, minlength=ph.P)
    if lpt > 1:
        assert sum(-(-int(n) // (segw * (lpt - 1))) for n in counts) > nseg


def test_padded_slots_are_masked(layout):
    """A slot without a lane has kind ``KIND_PAD`` (the kernels skip it: it
    adds nothing to any sum), no b-buffer entry and a zero constant row."""
    ph, _, _ = layout
    sl = ph.slots
    pad = sl["lane_of_slot"] < 0
    assert pad.sum() == sl["KS"] - ph.K
    _, _, kind, b_slot = _unpack(sl["slot_i"][:, 0])
    assert np.all(kind[pad] == KIND_PAD)
    assert np.all(kind[~pad] != KIND_PAD)
    assert np.all(b_slot[pad] == -1)
    assert not sl["slot_const"][pad].any()


def test_slot_rows_carry_their_lane(layout):
    """Packed parts, kind and the 22 constants of every used slot are its
    lane's; the constant rows are padded to 16-byte multiples."""
    ph, _, _ = layout
    sl = ph.slots
    used = np.flatnonzero(sl["lane_of_slot"] >= 0)
    lanes = sl["lane_of_slot"][used]
    pa, pb, kind, _ = _unpack(sl["slot_i"][used, 0])
    assert np.array_equal(pa, ph.part_a[lanes])
    assert np.array_equal(pb, ph.part_b[lanes])
    assert np.array_equal(kind, ph.lane_kind[lanes])
    assert sl["slot_const"].shape == (sl["KS"], LANE_CONST_COLS) and LANE_CONST_COLS % 4 == 0
    assert np.array_equal(sl["slot_const"][used, :22], ph.lane_const[lanes])
    assert not sl["slot_const"][:, 22:].any()
    assert sl["slot_i"].dtype == np.int32 and sl["slot_i"].shape == (sl["KS"], 4)
    assert pack_slot(3, -1, KIND_FLOOR, -1) == 3 | (KIND_FLOOR << 16)
    assert _unpack(pack_slot(200, 253, KIND_ROBOT2, 8189)) == (200, 253, KIND_ROBOT2, 8189)


def test_lane_kinds_by_block(free_physics, arm_physics):
    """Floor, vertex and SAT lanes in the free tables; the arm tables add
    the two robot blocks after them."""
    f, a = free_physics, arm_physics
    want = [KIND_FLOOR] * f.Kf + [KIND_VERTEX] * f.Kp + [KIND_SAT] * f.Ke
    assert f.lane_kind.tolist() == want
    assert a.lane_kind.tolist() == want + [KIND_ROBOT1] * a.L + [KIND_ROBOT2] * a.L


def test_b_side_list_covers_each_b_lane_once(layout):
    """The b buffer has one entry per lane with a part on its b side, the
    entries of a part are one contiguous range of ``b_off``, and no other
    lane has an entry."""
    ph, _, _ = layout
    sl = ph.slots
    has_b = ph.part_b >= 0
    bs = sl["b_slot_of_lane"]
    assert np.all(bs[~has_b] == -1)
    assert np.array_equal(np.sort(bs[has_b]), np.arange(has_b.sum()))
    assert sl["b_off"][0] == 0 and sl["b_off"][-1] == has_b.sum()
    for p in range(ph.P):
        lanes = np.flatnonzero(ph.part_b == p)
        assert np.array_equal(np.sort(bs[lanes]), np.arange(sl["b_off"][p], sl["b_off"][p + 1])), p
    # the slot rows point at the same entries
    used = np.flatnonzero(sl["lane_of_slot"] >= 0)
    assert np.array_equal(_unpack(sl["slot_i"][used, 0])[3], bs[sl["lane_of_slot"][used]])


def test_part_lists_agree_with_the_lane_order_lists(layout):
    """Through the permutation, the segments and the b buffer hold exactly
    the (lane, side) entries of the lane-order lists ``part_ent``."""
    ph, threads, segw = layout
    sl = ph.slots
    seg = _segment_of_slot(np.arange(sl["KS"]), sl["lpt"], segw)
    for p in range(ph.P):
        ent = ph.part_ent[ph.part_off[p] : ph.part_off[p + 1]]
        a_lanes, b_lanes = ent[(ent & 1) == 0] >> 1, ent[(ent & 1) == 1] >> 1
        in_seg = (seg >= sl["seg_off"][p]) & (seg < sl["seg_off"][p + 1]) & (sl["lane_of_slot"] >= 0)
        assert np.array_equal(np.sort(sl["lane_of_slot"][in_seg]), np.sort(a_lanes)), p
        got_b = np.flatnonzero(
            (sl["b_slot_of_lane"] >= sl["b_off"][p]) & (sl["b_slot_of_lane"] < sl["b_off"][p + 1])
        )
        assert np.array_equal(got_b, np.sort(b_lanes)), p


def test_floor_list_points_at_the_floor_lanes(layout):
    """``floor_slot`` lists, part by part, the slots of the part's floor
    lanes: the head of its lane-order list (``part_nfloor``)."""
    ph, _, _ = layout
    sl = ph.slots
    assert sl["floor_off"][-1] == ph.Kf == len(sl["floor_slot"])
    for p in range(ph.P):
        lanes = sl["lane_of_slot"][sl["floor_slot"][sl["floor_off"][p] : sl["floor_off"][p + 1]]]
        head = ph.part_ent[ph.part_off[p] : ph.part_off[p] + ph.part_nfloor[p]] >> 1
        assert np.array_equal(lanes, head), p
        assert np.all(lanes < ph.Kf)


def test_sat_gate_table_points_at_the_same_lanes(layout):
    """A SAT lane's 16 corner slots hold the lanes ``Kf + e*8 + j`` and
    ``Kf + (Ke+e)*8 + j`` of the lane order, and the SAT slot carries its
    pair index."""
    ph, _, _ = layout
    sl = ph.slots
    Kf, Kp, Ke = ph.Kf, ph.Kp, ph.Ke
    assert sl["sat_corner"].shape == (Ke, 16)
    for e in range(Ke):
        lanes = sl["lane_of_slot"][sl["sat_corner"][e]]
        want = [Kf + e * 8 + j for j in range(8)] + [Kf + (Ke + e) * 8 + j for j in range(8)]
        assert lanes.tolist() == want, e
        # the corner lanes are the vertex lanes of the SAT lane's geom pair
        sat = Kf + Kp + e
        assert {ph.part_a[sat], ph.part_b[sat]} == {ph.part_a[want[0]], ph.part_b[want[0]]}
        assert sl["slot_i"][sl["slot_of_lane"][sat], 1] == e


def test_hand_geom_tables_point_at_the_same_lanes(arm_physics):
    """Robot slots carry their lane's hand-geom slot and finger code, and
    the per-geom lists in slot order are the lane-order lists through the
    permutation."""
    ph = arm_physics
    sl = ph.slots
    robot = np.arange(ph.Kb, ph.K)
    slots = sl["slot_of_lane"][robot]
    assert np.array_equal(sl["slot_i"][slots, 1], ph.lane_slot)
    assert np.array_equal(sl["slot_i"][slots, 2], ph.lane_finger)
    assert np.array_equal(sl["lane_of_slot"][ph.rg_ent_slot], ph.rg_ent)
    for g in range(ph.NRG):
        lanes = sl["lane_of_slot"][ph.rg_ent_slot[ph.rg_off[g] : ph.rg_off[g + 1]]]
        assert np.all(ph.lane_slot[lanes - ph.Kb] == g), g
    # no robot lane has a b side
    assert np.all(sl["b_slot_of_lane"][robot] == -1)


def test_kernel_layout_sizes(free_physics, arm_physics):
    """The shapes the main paths launch with: table_lack fits one lane per
    thread (240 slots of 256), Sawyer makes three rounds of 512 threads."""
    f, a = free_physics.slots, arm_physics.slots
    assert (f["lpt"], f["KS"], int(f["seg_off"][-1])) == (1, 256, 15)
    assert (a["lpt"], a["KS"], int(a["seg_off"][-1])) == (3, 1536, 15)
    assert int(f["b_off"][-1]) == int(a["b_off"][-1]) == 170


@pytest.mark.parametrize("segw,threads", [(16, 64), (32, 128), (16, 256)])
def test_slot_tables_on_a_made_up_model(segw, threads):
    """A small made-up lane list (uneven parts, one part without lanes):
    the rounds grow until the segments fit, and the invariants hold."""
    rng = np.random.default_rng(0)
    P, Kf, Ke = 4, 16, 2
    part_a = np.concatenate([np.repeat([0, 2], 8), rng.choice([0, 2, 3], 32), [0, 2], rng.choice([0, 3], 40)])
    part_b = np.concatenate([np.full(16, -1), rng.choice([0, 2, 3], 32), [2, 3], np.full(40, -1)])
    K = len(part_a)
    kind = np.concatenate([np.full(16, KIND_FLOOR), np.full(32, KIND_VERTEX), np.full(2, KIND_SAT),
                           np.full(40, KIND_ROBOT1)])
    lc = rng.standard_normal((K, 22)).astype(np.float32)
    sl = slot_tables(part_a, part_b, kind, lc, np.arange(K), -np.arange(K), Kf, Ke, P, threads, segw)
    assert sl["KS"] == threads * sl["lpt"]
    used = np.flatnonzero(sl["lane_of_slot"] >= 0)
    assert np.array_equal(np.sort(sl["lane_of_slot"][used]), np.arange(K))
    seg = _segment_of_slot(used, sl["lpt"], segw)
    for p in range(P):
        mine = (seg >= sl["seg_off"][p]) & (seg < sl["seg_off"][p + 1])
        assert np.all(part_a[sl["lane_of_slot"][used[mine]]] == p)
    assert sl["seg_off"][2] == sl["seg_off"][1]            # part 1 has no lane
    assert np.array_equal(sl["slot_i"][used, 1], sl["lane_of_slot"][used])
    assert np.array_equal(sl["slot_i"][used, 2], -sl["lane_of_slot"][used])
    assert np.array_equal(sl["slot_const"][used, :22], lc[sl["lane_of_slot"][used]])


def test_too_many_parts_is_refused():
    """More parts than the packed index holds, or more parts with lanes
    than the block has segments: an error, not a wrong table."""
    args = (np.full(4, KIND_FLOOR), np.zeros((4, 22), np.float32), np.zeros(4, int),
            np.zeros(4, int), 4, 0)
    with pytest.raises(ValueError, match="8 bits"):
        slot_tables(np.zeros(4, int), np.full(4, -1), *args, 300, 256, 16)
    with pytest.raises(ValueError, match="segment each"):
        slot_tables(np.arange(4), np.full(4, -1), *args, 4, 64, 32)


def test_operation_counts_do_not_follow_the_layout(free_physics, arm_physics):
    """The roofline yardstick counts the function's work (one impulse
    application per (lane, side) entry and one lambda update per lane and
    pass), not what the kernels' slot layout makes of it: 408,800 and
    1,921,020 FP32 operations per env per substep on table_lack, linear in
    the substeps, whatever the permutation."""
    f, a = free_physics, arm_physics
    assert f.fp32_ops_per_env(1) == 408800
    assert a.fp32_ops_per_env(1) == 1921020
    assert f.fp32_ops_per_env(50) == 50 * 408800
    saved = dict(f.slots)
    try:
        f.slots.update(lpt=7, KS=7 * megakernel.THREADS)
        assert f.fp32_ops_per_env(1) == 408800
    finally:
        f.slots.update(saved)
    # the entries the count is taken over are the lane-order lists
    assert len(f.part_ent) == f.K + int(np.sum(f.part_b >= 0))


def test_plain_versions_do_not_read_the_slot_tables(free_physics):
    """The plain version's result does not depend on the permutation: with
    the slot tables scrambled it returns the same bits."""
    ph = free_physics
    env = CursorEnv(EnvConfig(sim=SimConfig(control_freq=100)), device="cpu")
    st = env.reset_batch(2, torch.Generator().manual_seed(0))
    gs = torch.ones((2, env._P))
    ref = env.physics.plain_substeps(st.parts, st.group, gs, 3)
    saved = dict(env.physics.slots)
    try:
        for k, v in saved.items():
            if isinstance(v, np.ndarray):
                env.physics.slots[k] = np.zeros_like(v)
        out = env.physics.plain_substeps(st.parts, st.group, gs, 3)
    finally:
        env.physics.slots.update(saved)
    for a, b in zip(ref, out):
        assert torch.equal(a, b)
    assert ph.lane_const.shape == (ph.K, 22)       # the lane-order table keeps its layout


def test_lane_lists_of_a_made_up_model():
    """``lane_lists`` on four lanes over three parts (two floor lanes, one
    pair lane 0-2, one pair lane 2-0): each part's side-a lanes with the
    floor lanes first, then its side-b lanes, as ``(lane << 1) | side``."""
    ent, off, nfloor = megakernel.lane_lists(
        np.array([0, 2, 0, 2]), np.array([-1, -1, 2, 0]), 2, 3
    )
    assert off.tolist() == [0, 3, 3, 6]
    assert ent[off[0] : off[1]].tolist() == [0 << 1, 2 << 1, (3 << 1) | 1]
    assert ent[off[2] : off[3]].tolist() == [1 << 1, 3 << 1, (2 << 1) | 1]
    assert nfloor.tolist() == [1, 0, 1]


def _free_physics(name):
    """Kernel 1's wrapper of a model on the CPU (its tables; nothing compiled)."""
    return MegaPhysics(physics_tables(compile_model(name)), SimConfig(), "cpu")


def test_route_of_every_model():
    """Kernel 1's route for each of the 64 models, from its bytes alone
    (``MegaPhysics.layout``): 8 run one lane a thread, 42 keep their lanes'
    working set in one block's shared memory, and the 14 over that limit
    take the cluster route, each on the fewest CTAs (here 2 to 5, never over
    ``MAX_CLUSTER``) whose share of the working set fits ``MAX_SMEM``:
    bed_dalselv_0270, just over one block, on 2, chair_balser_0115 on 3,
    toy_table, the largest, on 5."""
    routes, sizes = Counter(), {}
    for name in furniture_names:
        ph = _free_physics(name)
        lay, sl = ph.layout, ph.slots
        routes[lay.route] += 1
        one_block = 4 * block_words(ph.P, ph.Kf, ph.Ke, sl["KS"], int(sl["b_off"][-1]), sl["lpt"] == 1)
        assert lay.smem <= MAX_SMEM, name
        if lay.route != ROUTE_CLUSTER:
            assert ph.cluster is None and lay.cluster == 1 and lay.smem == one_block, name
            assert (lay.route == ROUTE_REGS) == (sl["lpt"] == 1), name
            continue
        ct = ph.cluster
        assert one_block > MAX_SMEM and 2 <= lay.cluster <= MAX_CLUSTER, name
        assert (lay.threads, ct["C"]) == (CLUSTER_THREADS, lay.cluster), name
        assert lay.smem == 4 * cluster_words(ph.P, ph.Kf, ct["KS"], CLUSTER_THREADS // SEGMENT,
                                             ct["NBS"], ct["NJ"], lay.cluster), name
        if lay.cluster > 2:   # one CTA fewer does not fit
            fewer = cluster_tables(ph.part_a, ph.part_b, ph.lane_kind, ph.lane_const, ph._aux0,
                                   np.zeros(ph.K, int), ph.Kf, ph.Ke, ph.P, CLUSTER_THREADS,
                                   lay.cluster - 1, SEGMENT)
            assert 4 * cluster_words(ph.P, ph.Kf, fewer["KS"], CLUSTER_THREADS // SEGMENT,
                                     fewer["NBS"], fewer["NJ"], lay.cluster - 1) > MAX_SMEM, name
        sizes[name] = lay.cluster
    assert routes == {ROUTE_REGS: 8, ROUTE_SMEM: 42, ROUTE_CLUSTER: 14}
    assert (sizes["bed_dalselv_0270"], sizes["chair_balser_0115"], sizes["toy_table"]) == (2, 3, 5)


@pytest.mark.parametrize("name", ["chair_balser_0115", "toy_table"])
def test_cluster_tables_replay_the_part_sums(name):
    """The cluster route's tables hold every lane once and sum like the
    lane-order lists: CTA r's slots are the r-th run of the cluster-wide
    slot order, every lane with a b side has one entry in its CTA's own
    buffer (ordered by b-side part, ``b_off``), each CTA's jobs cover its
    segment partials and b entries once, each job within one part, and the
    SAT gate's codes and lists point at the right lanes. Random per-lane a-
    and b-side values replayed in float64 in the kernel's order (segments, b
    entries, jobs, each part's jobs, the CTAs in rank order) give each part's
    sum over its lane-order list ``part_ent``."""
    ph = _free_physics(name)
    ct, P = ph.cluster, ph.P
    C, KS, lpt = ct["C"], ct["KS"], ct["lpt"]
    nseg = CLUSTER_THREADS // SEGMENT
    lane_of_slot = ct["lane_of_slot"]
    assert lane_of_slot.shape == (C * KS,) and KS == CLUSTER_THREADS * lpt
    used = lane_of_slot >= 0
    assert np.array_equal(np.sort(lane_of_slot[used]), np.arange(ph.K))
    rng = np.random.default_rng(0)
    a_val, b_val = rng.standard_normal((ph.K, 7)), rng.standard_normal((ph.K, 7))
    truth = np.zeros((P, 7))
    for p in range(P):
        ent = ph.part_ent[ph.part_off[p] : ph.part_off[p + 1]]
        truth[p] = a_val[ent[(ent & 1) == 0] >> 1].sum(0) + b_val[ent[(ent & 1) == 1] >> 1].sum(0)
    # a slot's thread (warp w, lane l, round r: slot (w * lpt + r) * 32 + l) and its segment
    local = np.arange(KS)
    seg_of_local = (local // 32 // lpt) * (32 // SEGMENT) + (local % 32) // SEGMENT
    pa, pb, kind, b_idx = _unpack(ct["slot_i"][:, 0])
    got = np.zeros((P, 7))
    for r in range(C):
        lanes = lane_of_slot[r * KS : (r + 1) * KS]
        mine = lanes >= 0
        entries = np.zeros((nseg + ct["NBS"], 7))
        np.add.at(entries, seg_of_local[mine], a_val[lanes[mine]])
        seg_part = np.full(nseg, -1)
        seg_part[seg_of_local[mine]] = ph.part_a[lanes[mine]]
        bi = b_idx[r * KS : (r + 1) * KS]
        with_b = mine & (bi >= 0)
        nb = int(ct["b_off"][r, -1])
        assert np.array_equal(np.sort(bi[with_b]), np.arange(nb))
        assert np.array_equal(np.asarray(ph.part_b)[lanes[with_b]] >= 0, np.ones(with_b.sum(), bool))
        assert not np.any((np.asarray(ph.part_b)[lanes[mine]] >= 0) & (bi[mine] < 0))
        entries[nseg + bi[with_b]] = b_val[lanes[with_b]]
        b_part = np.full(nb, -1)
        b_part[bi[with_b]] = np.asarray(ph.part_b)[lanes[with_b]]
        assert np.all(np.diff(b_part) >= 0)
        for p in range(P):
            assert np.all(b_part[ct["b_off"][r, p] : ct["b_off"][r, p + 1]] == p)
        covered = np.zeros(nseg + nb, int)
        jo = ct["job_off"][r]
        for p in range(P):
            for w in ct["jobs"][r, jo[p] : jo[p + 1]]:
                first, n = int(w) & 0xFFFF, int(w) >> 16
                assert n > 0
                covered[first : first + n] += 1
                owner = [seg_part[e] if e < nseg else b_part[e - nseg] for e in range(first, first + n)]
                assert set(owner) == {p}, (r, p)
                got[p] += entries[first : first + n].sum(0)
        # every segment of a part and every b entry is in exactly one job
        assert np.all(covered[: nseg][seg_part >= 0] == 1) and np.all(covered[nseg:] == 1)
        assert jo[-1] <= ct["NJ"] and jo[-1] <= CLUSTER_THREADS // 8
        sat = ct["sat_list"][ct["sat_off"][r] : ct["sat_off"][r + 1]]
        assert np.all(kind[r * KS + sat] == KIND_SAT)
    assert np.allclose(got, truth, rtol=0, atol=1e-9)
    assert ct["sat_off"][-1] == ph.Ke
    # the SAT gate reads the 16 corner lanes of each SAT lane where they lie
    code = ct["sat_corner"]
    corner = lane_of_slot[(code >> 16) * KS + (code & 0xFFFF)]
    for e in range(ph.Ke):
        want = [ph.Kf + e * 8 + j for j in range(8)] + [ph.Kf + (ph.Ke + e) * 8 + j for j in range(8)]
        assert corner[e].tolist() == want, e
