"""The frozen work count of kernel 4, the joint-dynamics kernel
(``benchmark/roofline/kernel4.py``), against a count by hand: Sawyer's at
B = 512 as the kernel was defined (13.5 MFLOP, 354,108 B), and Baxter's
from the same formula written out over its chain."""

import numpy as np

import benchmark.reference as R
from benchmark.reference.config import EnvConfig
from benchmark.roofline import kernel4


def _robot(agent, furniture):
    return R.make(f"IKEA{agent}-v0", EnvConfig(control_type="impedance", furniture_name=furniture),
                  "cpu").robot


def _by_hand(r):
    """The same terms, counted per body and per (k, j) entry of M."""
    nb, nj = r.nb, r.nj
    hinge = [t == kernel4.HINGE for t in np.asarray(r.jnt_type)]
    ops = 0
    for b in range(nb):
        if r.parent[b] >= 0:
            ops += 30 + 3 + 28                       # child frame: rotate, add, compose
        j = int(r.body_joint[b])
        if j >= 0:
            ops += (4 + 28 + 60 + 6) if hinge[j] else (30 + 6)
        ops += 30 + 3 + 13 + 39 + 90                 # COM, inertia in the world frame
    ops += nj * 63                                   # joint axes and anchors
    ops += 2 * nj                                    # armature, dt·D
    anc = np.asarray(r.ancestor)
    for b in range(nb):
        js = np.flatnonzero(anc[b])
        for a in range(len(js)):
            for c in range(a, len(js)):
                hk, hj = hinge[js[a]], hinge[js[c]]
                ops += 12 * (hk + hj) + 7 + 21 * (hk and hj)
    for k in range(nj):
        m = nj - k - 1
        ops += 1 + m + m * (m + 1)                   # pivot, column, trailing update
    for c in range(nj):
        ops += (nj - c) ** 2 + nj * nj               # the two substitutions
    ops += nj * nj * (2 * nj + 1)                    # G1 = A^-1 M, G2 = dt A^-1
    return ops


def test_sawyer_count_as_defined():
    r = _robot("Sawyer", "table_lack_0825")
    ops, nbytes = kernel4.work(r, 512)
    assert (r.nb, r.nj) == (30, 9)
    assert ops == 13_496_320 and round(ops / 1e6, 1) == 13.5
    assert nbytes == 354_108
    assert kernel4.ops_per_env(r) == _by_hand(r)


def test_baxter_count_by_the_same_formula():
    r = _robot("Baxter", "swivel_chair_0700")
    ops, nbytes = kernel4.work(r, 512)
    assert (r.nb, r.nj) == (37, 19)
    assert ops == 512 * _by_hand(r) == 31_230_976
    # qpos in, G1 and G2 out, and the tables: 28 words a body, 10 a joint,
    # the triangle's 190 pairs
    assert nbytes == 512 * 4 * (19 + 2 * 19 * 19) + 4 * (28 * 37 + 10 * 19 + 190)


def test_call_work_reads_the_batch():
    import torch

    ref = R.make("IKEABaxter-v0", EnvConfig(control_type="impedance",
                                           furniture_name="swivel_chair_0700"), "cpu")
    assert kernel4.call_work(ref, 12, (torch.zeros(7, 19),)) == kernel4.work(ref.robot, 7)
