"""``correct`` comes out false for the control and for each fault of
``test_bench_faults.py`` (a step that returns its state unchanged, half of
the batch left out, an answer altered) on the two arm cells added after it,
Baxter bimanual on swivel_chair under impedance and Sawyer under ik: the
harness's whole run on the CPU dry path at B = 2, with the cells' own
limits."""

import pytest
from test_bench_faults import STEP_SHRINK, _altered, _half, _run, _unchanged

from furniture_tpu_torch.envs.arm import ArmEnv

from benchmark import core

SHRINK = {**STEP_SHRINK, "mix": {**STEP_SHRINK["mix"], "batch": 2}}
CELLS = ("baxter.impedance-b512", "sawyer.ik-b256")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_and_control(workload):
    r = _run(workload, SHRINK, control=True)
    assert r["correct"], r["checks"]
    assert all(v == 0.0 for v in r["numbers"].values())
    limits = core.Cell(workload).mix["checks"]
    assert any(r["control"][k] > lim for k, lim in limits.items()), (r["control"], limits)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_step_faults_fail(workload, fault, monkeypatch):
    monkeypatch.setattr(ArmEnv, "step_batch", fault(ArmEnv.step_batch))
    assert not _run(workload, SHRINK)["correct"]
