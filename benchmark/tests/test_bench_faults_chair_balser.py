"""``correct`` comes out false for the control and for each fault of
``test_bench_faults.py`` (a step that returns its state unchanged, half of
the batch left out, an answer altered) on the cursor's cell on
chair_balser_0115: the harness's whole run on the CPU dry path at B = 2,
with the cell's own limits."""

import pytest
from test_bench_faults import STEP_SHRINK, _altered, _half, _run, _unchanged

from furniture_tpu_torch.envs.cursor import CursorEnv

from benchmark import core

SHRINK = {**STEP_SHRINK, "mix": {**STEP_SHRINK["mix"], "batch": 2}}
CELL = "chair_balser.random-b1024"


def test_sound_run_and_control():
    r = _run(CELL, SHRINK, control=True)
    assert r["correct"], r["checks"]
    assert all(v == 0.0 for v in r["numbers"].values())
    limits = core.Cell(CELL).mix["checks"]
    assert any(r["control"][k] > lim for k, lim in limits.items()), (r["control"], limits)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_step_faults_fail(fault, monkeypatch):
    monkeypatch.setattr(CursorEnv, "step_batch", fault(CursorEnv.step_batch))
    assert not _run(CELL, SHRINK)["correct"]
