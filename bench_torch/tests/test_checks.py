"""The comparison deciding ``correct`` fails its control and every fault a
cell can have, with the cells' own limits, at toy sizes on the CPU: the
control is the plain reference in the program's place in the
configuration's ``control_precision``; the faults are planted in the timed
path (``faults.py``), and one underneath it, in the program itself."""

import math
import time

import pytest
from conftest import tiny_cell

from bench_torch import harness

FAULTS = {
    "blstm_separate": ["answer_altered", "half_batch"],
    "blstm_train": ["state_unchanged", "half_batch"],
    "tasnet_stream": ["answer_altered"],
}
CASES = [(w, "control", None) for w in FAULTS] + [(w, "program", f) for w, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("workload,mode,fault", CASES)
def test_control_and_faults_come_out_not_correct(workload, mode, fault, cpu):
    cell = tiny_cell(workload)
    assert cell.limits, f"{workload} has no limits"
    result = harness.run_cell(cell, 2**31 + 23, 0.3, False, t_start=time.perf_counter(), device=cpu,
                              mode=mode, fault=fault)
    assert result["correct"] is False, result["checks"]
    # failed on what it compared, not for want of an answer
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_step_that_never_updates_underneath_is_caught(cpu, monkeypatch):
    from speech_separation_tpu_torch.train.state import TrainState

    def unchanged(self):
        self.optimizer.zero_grad(set_to_none=True)
        return self

    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)
    result = harness.run_cell(tiny_cell("blstm_train"), 7, 0.3, False, t_start=time.perf_counter(),
                              device=cpu)
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
