"""The control, the reference one precision below the configuration's in
the program's place, fails the comparison, at a small size on the CPU:
the train cells' float8 trunk, the stream's LSTM on TF32-rounded operands."""

import pytest

from benchmark import control
from benchmark.harness.common import all_within, judge, make_run
from benchmark.tests.small import shrink


@pytest.mark.parametrize("workload", ["pipeline_h64.extractor_train", "pipeline_h160.tbptt_chorus"])
@pytest.mark.parametrize("variant", ["control", "half_batch"])
def test_train_control_fails(workload, variant):
    values = control.reading(workload, 77, variant, device="cpu", adjust=shrink)
    assert not all_within(judge(values, make_run(workload, 77, 1, False, device="cpu").limits))


def test_stream_control_fails():
    values = control.reading("pipeline_h160.stream128", 78, "control", seconds=0.5, device="cpu")
    assert not all_within(judge(values, make_run("pipeline_h160.stream128", 78, 1, False, device="cpu").limits))
