"""The trace reader: busy time merged, launches counted, idle gaps named."""

import pytest

from benchmark.harness.trace import merge, short_name, summarize


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_merge():
    assert merge([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_summarize():
    events = [
        x("cpu_op", "aten::mm", 0, 100), x("cuda_runtime", "cudaLaunchKernel", 10, 5),
        x("cuda_runtime", "cudaMemcpyAsync", 20, 5), x("cuda_runtime", "cudaStreamSynchronize", 30, 5),
        x("kernel", "k1(float*)", 10, 40), x("gpu_memcpy", "Memcpy HtoD", 30, 40),
        x("cpu_op", "aten::item", 70, 60), x("kernel", "k2<64>(int)", 150, 20),
    ]
    tr = summarize(events, window_s=200e-6, n_units=2)
    assert tr.busy_s == pytest.approx(80e-6)  # (10, 70) and (150, 170) merged
    assert tr.launches == 2
    assert tr.device_ops[0] == ("k1", pytest.approx(40e-6))
    assert tr.idle_gaps[0] == ("aten::item", pytest.approx(80e-6))  # 70 .. 150
    assert {g[0] for g in tr.idle_gaps} >= {"aten::mm"}


@pytest.mark.parametrize("full,short", [
    ("lstm_bwd_walk_fast_kernel<64>(float const*, int)", "lstm_bwd_walk_fast_kernel<64>"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)"
     "::TensorListMetadata<4>, int>(int)", "multi_tensor_apply_kernel<TensorListMetadata<4>, int>"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_short_name(full, short):
    assert short_name(full) == short
