"""`lstm_roofline` (%): the least time of one TBPTT chunk's forward and
backward, each launch at the larger of its operation and byte bounds
(float32, 67 TFLOP/s, 3.35 TB/s), over the CUDA-event time of
`LSTMEffectModel` forward and backward on one chunk with carried state."""

from benchmark.harness import readers


def read(run):
    return readers.roofline(run, "lstm_chunk")
