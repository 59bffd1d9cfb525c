"""`trunk_roofline` (%): the least time of `Spectral2DCNN` forward and
backward at the cell's batch (bf16 convs at 989 TFLOP/s, the float32
frontend and head at 67 TFLOP/s), over its CUDA-event time."""

from benchmark.harness import readers


def read(run):
    return readers.roofline(run, "trunk")
