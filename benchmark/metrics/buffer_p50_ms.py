"""`buffer_p50_ms` (ms): the median, over every call of the window, of the
time from a buffer's due time to its output on the host."""

from benchmark.harness import readers


def read(run):
    return readers.latency_ms(run, 50)
