"""`buffer_device_ms` (ms): merged device-busy time a processor call, over a
profiled span of open-loop calls."""

from benchmark.harness import readers


def read(run):
    return readers.device_ms(run, "buffer")
