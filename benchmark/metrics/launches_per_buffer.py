"""`launches_per_buffer` (count): as `launches_per_step`, per processor call,
over a profiled span of open-loop calls."""

from benchmark.harness import readers


def read(run):
    return readers.launches(run, "buffer")
