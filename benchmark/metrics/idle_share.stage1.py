"""`idle_share.stage1` (%): the stage-1 extractor step: share of a profiled
span of two whole train steps in which no kernel or copy ran on the device,
overlapping work merged."""

from benchmark.harness import readers


def read(run):
    return readers.idle_share(run)
