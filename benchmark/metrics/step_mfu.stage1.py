"""`step_mfu.stage1` (%): the stage-1 extractor step: the least time of a
train step's model work, each part at the peak of the precision it runs in
(`harness/counts.py`), over the mean host-clock time of the window's steps
(the traced run's steps outside its profiled span)."""

from benchmark.harness import readers


def read(run):
    return readers.step_mfu(run)
