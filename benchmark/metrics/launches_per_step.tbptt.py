"""`launches_per_step.tbptt` (count): the stage-2 TBPTT step: host CUDA
runtime calls that put work on the device (kernel and graph launches, async
copies, memsets) in a profiled span of two whole train steps, per step."""

from benchmark.harness import readers


def read(run):
    return readers.launches(run, "step")
