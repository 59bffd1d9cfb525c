"""`render_ms.stage1` (ms): the stage-1 extractor step's render as the
device lives it: the interval on the device's clock of the `render` span
(`train/render.py`, K1 and K2) in each `lfo.step` span of the traced
run's profiled steps, their mean.  The device's waits for the host
count, and under the profiler the host issues the render slower than the
device runs it (layer: host dispatch)."""

import statistics


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    steps = [v for v in spans.per_unit("lfo.step", ("render",)) if v is not None]
    return statistics.fmean(steps) if steps else None
