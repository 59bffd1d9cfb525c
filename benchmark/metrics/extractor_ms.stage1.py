"""`extractor_ms.stage1` (ms): the stage-1 extractor step's model on the
device: the intervals on the device's clock of the `lfo.forward`
(frontend, SpecAugment, trunk, head, post-processing, losses) and
`lfo.backward` spans in each `lfo.step` span of the traced run's profiled
steps, their mean.  The device's waits for the host count: the backward
keeps the device busy, the forward reads the profiled host's pace."""

import statistics


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    steps = [v for v in spans.per_unit("lfo.step", ("lfo.forward", "lfo.backward")) if v is not None]
    return statistics.fmean(steps) if steps else None
