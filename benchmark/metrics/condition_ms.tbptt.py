"""`condition_ms.tbptt` (ms): the TBPTT step's conditioning as the device
lives it: the intervals on the device's clock of the `render` (K1) and
`tbptt.condition` (frozen extractor, smoothing, corner stretch, crop,
validity, upsampling) spans in each `tbptt.step` span of the traced run's
profiled steps, their mean.  The device's waits for the host count, and
these small ops are host-paced under the profiler (layer: host
dispatch)."""

import statistics


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    steps = [v for v in spans.per_unit("tbptt.step", ("render", "tbptt.condition")) if v is not None]
    return statistics.fmean(steps) if steps else None
