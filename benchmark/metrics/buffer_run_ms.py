"""`buffer_run_ms` (ms): the median over the traced run's profiled calls of
the host ms of the `processor.run` span (`export/streaming.py`): the
loaded `processor.pt2` program's call, as the host issues it."""


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    found = spans.summary().get("processor.run")
    return None if found is None else found["host_ms_median"]
