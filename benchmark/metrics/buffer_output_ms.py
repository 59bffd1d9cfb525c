"""`buffer_output_ms` (ms): the median over the traced run's profiled calls
of the host ms of the `processor.output` span (`export/streaming.py`): the
wait for the device, the output's copy back and numpy."""


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    found = spans.summary().get("processor.output")
    return None if found is None else found["host_ms_median"]
