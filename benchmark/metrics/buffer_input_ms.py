"""`buffer_input_ms` (ms): the median over the traced run's profiled calls
of the host ms of the `processor.input` span (`export/streaming.py`): the
buffer from numpy to the device and the three knob tensors."""


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    found = spans.summary().get("processor.input")
    return None if found is None else found["host_ms_median"]
