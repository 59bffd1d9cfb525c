"""`chunk_host_ms.tbptt` (ms): the median over the traced run's profiled
steps' `tbptt.chunk` spans of their host ms: the profiled host's time to
issue a chunk's forward, backward and update.  Read beside
`chunk_device_ms.tbptt`."""


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    found = spans.summary().get("tbptt.chunk")
    return None if found is None else found["host_ms_median"]
