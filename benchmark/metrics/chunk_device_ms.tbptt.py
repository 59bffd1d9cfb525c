"""`chunk_device_ms.tbptt` (ms): the median over the traced run's profiled
steps' `tbptt.chunk` spans of their interval on the device's clock: from
the device reaching a chunk's first work (K4's forward) to its finishing
the last (AdamW), its waits for the host included.  Under the profiler
the host issues a chunk slower than the device runs it, so this reads the
profiled host's pace, not the LSTM kernels' time (layer: host dispatch).
Read beside `chunk_host_ms.tbptt`: where the two meet, the host sets the
chunk's pace in the traced run."""


def read(run):
    try:
        from mod_extraction_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    found = spans.summary().get("tbptt.chunk")
    return None if found is None else found["device_ms_median"]
