"""The port's data pipeline: the counterparts of the JAX `data` package's
`__all__`, imported from `wav.py` at first use (`_lazy.py`)."""

from mod_extraction_tpu_torch._lazy import lazy_exports

_EXPORTS = dict.fromkeys(("wav_info", "wav_read", "wav_write", "WavInfo"), "wav")
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
