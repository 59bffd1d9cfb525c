"""The port's utilities: the counterparts of the JAX `utils` package's
`__all__` that exist here, imported from their modules at first use
(`_lazy.py`).

The `utils/prng.py` samplers (`sample_uniform`, `sample_log_uniform`,
`sample_randint`, `sample_choice`) are not ported, on purpose: they draw
from JAX's threefry keys, which no torch generator reproduces, and the
port draws from `torch.Generator` (ROADMAP.md, environment facts)."""

from mod_extraction_tpu_torch._lazy import lazy_exports

_EXPORTS = {"linear_interpolate_last_dim": "interp", "linear_resample": "interp"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
