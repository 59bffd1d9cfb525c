"""The port's losses: the counterparts of the JAX `losses` package's
`__all__`, imported from `losses.py` at first use (`_lazy.py`)."""

from mod_extraction_tpu_torch._lazy import lazy_exports

_EXPORTS = dict.fromkeys((
    "l1_loss",
    "mse_loss",
    "esr_loss",
    "dc_loss",
    "first_derivative_l1_loss",
    "second_derivative_l1_loss",
    "log_mel_l1_loss",
    "mr_stft_loss",
    "get_loss_func_by_name",
    "WeightedLossDict",
), "losses")
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
