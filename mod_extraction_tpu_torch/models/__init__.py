"""The port's models: the counterparts of the JAX `models` package's
`__all__`, imported from their modules at first use (`_lazy.py`)."""

from mod_extraction_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "Spectral2DCNN": "spectral_2dcnn",
    "TCN": "tcn",
    "TCNBlock": "tcn",
    "FiLM": "tcn",
    "SpectralTCN": "tcn",
    "SpectralDSTCN": "tcn",
    "LSTMEffectModel": "lstm",
    "lstm_init_state": "lstm",
    "RandomLFO": "random_lfo",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
