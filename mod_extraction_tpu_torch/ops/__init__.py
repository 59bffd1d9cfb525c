"""The port's LFO and corner ops: the counterparts of the JAX `ops`
package's `__all__`, imported from their modules at first use
(`_lazy.py`).  The kernels' wrappers live in `fx_kernels`, `lstm_kernels`
and `conv_kernels`."""

from mod_extraction_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("LFO_SHAPES", "shape_to_idx", "make_mod_signal", "make_mod_signal_batch",
                     "make_rand_mod_signal"), "lfo"),
    **dict.fromkeys(("find_corners", "corners_to_mod_sig", "stretch_corners", "check_mod_sig_mask",
                     "find_valid_mod_sig_mask", "smoothen"), "corners"),
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
