"""Export trained LSTM effect models for real-time streaming with the
PyTorch port (the counterpart of `scripts/export_neutone_models.py`).

Writes, per model, `OUT_DIR/exports_torch/<name>/` with `weights.npz`,
`metadata.json` and the `torch.export` processor `processor.pt2`, then runs
the streaming self-check on the card: the processor driven over random
buffers of 64-1024 samples must match one call over the whole 4096 samples
(state carried across any buffer size), within 1e-5.

Usage: python3 scripts/export_torch_models.py [weights.npz ...]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

MODEL_NAMES = [
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_fl_2_peak",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ch_2_peak",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_ph_irregular",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_fl_quasi",
]


def streaming_self_check(sm, seed: int = 0, total: int = 4096) -> float:
    """Chunked over random buffers against one full call; returns the
    max-abs difference (raises above 1e-5)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (sm.n_channels, total)).astype(np.float32)
    y_full, _ = sm.process_np(sm.init_state(), x)
    state = sm.init_state()
    outs, i = [], 0
    while i < total:
        n = min(int(rng.integers(64, 1024)), total - i)
        y, state = sm.process_np(state, x[:, i : i + n])
        outs.append(y)
        i += n
    y_chunked = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(y_chunked, y_full, atol=1e-5)
    return float(np.abs(y_chunked - y_full).max())


def main(argv):
    from mod_extraction_tpu_torch.export.streaming import export_streaming_model, load_streaming_model
    from mod_extraction_tpu_torch.paths import MODELS_DIR, OUT_DIR

    targets = argv or [os.path.join(MODELS_DIR, f"{n}.npz") for n in MODEL_NAMES]
    for path in targets:
        if not os.path.isfile(path):
            print(f"skip (missing): {path}")
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        out = export_streaming_model(path, os.path.join(OUT_DIR, "exports_torch"), name)
        err = streaming_self_check(load_streaming_model(out, device="cuda"))
        print(f"exported + stream-verified on the card (max-abs {err:.3e}): {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
