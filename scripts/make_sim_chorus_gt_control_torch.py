"""Render the ground-truth-conditioned chorus control corpora with the
PyTorch port (the counterpart of `scripts/make_sim_chorus_gt_control.py`).

The control trains the LSTM-64 of the sim_chorus regimes conditioned on the
true mod signal (the task's `lfo_model: null` path), which needs the LFO of
every example: so the corpus is preprocessed triplets (`pair_XXX.npz` with
`mod_sig` at sr/100 and `fx_params`, beside `pair_XXX_dry.wav` and
`pair_XXX_wet.wav`), exactly `n_samples` long, in the regime of the
matching `make_sim_effect_data_torch.py` effect: quasiperiodic triangle LFO
1.6-1.9 Hz, the 30 ms + 10 ms chorus delay block at feedback 0.3, and for
`chorus4` tremolo on the same LFO.  `run_eval_grid_torch.py --em-sim`
reads the `val` splits (`build_gt_control_blocks`).

Usage: python scripts/make_sim_chorus_gt_control_torch.py
          [--regime chorus|chorus2|chorus4] [--out DIR] [--n-train 256]
          [--n-val 96] [--n-samples 88200] [--src-train D] [--src-val D]
          [--device cuda|cpu]
K1 renders each batch of 32 on the card (`--device cpu`: its plain
version, a Python loop over every sample).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

SR = 44100
MOD_SIG_DIVISOR = 100  # dataset-side LFO frame rate (sr/100)


def _opt(argv, name, default, cast=str):
    if name in argv:
        return cast(argv[argv.index(name) + 1])
    return default


def render_split(
    rng: np.random.Generator,
    src_dir: str,
    out_dir: str,
    n_examples: int,
    n_samples: int,
    batch: int = 32,
    min_delay_width: float = 0.367,
    width: float = 0.8,
    delay_mix: float = 0.9,
    trem_mix: float = 0.0,
    device: str = "cuda",
) -> None:
    import torch

    from mod_extraction_tpu_torch.data.mods import make_quasi_periodic, np_make_mod_signal
    from mod_extraction_tpu_torch.data.wav import wav_read, wav_write
    from mod_extraction_tpu_torch.ops.fx import apply_flanger_chorus, apply_tremolo

    files = sorted(
        os.path.join(src_dir, f)
        for f in os.listdir(src_dir)
        if f.endswith(".wav")
    )
    assert files, f"no wavs under {src_dir} (run make_synthetic_corpus.py)"
    os.makedirs(out_dir, exist_ok=True)

    done = 0
    while done < n_examples:
        n = min(batch, n_examples - done)
        drys, mods, rates = [], [], []
        for i in range(n):
            a, file_sr = wav_read(files[(done + i) % len(files)])
            assert file_sr == SR
            start = int(rng.integers(0, a.shape[-1] - n_samples + 1))
            drys.append(a[0, start : start + n_samples])
            rate = float(rng.uniform(1.6, 1.9))
            m = np_make_mod_signal(
                n_samples, SR, rate, float(rng.uniform(0, 2 * np.pi)), "tri"
            )
            mods.append(make_quasi_periodic(rng, m))
            rates.append(rate)
        dry = np.stack(drys)[:, None, :]
        mod = np.stack(mods).astype(np.float32)
        mod_t = torch.from_numpy(mod).to(device)
        wet_t = apply_flanger_chorus(
            torch.from_numpy(dry).to(device), mod_t, SR,
            max_min_delay_ms=30.0, max_lfo_delay_ms=10.0,
            feedback=0.3, min_delay_width=min_delay_width, width=width,
            depth=1.0, mix=delay_mix,
        )
        if trem_mix > 0.0:
            # level-mod regime (chorus4): the same LFO drives the gain
            wet_t = apply_tremolo(wet_t, mod_t, mix=trem_mix)
        wet = wet_t.cpu().numpy()
        mod_frames = mod[:, ::MOD_SIG_DIVISOR]
        for i in range(n):
            stem = os.path.join(out_dir, f"pair_{done + i:03d}")
            wav_write(f"{stem}_dry.wav", dry[i], SR)
            wav_write(f"{stem}_wet.wav", wet[i], SR)
            np.savez(
                f"{stem}.npz",
                mod_sig=mod_frames[i],
                fx_params={
                    "rate_hz": rates[i],
                    "shape": "tri",
                    "max_min_delay_ms": 30.0,
                    "max_lfo_delay_ms": 10.0,
                    "feedback": 0.3,
                    "min_delay_width": min_delay_width,
                    "width": width,
                    "depth": 1.0,
                    "mix": delay_mix,
                    "trem_mix": trem_mix,
                },
            )
        done += n
        print(f"{out_dir}: {done}/{n_examples}")


# (min_delay_width, width, default out dir, corpus seed, delay_mix,
# trem_mix) per regime; delay sweep = 10*width*mod + 30*min_delay_width ms
REGIMES = {
    "chorus": (0.367, 0.8, "data/sim_chorus_gt", 1007, 0.9, 0.0),   # 11-19 ms
    "chorus2": (0.167, 0.5, "data/sim_chorus2_gt", 1013, 0.9, 0.0),  # 5-10 ms
    "chorus4": (0.367, 0.8, "data/sim_chorus4_gt", 1019, 0.35, 0.9),  # level mod dominant
}


def main(argv) -> None:
    from mod_extraction_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(_opt(argv, "--device", "cuda")))
    regime = _opt(argv, "--regime", "chorus")
    mdw, width, out_default, seed, delay_mix, trem_mix = REGIMES[regime]
    out_root = _opt(argv, "--out", out_default)
    n_train = _opt(argv, "--n-train", 256, int)
    n_val = _opt(argv, "--n-val", 96, int)
    n_samples = _opt(argv, "--n-samples", 88200, int)
    src_train = _opt(argv, "--src-train", "data/idmt_4/train")
    src_val = _opt(argv, "--src-val", "data/idmt_4/val")
    # seed disjoint from the EFFECT_SEEDS family; the regime (not the
    # draws) is what must match the sim corpus
    rng = np.random.default_rng(seed)
    for split, src, count in (("train", src_train, n_train), ("val", src_val, n_val)):
        render_split(rng, src, os.path.join(out_root, split), count, n_samples,
                     min_delay_width=mdw, width=width, delay_mix=delay_mix,
                     trem_mix=trem_mix, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
