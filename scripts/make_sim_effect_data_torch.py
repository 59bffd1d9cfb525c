"""Render the self-contained "unseen effect" dry/wet corpora with the PyTorch
port (the counterpart of `scripts/make_sim_effect_data.py`): the same
effects, seeds, draws and files, rendered by K1 (flanger/chorus delay line)
and K2 (phaser cascade) on the card.

Each corpus is one fixed-character effect in a narrow LFO regime, which the
stage-2 TBPTT task then models black-box from its dry/wet pairs:

  sim_chorus    quasiperiodic triangle LFO 1.6-1.9 Hz, 11-19 ms chorus
                sweep, feedback 0.3, mix 0.9
  sim_chorus2   the same LFO band, 5-10 ms sweep
  sim_chorus3   sim_chorus plus LFO-driven level modulation (tremolo 0.35)
  sim_chorus4   the sim_chorus delay at mix 0.35 under tremolo 0.9
  sim_flanger   quasiperiodic triangle 1.0-1.5 Hz, 1-3 ms sweep, feedback
                0.25, mix 0.9
  sim_flanger2  the same sweep, feedback 0.45, fully wet
  sim_phaser    cos 0.56-0.94 Hz six-stage phaser, depth 0.9, centre
                900 Hz, feedback 0.5, mix 0.9

Usage:
  python scripts/make_sim_effect_data_torch.py [effect ...] [--src-train D]
      [--src-val D] [--out-root D] [--device cuda|cpu]
Defaults: every effect, data/idmt_4/{train,val} -> data/<effect>/, on the
card.  `--device cpu` renders with the kernels' plain versions (slow: a
Python loop over every sample).  Each effect writes 48 train and 8 val
pairs of 2.5 s as PCM16 `pair_XX.wav` under `<effect>/<split>/{dry,wet}`.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

SR = 44100
SEG = int(2.5 * SR)


def _load_dry(rng, src_dir: str, n_pairs: int) -> np.ndarray:
    """(n_pairs, 1, SEG) float32: one random SEG-long window of each source
    file in name order, cycling over the files."""
    from mod_extraction_tpu_torch.data.wav import wav_read

    files = sorted(
        os.path.join(src_dir, f) for f in os.listdir(src_dir) if f.endswith(".wav")
    )
    drys = []
    for i in range(n_pairs):
        a, file_sr = wav_read(files[i % len(files)])
        assert file_sr == SR, f"expected {SR} Hz, got {file_sr}"
        start = int(rng.integers(0, a.shape[-1] - SEG + 1))
        drys.append(a[0, start : start + SEG])
    return np.stack(drys)[:, None, :]


def _quasi_tri(rng, n_pairs: int, lo: float, hi: float) -> np.ndarray:
    """(n_pairs, SEG) float32: a triangle LFO of rate U[lo, hi] Hz and phase
    U[0, 2 pi) per pair, made quasiperiodic (the phase drift a band-matched
    random baseline cannot track)."""
    from mod_extraction_tpu_torch.data.mods import make_quasi_periodic, np_make_mod_signal

    mods = []
    for _ in range(n_pairs):
        m = np_make_mod_signal(
            SEG, SR, float(rng.uniform(lo, hi)), float(rng.uniform(0, 2 * np.pi)), "tri",
        )
        mods.append(make_quasi_periodic(rng, m))
    return np.stack(mods).astype(np.float32)


# the chorus-family delay blocks: 30 ms + 10 ms lines, feedback 0.3
CHORUS_DELAY = dict(max_min_delay_ms=30.0, max_lfo_delay_ms=10.0, feedback=0.3, depth=1.0)
# (min_delay_width, width, delay mix, tremolo mix) of each chorus regime
CHORUS_REGIMES = {
    "sim_chorus": (0.367, 0.8, 0.9, 0.0),  # 11-19 ms sweep
    "sim_chorus2": (0.167, 0.5, 0.9, 0.0),  # 5-10 ms
    "sim_chorus3": (0.367, 0.8, 0.9, 0.35),  # + level modulation
    "sim_chorus4": (0.367, 0.8, 0.35, 0.9),  # level modulation dominant
}


def _render(effect: str, rng, dry: np.ndarray, device: str = "cuda") -> np.ndarray:
    """The wet side of `dry` (n, 1, SEG) for `effect`, drawing its LFOs
    from `rng` as the JAX generator draws them."""
    import torch

    from mod_extraction_tpu_torch.ops.fx import apply_flanger_chorus, apply_phaser, apply_tremolo

    n_pairs = dry.shape[0]
    x = torch.from_numpy(dry).to(device)
    if effect in CHORUS_REGIMES:
        mdw, width, mix, trem = CHORUS_REGIMES[effect]
        mod = torch.from_numpy(_quasi_tri(rng, n_pairs, 1.6, 1.9)).to(device)
        wet = apply_flanger_chorus(
            x, mod, SR, min_delay_width=mdw, width=width, mix=mix, **CHORUS_DELAY
        )
        if trem > 0.0:
            wet = apply_tremolo(wet, mod, mix=trem)
    elif effect in ("sim_flanger", "sim_flanger2"):
        mod = torch.from_numpy(_quasi_tri(rng, n_pairs, 1.0, 1.5)).to(device)
        fb, mix = (0.45, 1.0) if effect == "sim_flanger2" else (0.25, 0.9)
        wet = apply_flanger_chorus(
            x, mod, SR, max_min_delay_ms=1.0, max_lfo_delay_ms=4.0,
            feedback=fb, min_delay_width=1.0, width=0.5, depth=1.0, mix=mix,
        )
    elif effect == "sim_phaser":
        rate = torch.from_numpy(rng.uniform(0.5625, 0.9375, n_pairs).astype(np.float32)).to(device)
        phase = torch.from_numpy(rng.uniform(0, 2 * np.pi, n_pairs).astype(np.float32)).to(device)
        wet, _ = apply_phaser(
            x, SR, rate_hz=rate, depth=0.9, centre_frequency_hz=900.0,
            feedback=0.5, mix=0.9, phase=phase,
        )
    else:
        raise SystemExit(f"unknown effect: {effect}")
    return wet.cpu().numpy()


ALL_EFFECTS = (
    "sim_chorus", "sim_chorus2", "sim_chorus3", "sim_chorus4",
    "sim_flanger", "sim_flanger2", "sim_phaser"
)

# Fixed per-effect corpus seeds, the JAX generator's: the corpus of an
# effect does not depend on which other effects one run renders.
EFFECT_SEEDS = {
    "sim_chorus": 7,
    "sim_chorus2": 11,
    "sim_chorus3": 13,
    "sim_chorus4": 17,
    "sim_flanger": 8,
    "sim_flanger2": 7,
    "sim_phaser": 9,
}


def pop_device(argv):
    """(device, argv without `--device <value>`); default cuda."""
    argv = list(argv)
    if "--device" not in argv:
        return "cuda", argv
    i = argv.index("--device")
    if i + 1 >= len(argv):
        raise SystemExit("--device needs a value")
    device = argv[i + 1]
    del argv[i : i + 2]
    return device, argv


def parse_args(argv):
    """(src_train, src_val, out_root, effects) from flags, positionals
    (`<src_train> <src_val> [out_root]`), or defaults; flags win when both
    forms are given."""

    def opt(name, default):
        if name in argv:
            i = argv.index(name)
            if i + 1 >= len(argv):
                raise SystemExit(f"{name} needs a value")
            return argv[i + 1]
        return default

    flag_vals = {argv[argv.index(f) + 1] for f in
                 ("--src-train", "--src-val", "--out-root")
                 if f in argv and argv.index(f) + 1 < len(argv)}
    positional = [a for a in argv
                  if not a.startswith("--") and a not in ALL_EFFECTS
                  and a not in flag_vals]
    src_train = opt("--src-train", positional[0] if len(positional) > 0
                    else "data/idmt_4/train")
    src_val = opt("--src-val", positional[1] if len(positional) > 1
                  else "data/idmt_4/val")
    out_root = opt("--out-root", positional[2] if len(positional) > 2
                   else "data")
    effects = [a for a in argv if a in ALL_EFFECTS] or list(ALL_EFFECTS)
    return src_train, src_val, out_root, effects


def main(argv) -> None:
    from mod_extraction_tpu_torch.data.wav import wav_write
    from mod_extraction_tpu_torch.utils.device import resolve_device

    device, argv = pop_device(argv)
    device = str(resolve_device(device))
    src_train, src_val, out_root, effects = parse_args(argv)

    for effect in effects:
        rng = np.random.default_rng(EFFECT_SEEDS[effect])
        for split, src_dir, n_pairs in (
            ("train", src_train, 48), ("val", src_val, 8),
        ):
            dry = _load_dry(rng, src_dir, n_pairs)
            wet = _render(effect, rng, dry, device)
            dry_dir = os.path.join(out_root, effect, split, "dry")
            wet_dir = os.path.join(out_root, effect, split, "wet")
            os.makedirs(dry_dir, exist_ok=True)
            os.makedirs(wet_dir, exist_ok=True)
            for i in range(n_pairs):
                wav_write(os.path.join(dry_dir, f"pair_{i:02d}.wav"), dry[i], SR)
                wav_write(os.path.join(wet_dir, f"pair_{i:02d}.wav"), wet[i], SR)
            print(f"{effect}/{split}: {n_pairs} dry/wet pairs -> {out_root}/{effect}/{split}")


if __name__ == "__main__":
    main(sys.argv[1:])
