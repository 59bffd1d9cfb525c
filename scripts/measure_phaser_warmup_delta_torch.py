"""Measure the extractor-level effect of the phaser warm-up transient with
the PyTorch port (the counterpart of `scripts/measure_phaser_warmup_delta.py`;
PARITY.md "Known deviations").

Renders one eval-regime phaser batch twice with the same LFO phases: cold
(the effect starts on the crop) and warmed (88200 samples of noise pad in
front, the phase rolled back by the pad, the pad cut off again), both
through `ops/fx.py::apply_phaser` (K2 on the card).  Then runs the shipped
r5 extractor (`configs/models/spectral_2dcnn.yml`) on (dry, wet) for each
and reports val/l1 against the same ground-truth mod signal.  The crops,
rates, phases and pad noise come from `numpy.random.default_rng(123)` in
the JAX script's order, so both scripts measure the same batch.

Usage:
  python scripts/measure_phaser_warmup_delta_torch.py [--src data/idmt_4/val] [--batch 64]
      [--device cuda|cpu] [--compute-dtype float32|bfloat16]
Prints one line: cold l1, warm l1, |delta|.  `--compute-dtype` overrides
the model config's conv dtype (bf16 as shipped; float32 for parity runs).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

SR = 44100.0
N = 88200
BATCH = 64
SRC = "data/idmt_4/val"
EXTRACTOR = (
    "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r5.npz"
)


def main(src: str = SRC, batch: int = BATCH, device: str = "cuda", compute_dtype=None) -> tuple:
    """Prints the measurement line; returns (cold l1, warm l1)."""
    import torch

    from mod_extraction_tpu_torch.cli import _repo_path, build_model, load_yaml_with_includes
    from mod_extraction_tpu_torch.data.wav import wav_read
    from mod_extraction_tpu_torch.models.convert import flax_to_state_dict
    from mod_extraction_tpu_torch.ops.fx import apply_phaser
    from mod_extraction_tpu_torch.train.checkpoints import load_weights
    from mod_extraction_tpu_torch.utils.device import resolve_device, set_float32_numerics
    from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim

    dev = resolve_device(device)
    if dev.type == "cuda":
        set_float32_numerics()
    rng = np.random.default_rng(123)
    files = sorted(
        os.path.join(src, f) for f in os.listdir(src) if f.endswith(".wav")
    )
    drys = []
    for i in range(batch):
        a, sr = wav_read(files[i % len(files)])
        assert sr == SR
        start = int(rng.integers(0, a.shape[-1] - N + 1))
        drys.append(a[0, start : start + N])
    dry = torch.from_numpy(np.stack(drys)[:, None, :]).to(dev)

    # eval_lfo.yml regime: rate log-uniform 0.5-3, depth 1, centre 440,
    # feedback 0.25, mix 1.0; uniform phase
    rate = torch.from_numpy(
        np.exp(rng.uniform(np.log(0.5), np.log(3.0), batch)).astype(np.float32)
    ).to(dev)
    phase = torch.from_numpy(rng.uniform(0, 2 * np.pi, batch).astype(np.float32)).to(dev)
    kw = dict(sr=SR, rate_hz=rate, depth=1.0, centre_frequency_hz=440.0,
              feedback=0.25, mix=1.0)

    wet_cold, mod = apply_phaser(dry, phase=phase, **kw)

    # warmed render: one max-period pad (4-aligned), phase rolled back
    warm = int(SR / 0.5)
    warm -= warm % 4
    pad = torch.from_numpy(
        (0.3 * rng.standard_normal((batch, 1, warm))).astype(np.float32)
    ).to(dev)
    dry_long = torch.cat([pad, dry], dim=2)
    phase_long = phase - 2.0 * np.pi * rate * warm / SR
    wet_long, _ = apply_phaser(dry_long, phase=phase_long, **kw)
    wet_warm = wet_long[:, :, warm:]

    model_cfg = load_yaml_with_includes("configs/models/spectral_2dcnn.yml")
    if compute_dtype is not None:
        model_cfg["init_args"]["compute_dtype"] = compute_dtype
    model = build_model(model_cfg, {"n_samples": N, "sr": SR})
    params = load_weights(_repo_path(EXTRACTOR))
    if "params" not in params:
        params = {"params": params}
    model.load_state_dict(flax_to_state_dict(params))
    model = model.to(dev).eval()

    @torch.no_grad()
    def l1(wet):
        x = torch.cat([dry, wet], dim=1)
        mod_hat, _ = model(x)
        gt = linear_interpolate_last_dim(mod[:, ::100], mod_hat.shape[-1])
        return torch.mean(torch.abs(mod_hat[:, 0, :] - gt))

    l1_cold = float(l1(wet_cold))
    l1_warm = float(l1(wet_warm))
    print(
        f"phaser warmup extractor delta: cold l1={l1_cold:.5f} "
        f"warm l1={l1_warm:.5f} |delta|={abs(l1_cold - l1_warm):.6f}"
    )
    return l1_cold, l1_warm


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="The phaser warm-up transient's effect on the extractor's l1.")
    p.add_argument("--src", default=SRC, help=f"directory of 44.1 kHz dry wavs (default {SRC})")
    p.add_argument("--batch", type=int, default=BATCH, help=f"clips (default {BATCH})")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--compute-dtype", default=None, help="the extractor's conv dtype (default: the config's)")
    args = p.parse_args()
    main(args.src, args.batch, args.device, args.compute_dtype)
