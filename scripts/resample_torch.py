"""Resamples a directory of wavs with the PyTorch port (the counterpart of
`scripts/resample.py`, after the reference's `scripts/resample.py`).

Usage: python scripts/resample_torch.py <in_dir> <out_dir> <new_sr> [--device cuda|cpu]

Each `.wav` in `in_dir` is read, resampled on the device
(`mod_extraction_tpu_torch/ops/resample.py`; the card by default) and
written to `out_dir` under the same name as PCM16 at `new_sr`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mod_extraction_tpu_torch.data.wav import wav_read, wav_write  # noqa: E402
from mod_extraction_tpu_torch.ops.resample import resample  # noqa: E402


def parse_args(argv):
    p = argparse.ArgumentParser(description="Resample a directory of wavs.")
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("new_sr", type=int)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for name in sorted(os.listdir(args.in_dir)):
        if not name.endswith(".wav") or name.startswith("."):
            continue
        audio, sr = wav_read(os.path.join(args.in_dir, name))
        out = resample(audio, sr, args.new_sr, device=args.device).cpu().numpy()
        wav_write(os.path.join(args.out_dir, name), out, args.new_sr)
        print(f"{name}: {sr} -> {args.new_sr}")


if __name__ == "__main__":
    main()
