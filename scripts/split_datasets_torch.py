"""Dataset preparation with the PyTorch port (the counterpart of
`scripts/split_datasets.py`):

* `split_idmt_4`: song-level 75/25 train/val split of IDMT-SMT-Guitar
  dataset 4, trimming the first `offset_n_bars` bars at the BPM parsed from
  each file name (`..._<bpm>bpm.wav`).  Host only.
* `split_egfx`: 70/18/12 train/val/test split of the EGFx dataset, every
  file resampled to 44.1 kHz (`ops/resample.py`, on the card unless
  `--device cpu`); files already at 44.1 kHz are copied byte for byte.  The
  same file-name split goes to every effect directory, so dry/wet pairs
  stay aligned.

Both draw from the standard library's `random` seeded with 42, in the JAX
script's order, so both scripts split a tree the same way.  As in the JAX
script, a file goes to val when any val song name is a SUBSTRING of its
name: with songs `x_1` and `x_10`, drawing `x_1` also sends `x_10`'s files
to val (ROADMAP.md section 3).

Usage:
  python scripts/split_datasets_torch.py idmt <root_dir>
  python scripts/split_datasets_torch.py egfx <root_dir> [--device cuda|cpu]
"""

import argparse
import os
import random
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

IDMT_SOURCES = ["acoustic_mic", "acoustic_pickup", "Career SG", "Ibanez 2820"]


def _wavs_under(root: str):
    out = []
    for r, _, files in os.walk(root):
        for f in files:
            if f.endswith(".wav") and not f.startswith("."):
                out.append(os.path.join(r, f))
    return sorted(out)


def split_idmt_4(root_dir: str, val_split: float = 0.25, offset_n_bars: int = 3,
                 seed: int = 42) -> None:
    from mod_extraction_tpu_torch.data.wav import wav_read, wav_write

    random.seed(seed)
    train_dir = os.path.join(root_dir, "train")
    val_dir = os.path.join(root_dir, "val")
    os.makedirs(train_dir)
    os.makedirs(val_dir)

    song_names: set = set()
    val_names: list = []
    for source in IDMT_SOURCES:
        paths = _wavs_under(os.path.join(root_dir, source))
        # the songs come from the first source that has all 128 files
        if not song_names and len(paths) == 128:
            for p in paths:
                tokens = os.path.basename(p).split("_")
                song_names.add("_".join(tokens[:2]))
        assert len(song_names) == 64, f"unexpected song count: {len(song_names)}"
        if not val_names:
            val_names = random.sample(sorted(song_names), int(val_split * len(song_names)))
        for src in paths:
            name = os.path.basename(src)
            bpm = int(name.split("_")[-1][:-7])  # "<bpm>bpm.wav"
            assert 50 <= bpm <= 200, f"bad bpm: {bpm} in {name}"
            audio, sr = wav_read(src)
            # trim offset_n_bars of 4/4 at the parsed tempo
            offset = int(4.0 * 60.0 / bpm * offset_n_bars * sr)
            audio = audio[:, offset:]
            dest = val_dir if any(v in name for v in val_names) else train_dir
            wav_write(os.path.join(dest, f"{source}__{name}"), audio, sr)
            print(f"{src} -> {dest}")


def split_egfx(root_dir: str, val_split: float = 0.18, test_split: float = 0.12,
               new_sr: int = 44100, seed: int = 42, device: str = "cuda") -> None:
    from mod_extraction_tpu_torch.data.wav import wav_info, wav_read, wav_write
    from mod_extraction_tpu_torch.ops.resample import resample
    from mod_extraction_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)  # before anything is written
    random.seed(seed)
    splits = {s: os.path.join(root_dir, s) for s in ("train", "val", "test")}
    for d in splits.values():
        os.makedirs(d)

    split_names = None
    for dir_name in sorted(os.listdir(root_dir)):
        src_dir = os.path.join(root_dir, dir_name)
        if not os.path.isdir(src_dir) or dir_name in splits:
            continue
        if split_names is None:
            names = sorted(
                n for n in os.listdir(src_dir)
                if n.endswith(".wav") and not n.startswith(".")
            )
            val = random.sample(names, int(val_split * len(names)))
            rest = [n for n in names if n not in val]
            test = random.sample(rest, int(test_split * len(names)))
            train = [n for n in rest if n not in test]
            split_names = {"train": train, "val": val, "test": test}
        for split, names in split_names.items():
            dest_dir = os.path.join(splits[split], dir_name)
            os.makedirs(dest_dir, exist_ok=True)
            for n in names:
                src = os.path.join(src_dir, n)
                dest = os.path.join(dest_dir, n)
                sr = wav_info(src).sample_rate
                if sr != new_sr:
                    audio, sr = wav_read(src)
                    wav_write(dest, resample(audio, sr, new_sr, device=device).cpu().numpy(), new_sr)
                else:
                    shutil.copyfile(src, dest)
        print(f"split {dir_name}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Split IDMT-SMT-Guitar 4 or EGFx into train/val(/test).")
    p.add_argument("kind", help="idmt or egfx")
    p.add_argument("root", help="the dataset's root directory; the splits are written under it")
    p.add_argument("--device", default="cuda", help="where EGFx is resampled: cuda (default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.kind == "idmt":
        split_idmt_4(args.root)
    elif args.kind == "egfx":
        split_egfx(args.root, device=args.device)
    else:
        raise SystemExit(f"unknown dataset kind: {args.kind}")


if __name__ == "__main__":
    main()
