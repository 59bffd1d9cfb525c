"""Training entry point of the PyTorch port (the counterpart of
`scripts/train.py`).

Usage: `python scripts/train_torch.py [config] [--device cuda|cpu]`: trains
the experiment config (default below) through `mod_extraction_tpu_torch.
cli.fit` on the card, or on the CPU with the config's `custom.cpu_*` batch
and epoch sizes when `--device cpu` is given.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Pick an experiment (un)comment-style, as in scripts/train.py:
config_name = "train_lfo_phaser.yml"
# config_name = "train_lfo_flanger.yml"
# config_name = "train_lfo_interwoven_all.yml"
# config_name = "train_em_dry_wet.yml"
# config_name = "train_baseline_em_dry_wet.yml"


def parse_args(argv):
    p = argparse.ArgumentParser(description="Train an experiment config with the PyTorch port.")
    p.add_argument("config", nargs="?", default=config_name, help=f"config (default {config_name})")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig()
    logging.getLogger().setLevel(os.environ.get("LOGLEVEL", "INFO"))
    from mod_extraction_tpu_torch.cli import fit

    args = parse_args(sys.argv[1:])
    fit(args.config, device=args.device)
