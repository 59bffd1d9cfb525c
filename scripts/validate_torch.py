"""Evaluation entry point of the PyTorch port (the counterpart of
`scripts/validate.py`): runs an eval config's validation set through the
weights its `ckpt_path` names and prints the metrics.

Usage: `python scripts/validate_torch.py [config] [--device cuda|cpu]`.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

config_name = "eval_lfo.yml"
# config_name = "eval_lfo_quasi.yml"
# config_name = "eval_lfo_distorted.yml"
# config_name = "eval_lfo_combined.yml"
# config_name = "eval_lfo_rand.yml"
# config_name = "eval_lfo_unseen_audio.yml"
# config_name = "eval_em_unseen_effect.yml"


def parse_args(argv):
    p = argparse.ArgumentParser(description="Validate an eval config with the PyTorch port.")
    p.add_argument("config", nargs="?", default=config_name, help=f"config (default {config_name})")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig()
    logging.getLogger().setLevel(os.environ.get("LOGLEVEL", "INFO"))
    from mod_extraction_tpu_torch.cli import validate

    args = parse_args(sys.argv[1:])
    validate(args.config, device=args.device)
