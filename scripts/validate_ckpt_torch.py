"""Validate a trained `models/<name>.yml` + checkpoint pair with the PyTorch
port (the counterpart of `scripts/validate_ckpt.py`).

Usage: `python scripts/validate_ckpt_torch.py <models/name.yml> [ckpt_path]
[--device cuda|cpu]`.  The YAML is a full experiment config; `ckpt_path`
(a bare-weights `.npz`, or a checkpoint of the port: `last`, `best` or a
`.pt` path) overrides the one recorded in the config.  Prints the eval
table.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv):
    p = argparse.ArgumentParser(description="Validate a model config + checkpoint with the PyTorch port.")
    p.add_argument("model", help="experiment config (models/<name>.yml)")
    p.add_argument("ckpt_path", nargs="?", default=None, help="overrides the config's ckpt_path")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv) -> dict:
    from mod_extraction_tpu_torch.cli import load_yaml_with_includes, validate

    args = parse_args(argv)
    cfg = load_yaml_with_includes(args.model)
    if args.ckpt_path is not None:
        cfg["ckpt_path"] = args.ckpt_path
    return validate(cfg, device=args.device)


if __name__ == "__main__":
    logging.basicConfig()
    logging.getLogger().setLevel(os.environ.get("LOGLEVEL", "INFO"))
    main(sys.argv[1:])
