"""Strip a checkpoint of the PyTorch port down to bare model weights (the
counterpart of `scripts/extract_model_weights.py`): the hand-off between
extractor training -> effect-model training -> streaming export.

Usage:
  python scripts/extract_torch_weights.py <ckpt> <out.npz> [attribute]

`ckpt` is a state file the port's Trainer writes (`<out>/<run>_ckpts/
best.pt` or `last.pt`), or that checkpoint directory (its `best.pt`).  The
`.npz` is in the shipped flax layout, so `lfo_model_weights_path`,
`custom.init_weights_path`, `ckpt_path` and `scripts/export_torch_models.py`
of either package read it.  `attribute` selects the model:
`model` (default: the trained model, the extractor of an LFO run or the
effect model of a TBPTT run), `effect_model` (the same) or `lfo_model` (the
frozen extractor a TBPTT run conditions on).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ATTRIBUTES = ("model", "effect_model", "lfo_model", "param_model")


def checkpoint_file(ckpt: str) -> str:
    """The state file of `ckpt`: the path itself, or `best.pt` in a
    checkpoint directory."""
    path = os.path.join(ckpt, "best.pt") if os.path.isdir(ckpt) else ckpt
    if not os.path.isfile(path):
        raise SystemExit(f"no checkpoint at {path}")
    return path


def extract(ckpt: str, attribute: str = "model") -> dict:
    """The flax param tree (nested dict of float32 numpy arrays) of
    `attribute` in checkpoint `ckpt`."""
    import torch

    from mod_extraction_tpu_torch.models.convert import (
        lstm_state_dict_to_flax,
        spectral_2dcnn_state_dict_to_flax,
    )

    if attribute not in ATTRIBUTES:
        raise SystemExit(f"unknown attribute: {attribute} (one of {', '.join(ATTRIBUTES)})")
    if attribute == "param_model":
        raise NotImplementedError(
            "param_model: the TBPTT variants (the param_model latent) are queued in "
            "ROADMAP.md, queue 1 item 3"
        )
    path = checkpoint_file(ckpt)
    task = torch.load(path, map_location="cpu", weights_only=False)["task"]
    if attribute == "lfo_model":
        if "lfo_model" not in task:
            raise SystemExit(f"{path} holds no frozen extractor (lfo_model): not a TBPTT run on one")
        sd = task["lfo_model"]
    else:
        sd = task["model"]
    if "w_hh" in sd:
        return lstm_state_dict_to_flax(sd)
    return spectral_2dcnn_state_dict_to_flax(sd)


def main(argv) -> None:
    from mod_extraction_tpu_torch.train.checkpoints import save_weights

    if len(argv) < 2:
        raise SystemExit(__doc__)
    ckpt, out_path = argv[0], argv[1]
    attribute = argv[2] if len(argv) > 2 else "model"
    save_weights(out_path, extract(ckpt, attribute))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
