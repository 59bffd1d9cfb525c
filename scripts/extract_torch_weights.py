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
effect model of a TBPTT run), `effect_model` (the same), `lfo_model` (the
extractor a TBPTT run conditions on, frozen or trained with it) or
`param_model` (the SpectralDSTCN clip latent of a TBPTT run with one).
Spectral2DCNN, SpectralTCN / SpectralDSTCN and LSTM weights are told apart
by their keys.
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
        tcn_state_dict_to_flax,
    )

    if attribute not in ATTRIBUTES:
        raise SystemExit(f"unknown attribute: {attribute} (one of {', '.join(ATTRIBUTES)})")
    path = checkpoint_file(ckpt)
    task = torch.load(path, map_location="cpu", weights_only=False)["task"]
    model = task["model"]
    # a TBPTT task that trains several parts keeps them as {effect, param?, lfo?}
    parts = {}
    if any(k.startswith("effect.") for k in model):
        for key, v in model.items():
            part, _, rest = key.partition(".")
            parts.setdefault(part, {})[rest] = v
    if attribute == "lfo_model":
        if "lfo_model" in task:
            sd = task["lfo_model"]
        elif "lfo" in parts:
            sd = parts["lfo"]
        else:
            raise SystemExit(f"{path} holds no frozen extractor (lfo_model) and trains none: not a TBPTT run on one")
    elif attribute == "param_model":
        if "param" not in parts:
            raise SystemExit(f"{path} holds no param_model: not a TBPTT run with one")
        sd = parts["param"]
    else:
        sd = parts.get("effect", model)
    if "w_hh" in sd:
        return lstm_state_dict_to_flax(sd)
    if any(k.startswith("tcn.") for k in sd):
        return tcn_state_dict_to_flax(sd)["params"]
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
