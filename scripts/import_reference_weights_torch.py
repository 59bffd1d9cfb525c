"""Convert a reference torch `.pt` state_dict into the shipped `.npz`
weight format (the counterpart of `scripts/import_reference_weights.py`,
with its argv, layer-count inference and default kind; host only).  The
`.npz` is what `lfo_model_weights_path`, `custom.init_weights_path`,
`ckpt_path` and `scripts/export_torch_models.py` of either package read.

Usage:
  python scripts/import_reference_weights_torch.py <in.pt> <out.npz> [kind]

`kind`: `lstm` (LSTMEffectModel, default) or `2dcnn` (Spectral2DCNN; the
layer count is inferred from the `cnn.*` keys).  The `.pt` is read with
`weights_only=True` (`models/torch_port.py::load_pt`); a checkpoint of the
port converts with `scripts/extract_torch_weights.py` instead.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv) -> None:
    from mod_extraction_tpu_torch.models.torch_port import (
        CHECKPOINT,
        load_pt,
        port_lstm_effect_model,
        port_spectral_2dcnn,
        to_numpy,
    )
    from mod_extraction_tpu_torch.train.checkpoints import save_weights

    if len(argv) < 2:
        raise SystemExit(__doc__)
    in_path, out_path = argv[0], argv[1]
    kind = argv[2] if len(argv) > 2 else "lstm"

    found, sd = load_pt(in_path)
    if found == CHECKPOINT:
        raise SystemExit(f"{in_path} is a checkpoint of the port: convert it with scripts/extract_torch_weights.py")
    sd = to_numpy(sd)
    if kind == "lstm":
        params = port_lstm_effect_model(sd)
    elif kind == "2dcnn":
        n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("cnn.")) // 4
        params = port_spectral_2dcnn(sd, n_layers)
    else:
        raise SystemExit(f"unknown kind: {kind}")
    save_weights(out_path, params)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
