"""Reference-checkpoint porting (the port's copy of
`mod_extraction_tpu/models/torch_port.py`): the reference's torch
`state_dict`s -> the flax parameter layout -> the port's own modules.

The reference ships trained weights as bare torch `state_dict`s
(`scripts/extract_model_weights.py:30-47` of the reference).  The seven
layout functions are numpy copies of the JAX module's, with its keys and
outputs: torch OIHW conv kernels -> flax HWIO, linear (O, I) -> (I, O), the
LSTM's fused-gate weights transposed with its two biases summed.  Keys they
do not name (a Spectral2DCNN's Mel frontend buffers) are ignored.

`reference_state_dict` carries a reference `state_dict` on to the
`state_dict` of the port's `LSTMEffectModel`, `Spectral2DCNN`, `TCN` or
`SpectralTCN` through them and `models/convert.py`.  `load_pt` reads a
`.pt` file and tells a reference `state_dict` from a checkpoint of the port
by its content.  It loads with `torch.load(..., weights_only=True)`, where
the JAX package passes `weights_only=False`: a bare `state_dict` loads the
same either way, and no pickled code runs.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from mod_extraction_tpu_torch.models.convert import (
    flax_lstm_to_state_dict,
    flax_to_state_dict,
    tcn_flax_to_state_dict,
)
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.models.tcn import TCN, SpectralTCN

REFERENCE, CHECKPOINT = "reference", "checkpoint"


def conv2d_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, kH, kW) -> (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def conv1d_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, k) -> (k, I, O)."""
    return np.transpose(w, (2, 1, 0))


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I) -> (I, O)."""
    return np.transpose(w, (1, 0))


def port_lstm_effect_model(sd: Dict[str, np.ndarray]) -> dict:
    """Reference `LSTMEffectModel` state_dict -> flax params.

    torch keys: lstm.weight_ih_l0 (4H, in), lstm.weight_hh_l0 (4H, H),
    lstm.bias_ih_l0 + lstm.bias_hh_l0, fc.weight (out, H), fc.bias."""
    return {
        "w_ih": linear_kernel(sd["lstm.weight_ih_l0"]),
        "w_hh": linear_kernel(sd["lstm.weight_hh_l0"]),
        "b_gates": sd["lstm.bias_ih_l0"] + sd["lstm.bias_hh_l0"],
        "fc": {
            "kernel": linear_kernel(sd["fc.weight"]),
            "bias": sd["fc.bias"],
        },
    }


def port_spectral_2dcnn(sd: Dict[str, np.ndarray], n_layers: int) -> dict:
    """Reference `Spectral2DCNN` state_dict -> flax params.

    The reference packs the layers into an `nn.Sequential` named `cnn`, each
    block [LN, Conv2d, MaxPool, PReLU] (LN has no parameters): the conv at
    cnn.{4k+1}, the PReLU at cnn.{4k+3}; the head is `output` (Conv1d 1x1).
    """
    params: dict = {}
    for k in range(n_layers):
        params[f"Conv_{k}"] = {
            "kernel": conv2d_kernel(sd[f"cnn.{4 * k + 1}.weight"]),
            "bias": sd[f"cnn.{4 * k + 1}.bias"],
        }
        params[f"PReLU_{k}"] = {"alpha": sd[f"cnn.{4 * k + 3}.weight"]}
    out_w = sd["output.weight"]  # (latent_dim, C, 1)
    params["Dense_0"] = {
        "kernel": linear_kernel(out_w[:, :, 0]),
        "bias": sd["output.bias"],
    }
    return params


def port_tcn(sd: Dict[str, np.ndarray], n_blocks: int, prefix: str = "") -> dict:
    """Reference `TCN` state_dict -> flax params.

    torch keys of block i: blocks.{i}.conv.weight/bias, blocks.{i}.act.weight
    (PReLU), blocks.{i}.res.weight (1x1, no bias); LayerNorm has none."""
    params: dict = {}
    for i in range(n_blocks):
        p = f"{prefix}blocks.{i}."
        block: dict = {
            "conv": {
                "kernel": conv1d_kernel(sd[p + "conv.weight"]),
                "bias": sd[p + "conv.bias"],
            }
        }
        if p + "act.weight" in sd:
            block["act"] = {"alpha": sd[p + "act.weight"]}
        if p + "res.weight" in sd:
            block["res"] = {"kernel": conv1d_kernel(sd[p + "res.weight"])}
        params[f"block_{i}"] = block
    return params


def port_spectral_tcn(sd: Dict[str, np.ndarray], n_blocks: int) -> dict:
    """Reference `SpectralTCN` -> flax params: a TCN under `tcn.` and the
    1x1 `output` Conv1d head."""
    return {
        "tcn": port_tcn(sd, n_blocks, prefix="tcn."),
        "output": {
            "kernel": linear_kernel(sd["output.weight"][:, :, 0]),
            "bias": sd["output.bias"],
        },
    }


def to_numpy(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A state_dict of tensors (or arrays) as numpy arrays, the form the
    layout functions take."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()}


def reference_state_dict(sd: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference `state_dict` -> the `state_dict` of `model`, the port's
    module of the same architecture (the layer count is the model's)."""
    flat = to_numpy(sd)
    if isinstance(model, LSTMEffectModel):
        return flax_lstm_to_state_dict(port_lstm_effect_model(flat))
    if isinstance(model, Spectral2DCNN):
        return flax_to_state_dict(port_spectral_2dcnn(flat, len(model.convs)))
    if isinstance(model, SpectralTCN):
        return tcn_flax_to_state_dict(port_spectral_tcn(flat, len(model.tcn.blocks)))
    if isinstance(model, TCN):
        return tcn_flax_to_state_dict(port_tcn(flat, len(model.blocks)))
    raise ValueError(f"no reference layout is ported for {type(model).__name__}")


def load_pt(path: str) -> Tuple[str, Dict[str, Any]]:
    """Read a `.pt` file (`weights_only=True`) and tell its kind by its
    content: (CHECKPOINT, state) for a checkpoint of the port, a mapping
    with "task" and "step" (`train/checkpoints.py`), or (REFERENCE,
    state_dict) for a flat mapping of names to tensors.  Anything else
    raises `ValueError`."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: torch.load(weights_only=True) refused it; a .pt holds tensors and plain "
            f"containers only ({str(e).splitlines()[0]})"
        ) from e
    if isinstance(obj, Mapping) and "task" in obj and "step" in obj:
        return CHECKPOINT, dict(obj)
    if isinstance(obj, Mapping) and obj and all(isinstance(k, str) and torch.is_tensor(v) for k, v in obj.items()):
        return REFERENCE, dict(obj)
    raise ValueError(
        f"{path}: neither a reference state_dict (a flat mapping of parameter names to tensors) "
        "nor a checkpoint of the port (a mapping with 'task' and 'step')"
    )
