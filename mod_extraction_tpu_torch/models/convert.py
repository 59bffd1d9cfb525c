"""Flax-layout weights <-> the port's `Spectral2DCNN` and `LSTMEffectModel`
state_dicts.

Reads the shipped `.npz` files or a nested dict of numpy arrays from a live
flax tree (`params` level optional).  Spectral2DCNN keys: `Conv_{i}/kernel`
(kh, kw, I, O), `Conv_{i}/bias`, `PReLU_{i}/alpha`, `Dense_0/kernel` (I, O),
`Dense_0/bias`; HWIO kernels become OIHW, Dense (I, O) becomes Linear
(O, I) (the inverse direction of `mod_extraction_tpu/models/torch_port.py`).
LSTM keys: `w_ih` (in_dim, 4H), `w_hh` (H, 4H), `b_gates` (4H,),
`fc/kernel` (H, out), `fc/bias` (out,), kept in that layout;
`lstm_state_dict_to_flax` maps back.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.utils.device import resolve_device


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.array(v, np.float32)
    return flat


def _flat_weights(weights: str | Mapping[str, Any]) -> Dict[str, np.ndarray]:
    if isinstance(weights, str):
        with np.load(weights) as f:
            flat = {k: np.array(f[k], np.float32) for k in f.files}
    else:
        flat = _flatten(weights)
    return {k.removeprefix("params/"): v for k, v in flat.items()}


def flax_to_state_dict(weights: str | Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`.npz` path or flax param tree -> `Spectral2DCNN.state_dict()`."""
    flat = _flat_weights(weights)
    n_layers = sum(1 for k in flat if k.startswith("Conv_") and k.endswith("/kernel"))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(flat[f"Conv_{i}/kernel"], (3, 2, 0, 1)))
        )
        sd[f"convs.{i}.bias"] = torch.from_numpy(flat[f"Conv_{i}/bias"])
        sd[f"prelus.{i}.alpha"] = torch.from_numpy(flat[f"PReLU_{i}/alpha"])
    sd["out.weight"] = torch.from_numpy(np.ascontiguousarray(flat["Dense_0/kernel"].T))
    sd["out.bias"] = torch.from_numpy(flat["Dense_0/bias"])
    return sd


def load_spectral_2dcnn(
    weights: str | Mapping[str, Any], device: str | torch.device = "cuda", **model_kwargs
) -> Spectral2DCNN:
    """Build a `Spectral2DCNN(**model_kwargs)` holding `weights`, on `device`."""
    device = resolve_device(device)
    model = Spectral2DCNN(**model_kwargs)
    model.load_state_dict(flax_to_state_dict(weights))
    return model.to(device)


_LSTM_KEYS = {
    "w_ih": "w_ih", "w_hh": "w_hh", "b_gates": "b_gates",
    "fc/kernel": "fc_kernel", "fc/bias": "fc_bias",
}


def flax_lstm_to_state_dict(weights: str | Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`.npz` path or flax param tree -> `LSTMEffectModel.state_dict()`."""
    flat = _flat_weights(weights)
    return {ours: torch.from_numpy(np.ascontiguousarray(flat[theirs]))
            for theirs, ours in _LSTM_KEYS.items()}


def lstm_state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """`LSTMEffectModel.state_dict()` -> the flax param tree (numpy, float32),
    the inverse of `flax_lstm_to_state_dict`."""
    tree: Dict[str, Any] = {}
    for theirs, ours in _LSTM_KEYS.items():
        node = tree
        *parents, leaf = theirs.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = sd[ours].detach().cpu().numpy().astype(np.float32)
    return tree


def load_lstm_effect_model(
    weights: str | Mapping[str, Any], device: str | torch.device = "cuda"
) -> LSTMEffectModel:
    """A mono-input `LSTMEffectModel` holding `weights`, on `device`; the
    hidden, latent and output sizes are read from the weights."""
    device = resolve_device(device)
    sd = flax_lstm_to_state_dict(weights)
    model = LSTMEffectModel(
        in_ch=1, out_ch=sd["fc_kernel"].shape[1], n_hidden=sd["w_hh"].shape[0],
        latent_dim=sd["w_ih"].shape[0] - 1,
    )
    model.load_state_dict(sd)
    return model.to(device)
