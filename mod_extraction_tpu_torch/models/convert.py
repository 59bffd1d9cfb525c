"""Flax-layout weights -> the port's `Spectral2DCNN` state_dict.

Reads the shipped `.npz` files (keys `Conv_{i}/kernel` (kh, kw, I, O),
`Conv_{i}/bias`, `PReLU_{i}/alpha`, `Dense_0/kernel` (I, O), `Dense_0/bias`)
or a nested dict of numpy arrays from a live flax tree (`params` level
optional).  HWIO kernels become OIHW, Dense (I, O) becomes Linear (O, I).
The inverse direction of `mod_extraction_tpu/models/torch_port.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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


def flax_to_state_dict(weights: str | Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`.npz` path or flax param tree -> `Spectral2DCNN.state_dict()`."""
    if isinstance(weights, str):
        with np.load(weights) as f:
            flat = {k: np.array(f[k], np.float32) for k in f.files}
    else:
        flat = _flatten(weights)
    flat = {k.removeprefix("params/"): v for k, v in flat.items()}
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
