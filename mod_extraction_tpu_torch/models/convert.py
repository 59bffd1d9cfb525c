"""Flax-layout weights <-> the port's `Spectral2DCNN`, `LSTMEffectModel` and
TCN-family (`TCN`, `SpectralTCN`, `SpectralDSTCN`) state_dicts.

Reads the shipped `.npz` files or a nested dict of numpy arrays from a live
flax tree (`params` level optional).  Spectral2DCNN keys: `Conv_{i}/kernel`
(kh, kw, I, O), `Conv_{i}/bias`, `PReLU_{i}/alpha`, `Dense_0/kernel` (I, O),
`Dense_0/bias`; HWIO kernels become OIHW, Dense (I, O) becomes Linear
(O, I) (the inverse direction of `mod_extraction_tpu/models/torch_port.py`).
LSTM keys: `w_ih` (in_dim, 4H), `w_hh` (H, 4H), `b_gates` (4H,),
`fc/kernel` (H, out), `fc/bias` (out,), kept in that layout.
TCN keys follow the module tree: `[tcn/]block_{i}/conv/kernel` (K, I, O)
<-> `[tcn.]blocks.{i}.conv.weight` (O, I, K), `.../res/kernel`,
`.../act/alpha`, `.../film/adaptor/*`, `output/*`, `fc/*`, `fc_act/alpha`;
FiLM's `batch_stats` (`.../film/bn/mean`, `var`) <-> the BN buffers.
`spectral_2dcnn_state_dict_to_flax`, `lstm_state_dict_to_flax` and
`tcn_state_dict_to_flax` map back, exactly: the weights a port-trained model
hands on (`scripts/extract_torch_weights.py`) load in the JAX package.
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


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """`/`-joined keys -> the nested flax tree."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def spectral_2dcnn_state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """`Spectral2DCNN.state_dict()` -> the flax param tree (numpy, float32),
    the inverse of `flax_to_state_dict`: OIHW kernels back to HWIO, the
    Linear (O, I) back to Dense (I, O)."""
    n_layers = sum(1 for k in sd if k.startswith("convs.") and k.endswith(".weight"))
    flat: Dict[str, np.ndarray] = {}
    for i in range(n_layers):
        flat[f"Conv_{i}/kernel"] = np.ascontiguousarray(np.transpose(_np(sd[f"convs.{i}.weight"]), (2, 3, 1, 0)))
        flat[f"Conv_{i}/bias"] = _np(sd[f"convs.{i}.bias"])
        flat[f"PReLU_{i}/alpha"] = _np(sd[f"prelus.{i}.alpha"])
    flat["Dense_0/kernel"] = np.ascontiguousarray(_np(sd["out.weight"]).T)
    flat["Dense_0/bias"] = _np(sd["out.bias"])
    return _nest(flat)


def load_spectral_2dcnn(
    weights: str | Mapping[str, Any], device: str | torch.device = "cuda", **model_kwargs
) -> Spectral2DCNN:
    """Build a `Spectral2DCNN(**model_kwargs)` holding `weights`, on `device`."""
    device = resolve_device(device)
    model = Spectral2DCNN(**model_kwargs)
    model.load_state_dict(flax_to_state_dict(weights))
    return model.to(device)


_BN_LEAVES = {"mean": "running_mean", "var": "running_var"}


def tcn_flax_to_state_dict(weights: str | Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`.npz` path, flax param tree or flax variables ({"params", and
    "batch_stats" when a FiLM has BN}) -> the state_dict of the TCN-family
    module they belong to."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in _flat_weights(weights).items():
        stats = key.startswith("batch_stats/")
        *mods, leaf = key.removeprefix("batch_stats/").split("/")
        mods = [f"blocks.{m[len('block_'):]}" if m.startswith("block_") else m for m in mods]
        if stats:
            leaf = _BN_LEAVES[leaf]
        elif leaf == "kernel":  # conv (K, I, O) -> (O, I, K); dense (I, O) -> (O, I)
            leaf, v = "weight", np.transpose(v, (2, 1, 0)) if v.ndim == 3 else v.T
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def tcn_state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A TCN-family state_dict -> flax variables {"params": tree} (numpy,
    float32), with "batch_stats" when it holds FiLM BN buffers; the inverse
    of `tcn_flax_to_state_dict`."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        path = []
        for m in mods:
            if path and path[-1] == "blocks":
                path[-1] = f"block_{m}"
            else:
                path.append(m)
        v = _np(t)
        coll = "params"
        if leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf.removeprefix("running_")
        elif leaf == "weight":
            leaf, v = "kernel", np.transpose(v, (2, 1, 0)) if v.ndim == 3 else v.T
        flat["/".join([coll, *path, leaf])] = np.ascontiguousarray(v)
    return _nest(flat)


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
    return _nest({theirs: _np(sd[ours]) for theirs, ours in _LSTM_KEYS.items()})


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
