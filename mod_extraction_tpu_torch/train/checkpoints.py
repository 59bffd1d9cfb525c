"""Bare-weights files in the shipped flat `.npz` layout (the port's copy of
`save_weights` / `load_weights` in `mod_extraction_tpu/train/checkpoints.py`).

A nested dict of arrays is written with `/`-joined keys (`fc/kernel`), so a
file written here loads in the JAX package and the reverse; torch tensors
are written as float32 numpy arrays.  `models/convert.py` maps between this
flax layout and the port's state_dicts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_weights(path: str, params: Any) -> None:
    """A nested dict of arrays or tensors -> a flat `.npz`."""
    flat = {}

    def visit(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = _to_numpy(tree)

    visit("", params)
    np.savez(path, **flat)


def load_weights(path: str) -> dict:
    """Inverse of `save_weights`: the nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree
