"""Training checkpoints and bare-weights files (the port's copy of
`mod_extraction_tpu/train/checkpoints.py`).

`CheckpointManager` keeps `last` and best-by-val-loss checkpoints with the
JAX package's `last.json` / `best.json` / `meta.json` layout; the state
itself is a `torch.save` of the task's model, optimizer and scheduler
`state_dict`s, its generator state and the step (`<name>.pt`).  Orbax's
format is not carried across: the bare weights cross both ways through
`save_weights` / `load_weights`.

A bare-weights `.npz` holds a nested dict of arrays with `/`-joined keys
(`fc/kernel`), so a file written here loads in the JAX package and the
reverse; torch tensors are written as float32 numpy arrays.
`models/convert.py` maps between this flax layout and the port's
state_dicts.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from mod_extraction_tpu_torch.paths import ensure_dir


class CheckpointManager:
    """`save_last` / `maybe_save_best` / `restore` under `ckpt_dir`."""

    def __init__(self, ckpt_dir: str) -> None:
        self.ckpt_dir = ensure_dir(os.path.abspath(ckpt_dir))
        self.meta_path = os.path.join(self.ckpt_dir, "meta.json")
        self.best_val = float("inf")
        if os.path.isfile(self.meta_path):
            with open(self.meta_path) as f:
                self.best_val = json.load(f).get("best_val", float("inf"))

    def path(self, name: str) -> str:
        """The state file of checkpoint `name` (`last`, `best`), or `name`
        itself when it is a path to a file."""
        if os.path.isfile(name):
            return name
        return os.path.join(self.ckpt_dir, f"{name}.pt")

    def _save(self, name: str, task, step: int, meta: dict) -> None:
        path = os.path.join(self.ckpt_dir, f"{name}.pt")
        tmp = f"{path}.tmp"
        torch.save({"task": task.state_dict(), "step": step}, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.ckpt_dir, f"{name}.json"), "w") as f:
            json.dump(meta, f)

    def save_last(self, task, epoch: int, step: int) -> None:
        self._save("last", task, step, {"epoch": epoch, "step": step})

    def maybe_save_best(self, task, val_loss: float, epoch: int, step: int) -> bool:
        if val_loss < self.best_val:
            self.best_val = float(val_loss)
            self._save("best", task, step, {"epoch": epoch, "step": step, "val_loss": val_loss})
            with open(self.meta_path, "w") as f:
                json.dump({"best_val": self.best_val}, f)
            return True
        return False

    def restore(self, name: str, task) -> Optional[int]:
        """Load checkpoint `name` into `task`; returns its step, or None
        when there is no such checkpoint."""
        path = self.path(name)
        if not os.path.isfile(path):
            return None
        state: Dict[str, Any] = torch.load(path, map_location="cpu", weights_only=False)
        task.load_state_dict(state["task"])
        return int(state["step"])

    def meta(self, name: str) -> dict:
        path = os.path.join(self.ckpt_dir, f"{name}.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return json.load(f)


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
