"""Repo-relative path constants (the port's copy of
`mod_extraction_tpu/paths.py`).

Nothing is created or checked at import time: output directories are made
when something is written there.
"""

import os

ROOT_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIGS_DIR = os.path.join(ROOT_DIR, "configs")
DATA_DIR = os.path.join(ROOT_DIR, "data")
MODELS_DIR = os.path.join(ROOT_DIR, "models")
OUT_DIR = os.path.join(ROOT_DIR, "out")


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
