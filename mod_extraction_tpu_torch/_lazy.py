"""Lazy re-exports for the sub-packages' public names.

A sub-package's `__init__` names its public functions and classes (the
counterparts of the JAX package's `__all__`) without importing the modules
that define them: `from mod_extraction_tpu_torch.models import
Spectral2DCNN` imports `models/spectral_2dcnn.py` at that moment, and
`import mod_extraction_tpu_torch.models.lstm` costs what it did before.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def lazy_exports(package: str, exports: Dict[str, str]) -> Callable[[str], object]:
    """The module `__getattr__` of `package`: each name of `exports`
    ({name: defining submodule}) is read from its submodule at first use."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(f"{package}.{exports[name]}"), name)

    return __getattr__
