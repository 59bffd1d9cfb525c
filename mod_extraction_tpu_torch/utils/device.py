"""Device selection and the float32 numerics the port pins."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; asking for
    it without a card raises instead of falling back to the CPU.  Under a
    process group, "cuda" without an index is the rank's card,
    `cuda:LOCAL_RANK` (`parallel/dist.py`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if device.type == "cuda" and device.index is None and dist.is_available() and dist.is_initialized():
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None else torch.cuda.current_device())
    return device


def set_float32_numerics() -> None:
    """Full-precision float32 matmuls and convolutions on the card.

    The JAX reference computes the mel projection and any float32 conv in
    true float32; PyTorch would route float32 convs through TF32 (cuDNN's
    default), so both TF32 switches are turned off explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
