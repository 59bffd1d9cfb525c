"""The launch counts of every kernel wrapper (`fx_kernels`, `lstm_kernels`,
`conv_kernels`) in one place, and their record across processes.

A tool that trains in fresh processes (`scripts/train_resumable_torch.sh`)
calls `log_launch_counts()` at the end of each: with `MODX_LAUNCH_LOG` set
to a file, the process appends its counts there as one JSON line, so the
caller can sum what its children launched."""

from __future__ import annotations

import json
import os

from mod_extraction_tpu_torch.ops import conv_kernels, fx_kernels, lstm_kernels

_MODULES = (fx_kernels, lstm_kernels, conv_kernels)
#: the environment variable naming the file `log_launch_counts` appends to
LOG_ENV = "MODX_LAUNCH_LOG"


def launch_counts() -> dict:
    """{wrapper: launches since its module's last reset}, all wrappers."""
    return {k: v for m in _MODULES for k, v in m.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for m in _MODULES:
        m.reset_launch_counts()


def log_launch_counts() -> None:
    """Append `launch_counts()` as a JSON line to the file `$MODX_LAUNCH_LOG`
    names; nothing when it is unset."""
    path = os.environ.get(LOG_ENV)
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(launch_counts()) + "\n")


def read_launch_log(path: str) -> list:
    """The per-process counts a launch log holds, in the order written."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
