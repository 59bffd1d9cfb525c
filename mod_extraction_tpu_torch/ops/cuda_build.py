"""Build of the port's CUDA sources: `nvcc` for sm_90a into a shared library
with a plain C interface, at first use, into `_build/` (git-ignored),
cached by a hash of the source and the flags.  Several sources may be
built at once from different threads (one `nvcc` process each)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: str, verbose: bool = False) -> Path:
    """Compile `csrc/<source>` (cached by source hash); returns the
    library path.  With `verbose`, prints nvcc's ptxas report."""
    src_path = CSRC / source
    src = src_path.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src_path.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src_path)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src_path}:\n{proc.stderr}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path
