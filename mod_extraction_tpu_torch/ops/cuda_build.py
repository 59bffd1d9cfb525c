"""Build of the port's CUDA sources: `nvcc` for sm_90a into a shared library
with a plain C interface, at first use, into `_build/` (git-ignored),
cached by a hash of the source, the headers it includes from `csrc/` and
the flags.  Several sources may be
built at once from different threads (one `nvcc` process each)."""

from __future__ import annotations

import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(source: str) -> str:
    """Hash of `csrc/<source>`, of every header it includes from `csrc/`
    (quoted includes, followed recursively) and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        data = (CSRC / name).read_bytes()
        h.update(name.encode() + b"\0" + data)
        todo += [m.decode() for m in _INCLUDE.findall(data) if (CSRC / m.decode()).exists()]
    return h.hexdigest()[:16]


def build(source: str, verbose: bool = False) -> Path:
    """Compile `csrc/<source>` (cached by `source_digest`); returns the
    library path.  With `verbose`, prints nvcc's ptxas report."""
    src_path = CSRC / source
    digest = source_digest(source)
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


def ptxas_report(source: str) -> list[str]:
    """Registers, spills and performance notes of every kernel in
    `csrc/<source>`, one line each, from a fresh `nvcc` run into a scratch
    file (a cached library reports nothing)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True,
        )
    finally:
        os.remove(tmp)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    lines, name, spill = [], None, ""
    for line in proc.stderr.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
        elif "Performance" in line or "C75" in line:
            lines.append(line.strip())
    return lines
