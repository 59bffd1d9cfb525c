"""ctypes bindings for the native host-path library `native/modx_native.cpp`
(the port's copy of `mod_extraction_tpu/native.py`).

It speeds up what stays on the host per training example: WAV chunk decode
and the windowed-energy silence scan.  The source lies outside both
packages; this module builds it with g++ on first use into
`mod_extraction_tpu_torch/_build/` (the JAX package builds its own copy
next to the source).  Every entry point has a pure-numpy path, taken when
the library is missing or cannot be built; `MODX_NATIVE=0` turns the
library off.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "modx_native.cpp")
_SO = os.path.join(_PKG_DIR, "_build", "modx_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _WavMeta(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("num_channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("audio_format", ctypes.c_int32),
        ("num_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
        ("block_align", ctypes.c_int32),
    ]


def _build() -> bool:
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        # build under a private name, then rename: processes that build at
        # the same time never load a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # missing toolchain, read-only fs, ...
        log.info("native build failed (%s); using numpy fallbacks", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("MODX_NATIVE", "1") == "0":
            return None
        if not os.path.isfile(_SO) or (
            os.path.isfile(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not os.path.isfile(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            log.info("native load failed (%s); using numpy fallbacks", e)
            return None
        lib.modx_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavMeta)]
        lib.modx_wav_info.restype = ctypes.c_int
        lib.modx_wav_read_chunk.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(_WavMeta),
        ]
        lib.modx_wav_read_chunk.restype = ctypes.c_int64
        lib.modx_silence_scan.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_double,
        ]
        lib.modx_silence_scan.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# path -> num_channels, so repeated chunk reads skip the header parse on
# the Python side (the C side always re-parses from its single open)
_channels_cache: dict = {}


def wav_read_chunk(
    path: str,
    frame_offset: int,
    num_frames: int,
    num_channels: Optional[int] = None,
) -> Optional[tuple[np.ndarray, int]]:
    """Decode ((C, T) float32, sample_rate), or None if the native path is
    unavailable / fails (caller falls back to the numpy decoder)."""
    lib = _load()
    if lib is None:
        return None
    if num_channels is None:
        num_channels = _channels_cache.get(path)
    if num_channels is None:
        meta = _WavMeta()
        if lib.modx_wav_info(path.encode(), ctypes.byref(meta)) != 0:
            return None
        num_channels = int(meta.num_channels)
        _channels_cache[path] = num_channels
    out = np.empty((num_channels, num_frames), np.float32)
    meta = _WavMeta()
    got = lib.modx_wav_read_chunk(
        path.encode(),
        frame_offset,
        num_frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(meta),
    )
    if got != num_frames or meta.num_channels != num_channels:
        return None
    _channels_cache[path] = int(meta.num_channels)
    return out, int(meta.sample_rate)


def silence_scan(
    chunk: np.ndarray, window: int, hop: int, threshold: float
) -> Optional[bool]:
    """True if any windowed mean energy drops below threshold; None when
    the native path is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(chunk, np.float32)
    c, t = (1, x.shape[0]) if x.ndim == 1 else x.shape
    rc = lib.modx_silence_scan(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        c,
        t,
        window,
        hop,
        float(threshold),
    )
    return bool(rc)
