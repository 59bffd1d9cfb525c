"""WAV file I/O in numpy (the port's copy of `mod_extraction_tpu/data/wav.py`).

Replaces the reference's use of `torchaudio.info/load/save`
(`mod_extraction/datasets.py:122-136,175-187`) in the host input pipeline.
Supports RIFF/WAVE with PCM 8/16/24/32-bit (format 1) and float 32/64
(format 3), including WAVE_FORMAT_EXTENSIBLE, with frame-offset chunk
reads so random 2-second crops never load whole files.

A C++ fast path (native/modx_native.cpp via mod_extraction_tpu_torch.native)
accelerates chunk decoding; this module is the always-available
pure-Python fallback and the correctness reference.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    bits_per_sample: int
    audio_format: int  # 1 = PCM, 3 = IEEE float
    data_offset: int  # byte offset of the sample data
    block_align: int


def _parse_header(f) -> WavInfo:
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:8])[0]
        if chunk_id == b"fmt ":
            body = f.read(size)
            (audio_format, n_ch, sr, _byte_rate, block_align, bits) = struct.unpack(
                "<HHIIHH", body[:16]
            )
            if audio_format == 0xFFFE and size >= 40:  # EXTENSIBLE
                audio_format = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_format, n_ch, sr, block_align, bits)
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_format, n_ch, sr, block_align, bits = fmt
            if block_align == 0:
                block_align = n_ch * (bits // 8)
            return WavInfo(
                sample_rate=sr,
                num_frames=size // block_align,
                num_channels=n_ch,
                bits_per_sample=bits,
                audio_format=audio_format,
                data_offset=f.tell(),
                block_align=block_align,
            )
        else:
            f.seek(size + (size & 1), os.SEEK_CUR)


def wav_info(path: str) -> WavInfo:
    with open(path, "rb") as f:
        return _parse_header(f)


def _decode(raw: bytes, info: WavInfo, n_frames: int) -> np.ndarray:
    c = info.num_channels
    if info.audio_format == 3:
        dt = np.float32 if info.bits_per_sample == 32 else np.float64
        x = np.frombuffer(raw, dt).astype(np.float32)
    elif info.bits_per_sample == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif info.bits_per_sample == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif info.bits_per_sample == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / 8388608.0
    elif info.bits_per_sample == 8:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported bit depth: {info.bits_per_sample}")
    return np.ascontiguousarray(x.reshape(n_frames, c).T)  # (C, T)


def wav_read(
    path: str, frame_offset: int = 0, num_frames: int = -1
) -> tuple[np.ndarray, int]:
    """Read (channels, frames) float32 in [-1, 1] + sample rate.

    `frame_offset`/`num_frames` mirror torchaudio.load's chunked reads."""
    if num_frames > 0:
        # chunk reads are the per-example hot path — try the C++ decoder
        from mod_extraction_tpu_torch import native

        if native.available():
            got = native.wav_read_chunk(path, frame_offset, num_frames)
            if got is not None:
                return got
    with open(path, "rb") as f:
        info = _parse_header(f)
        if num_frames < 0:
            num_frames = info.num_frames - frame_offset
        num_frames = max(0, min(num_frames, info.num_frames - frame_offset))
        f.seek(info.data_offset + frame_offset * info.block_align)
        raw = f.read(num_frames * info.block_align)
        got = len(raw) // info.block_align
        raw = raw[: got * info.block_align]
        return _decode(raw, info, got), info.sample_rate


def wav_write(path: str, audio: np.ndarray, sr: int, bits: int = 16) -> None:
    """Write (channels, frames) or (frames,) float32 as PCM16/float32 WAV."""
    if audio.ndim == 1:
        audio = audio[None, :]
    c, t = audio.shape
    inter = np.ascontiguousarray(audio.T, dtype=np.float32)
    if bits == 16:
        data = (np.clip(inter, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        audio_format, bps = 1, 16
    elif bits == 32:
        data = inter.astype("<f4").tobytes()
        audio_format, bps = 3, 32
    else:
        raise ValueError("bits must be 16 or 32")
    block_align = c * bps // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, audio_format, c, sr, sr * block_align, block_align, bps
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
