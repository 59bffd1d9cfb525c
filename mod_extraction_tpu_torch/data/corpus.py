"""Device-resident audio corpus (the port's copy of
`mod_extraction_tpu/data/corpus.py`): the training wavs go to the card's
memory once, and each step's batch carries chunk offsets instead of audio.

Layout: ONE flat int16 array holding every (file, channel) track back to
back; batches carry `dry_idx` (int32 start offsets into it) and `dry_gain`
(and `wet_*` for dry/wet pairs).  `train/render.py::render_batch` gathers
the chunks on the card.

Quantization matches the int16 wire format (`data/loader.py::collate`),
so corpus-fed training equals int16-wire training (exact for PCM16
sources), except under `should_peak_norm`, where the wire path quantizes
the already-normalized chunk while the corpus path applies the gain after
dequantizing (up to one int16 LSB times the gain).

Enabled per data module with `device_corpus: true`; the host keeps its
chunk-selection logic (silence rejection, retries, channel picks) and
ships indices instead of samples.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Tuple

import numpy as np

from mod_extraction_tpu_torch.data.wav import wav_info, wav_read

log = logging.getLogger(__name__)


class CorpusIndex:
    """Maps (path, channel, start_frame) -> index into the flat array.

    Layout: files in sorted-path order; within a file, channels are
    stored back to back (channel-major), so
    `index = base[path] + channel * n_frames[path] + start`."""

    def __init__(self, paths: Iterable[str]) -> None:
        self.base: Dict[str, int] = {}
        self.n_frames: Dict[str, int] = {}
        self.meta: List[Tuple[str, int, int]] = []  # (path, channels, frames)
        offset = 0
        for p in sorted(set(paths)):
            info = wav_info(p)
            self.base[p] = offset
            self.n_frames[p] = info.num_frames
            self.meta.append((p, info.num_channels, info.num_frames))
            offset += info.num_channels * info.num_frames
        self.total_samples = offset

    def global_index(self, path: str, channel: int, start: int) -> int:
        return self.base[path] + channel * self.n_frames[path] + start

    def build_array(self) -> np.ndarray:
        """Read every file once -> flat int16 array (the wire format)."""
        out = np.empty(self.total_samples, np.int16)
        for path, channels, frames in self.meta:
            audio, _ = wav_read(path)  # (C, N) float32 in [-1, 1]
            q = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
            b = self.base[path]
            out[b : b + channels * frames] = q.reshape(-1)
        log.info(
            "Device corpus: %d files, %.1f MB int16",
            len(self.meta),
            out.nbytes / 1e6,
        )
        return out
