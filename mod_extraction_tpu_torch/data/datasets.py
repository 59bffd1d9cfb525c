"""Host-side datasets: random audio chunks + LFO/fx parameter sampling (the
port's copy of `mod_extraction_tpu/data/datasets.py`).

Datasets do only host work: file scanning, random chunk draws with silence
rejection, dry/wet pairing and frame-rate LFO synthesis (cheap numpy).  The
audio-rate effect rendering (flanger / chorus, phaser, tremolo) happens on
the card inside the train step (`train/render.py`).

Every example is a dict with one schema, so that heterogeneous datasets can
be interwoven and collated into fixed-shape batches:

    dry      (1, n_samples) float32
    wet      (1, n_samples) float32, OMITTED when rendered on the card
    mod_sig  (n_samples // 100,) float32 (zeros when rendered on the card)
    fx       dict of scalars: effect routing + parameters; missing
             params default to 0.0

`fx["effect_idx"]` routes the rendering: 0 none (wet from disk),
1 tremolo, 2 flanger/chorus, 3 phaser.

Randomness: every draw comes from a `np.random.Generator` seeded by
(seed, epoch, index), in the JAX package's order, so both packages give the
same examples bit for bit from the same seed, and epochs are reproducible
and independent of the number of loader threads.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

from mod_extraction_tpu_torch import native
from mod_extraction_tpu_torch.data import mods
from mod_extraction_tpu_torch.data.constants import (
    EFFECT_FLANGER_CHORUS,
    EFFECT_PHASER,
    EFFECT_TREMOLO,
    MOD_SIG_DIVISOR,
    default_fx,
)
from mod_extraction_tpu_torch.data.wav import wav_info, wav_read

log = logging.getLogger(__name__)


def sample_log_uniform(rng: np.random.Generator, lo: float, hi: float) -> float:
    if lo == hi:
        return float(lo)
    return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))


def sample_exp(rng: np.random.Generator, e) -> float:
    """LFO exponent draw: a scalar (reference semantics, fixed exp —
    `datasets.py:361`), or {min, max[, p_identity]} — exponent-distortion
    augmentation for robustness to the exp-2.0 eval conditions
    (p_identity keeps that much probability mass at the undistorted
    exp=1.0 shape)."""
    if isinstance(e, dict):
        if rng.uniform() < float(e.get("p_identity", 0.0)):
            return 1.0
        return float(rng.uniform(e["min"], e["max"]))
    return float(e)


def get_file_paths(input_dir: str, ext: str) -> List[str]:
    """Recursive sorted scan (reference `datasets.py:230-241`)."""
    assert os.path.isdir(input_dir), input_dir
    paths = []
    for root, _, files in os.walk(input_dir):
        for name in files:
            if name.endswith(ext) and not name.startswith("."):
                paths.append(os.path.join(root, name))
    paths.sort()
    assert paths, f"no .{ext} files under {input_dir}"
    return paths


def peak_normalize(audio: np.ndarray, peak_norm_db: float = -1.0) -> np.ndarray:
    """pyloudnorm-style peak normalization (`datasets.py:214-219`)."""
    peak = np.max(np.abs(audio))
    if peak == 0:
        return audio
    gain = 10.0 ** (peak_norm_db / 20.0) / peak
    return (audio * gain).astype(np.float32)


class RandomAudioChunkDataset:
    """Random non-silent chunks from a wav dir (reference `datasets.py:86-241`)."""

    def __init__(
        self,
        input_dir: str,
        n_samples: int,
        sr: float,
        ext: str = "wav",
        num_examples_per_epoch: int = 10000,
        silence_fraction_allowed: float = 0.2,
        silence_threshold_energy: float = 1e-6,
        n_retries: int = 10,
        check_dataset: bool = True,
        min_suitable_files_fraction: float = 0.5,
        end_buffer_n_samples: int = 0,
        should_peak_norm: bool = False,
        peak_norm_db: float = -1.0,
        seed: int = 0,
    ) -> None:
        self.input_dir = input_dir
        self.n_samples = int(n_samples)
        n_samples = self.n_samples
        self.sr = float(sr)
        sr = self.sr
        self.num_examples_per_epoch = int(num_examples_per_epoch)
        self.silence_fraction_allowed = float(silence_fraction_allowed)
        silence_fraction_allowed = self.silence_fraction_allowed
        # explicit coercion: YAML renders scientific notation like `1e-4`
        # as a *string* (PyYAML needs a decimal point to parse a float)
        self.silence_threshold_energy = float(silence_threshold_energy)
        self.n_retries = int(n_retries)
        self.end_buffer_n_samples = int(end_buffer_n_samples)
        self.should_peak_norm = bool(should_peak_norm)
        self.peak_norm_db = float(peak_norm_db)
        self.seed = seed
        self.max_n_consecutive_silent_samples = int(
            silence_fraction_allowed * n_samples
        )

        paths = get_file_paths(input_dir, ext)
        filtered = []
        self.file_n_frames: Dict[str, int] = {}
        total = 0
        for p in paths:
            info = wav_info(p)
            if info.num_frames < n_samples:
                continue
            if info.sample_rate != sr:
                log.info("Bad sample rate %s, removing: %s", info.sample_rate, p)
                continue
            filtered.append(p)
            self.file_n_frames[p] = info.num_frames
            total += info.num_frames
        log.info(
            "Filtered to %d files (%.0f s of audio)", len(filtered), total / sr
        )
        assert filtered, f"no usable files in {input_dir}"
        self.input_paths = filtered

        if check_dataset:
            assert self.check_dataset_for_suitable_files(
                n_samples, min_suitable_files_fraction, end_buffer_n_samples
            ), "Could not find a suitable non-silent audio chunk in the dataset"

    # -- silence / chunk machinery -------------------------------------
    def check_for_silence(self, chunk: np.ndarray) -> bool:
        """Windowed-energy silence test (reference `datasets.py:162-169`)."""
        w = self.max_n_consecutive_silent_samples
        if w < 1:
            return False
        hop = max(1, w // 4)
        native_result = native.silence_scan(
            chunk, w, hop, self.silence_threshold_energy
        )
        if native_result is not None:
            return native_result
        energy = chunk**2
        t = chunk.shape[-1]
        n_win = (t - w) // hop + 1
        if n_win <= 0:
            return False
        # strided windowed means without materializing the unfold
        cs = np.concatenate(
            [np.zeros(energy.shape[:-1] + (1,)), np.cumsum(energy, -1)], -1
        )
        starts = np.arange(n_win) * hop
        means = (cs[..., starts + w] - cs[..., starts]) / w
        return bool((means < self.silence_threshold_energy).any())

    def find_audio_chunk_in_file(
        self, rng, path: str, n_samples: int, end_buffer: int = 0
    ) -> Optional[Tuple[np.ndarray, int]]:
        file_frames = self.file_n_frames.get(path)
        if file_frames is None:
            file_frames = wav_info(path).num_frames
        if n_samples > file_frames - end_buffer:
            return None
        start = int(rng.integers(0, file_frames - n_samples - end_buffer + 1))
        chunk, _ = wav_read(path, start, n_samples)
        if self.check_for_silence(chunk):
            return None
        return chunk, start

    def search_dataset_for_audio_chunk(
        self, rng, n_samples: int, end_buffer: int = 0
    ) -> Tuple[np.ndarray, str, int, int]:
        """Retry loop with file-pool fallback (reference `datasets.py:189-212`)."""
        pool = list(self.input_paths)
        path = pool.pop(int(rng.integers(len(pool))))
        attempts = 0
        while True:
            found = self.find_audio_chunk_in_file(rng, path, n_samples, end_buffer)
            if found is not None:
                break
            attempts += 1
            if attempts >= self.n_retries:
                assert pool, "exhausted file pool searching for audio chunk"
                path = pool.pop(int(rng.integers(len(pool))))
                attempts = 0
        chunk, start = found
        ch_idx = 0
        if chunk.shape[0] > 1:
            ch_idx = int(rng.integers(chunk.shape[0]))
            chunk = chunk[ch_idx : ch_idx + 1]
        return chunk, path, ch_idx, start

    def check_dataset_for_suitable_files(
        self, n_samples: int, min_fraction: float, end_buffer: int = 0
    ) -> bool:
        """Startup audit (reference `datasets.py:145-160`)."""
        rng = np.random.default_rng(self.seed)
        need = max(1, int(min_fraction * len(self.input_paths)))
        good = 0
        for p in self.input_paths:
            for _ in range(self.n_retries):
                if self.find_audio_chunk_in_file(rng, p, n_samples, end_buffer):
                    good += 1
                    break
        log.info("Found %d suitable of %d files", good, len(self.input_paths))
        return good >= need

    # -- public API ------------------------------------------------------
    def __len__(self) -> int:
        return self.num_examples_per_epoch

    def _rng(self, epoch: int, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx])
        )

    def _maybe_norm(self, audio: np.ndarray) -> np.ndarray:
        return (
            peak_normalize(audio, self.peak_norm_db)
            if self.should_peak_norm
            else audio
        )

    # device-resident corpus mode (data/corpus.py): attached by the data
    # module; when set, items carry chunk OFFSETS instead of samples
    corpus_index = None

    def corpus_paths(self) -> list:
        """Files the device corpus must hold for this dataset."""
        return list(self.input_paths)

    def _norm_gain(self, chunk: np.ndarray) -> float:
        """Peak-norm as a scalar gain (applied on device after gather)."""
        if not self.should_peak_norm:
            return 1.0
        peak = float(np.abs(chunk).max())
        if peak == 0:
            return 1.0
        return 10.0 ** (self.peak_norm_db / 20.0) / peak

    def _dry_fields(self, rng) -> Dict[str, Any]:
        """Draw a chunk; emit either the audio or its corpus offset."""
        chunk, path, ch, start = self.search_dataset_for_audio_chunk(
            rng, self.n_samples, self.end_buffer_n_samples
        )
        if self.corpus_index is None:
            return {"dry": self._maybe_norm(chunk)}
        return {
            "dry_idx": np.int32(self.corpus_index.global_index(path, ch, start)),
            "dry_gain": np.float32(self._norm_gain(chunk)),
        }

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        rng = self._rng(epoch, idx)
        return {
            **self._dry_fields(rng),
            "mod_sig": np.zeros(self.n_samples // MOD_SIG_DIVISOR, np.float32),
            "fx": default_fx(),
        }


class RandomAudioChunkDryWetDataset(RandomAudioChunkDataset):
    """Paired dry/wet chunks at the same offset (reference `datasets.py:244-329`)."""

    def __init__(self, dry_dir: str, wet_dir: str, n_samples: int, sr: float, **kw):
        super().__init__(dry_dir, n_samples, sr, **kw)
        wet_by_name = {os.path.basename(p): p for p in get_file_paths(wet_dir, "wav")}
        dry_paths, self.name_to_wet = [], {}
        for dry_p in self.input_paths:
            name = os.path.basename(dry_p)
            assert name in wet_by_name, f"Missing wet file: {name}"
            wet_p = wet_by_name[name]
            di, wi = wav_info(dry_p), wav_info(wet_p)
            if di.sample_rate != wi.sample_rate:
                continue
            if abs(di.num_frames - wi.num_frames) > self.end_buffer_n_samples:
                continue
            if di.num_channels != wi.num_channels:
                continue
            dry_paths.append(dry_p)
            self.name_to_wet[name] = wet_p
        assert dry_paths, "no valid dry/wet pairs"
        log.info("Found %d dry/wet pairs", len(dry_paths))
        self.input_paths = sorted(dry_paths)

    def corpus_paths(self) -> list:
        return list(self.input_paths) + sorted(self.name_to_wet.values())

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        rng = self._rng(epoch, idx)
        dry, path, ch_idx, start = self.search_dataset_for_audio_chunk(
            rng, self.n_samples, self.end_buffer_n_samples
        )
        wet_path = self.name_to_wet[os.path.basename(path)]
        base = {
            "mod_sig": np.zeros(self.n_samples // MOD_SIG_DIVISOR, np.float32),
            "fx": default_fx(),
        }
        if self.corpus_index is not None:
            gi = self.corpus_index.global_index
            if self.should_peak_norm:
                # wet chunk only needed host-side to compute its norm gain
                wet, _ = wav_read(wet_path, start, self.n_samples)
                if wet.shape[0] > 1:
                    wet = wet[ch_idx : ch_idx + 1]
                wet_gain = self._norm_gain(wet)
            else:
                wet_gain = 1.0  # skip the wet read: gain is identity
            return {
                "dry_idx": np.int32(gi(path, ch_idx, start)),
                "dry_gain": np.float32(self._norm_gain(dry)),
                "wet_idx": np.int32(gi(wet_path, ch_idx, start)),
                "wet_gain": np.float32(wet_gain),
                **base,
            }
        wet, _ = wav_read(wet_path, start, self.n_samples)
        if wet.shape[0] > 1:
            wet = wet[ch_idx : ch_idx + 1]
        return {
            "dry": self._maybe_norm(dry),
            "wet": self._maybe_norm(wet),
            **base,
        }


class RandomAudioChunkAndModSigDataset(RandomAudioChunkDataset):
    """Chunk + on-the-fly frame-rate LFO (reference `datasets.py:332-398`).

    Supports the `combined` and `quasiperiodic` fx_config variants."""

    def __init__(self, fx_config: Dict[str, Any], *args, **kw):
        super().__init__(*args, **kw)
        self.fx_config = fx_config

    def _sample_mod_sig(self, rng) -> Tuple[np.ndarray, Dict[str, Any]]:
        ms = self.fx_config["mod_sig"]
        rate = sample_log_uniform(rng, ms["rate_hz"]["min"], ms["rate_hz"]["max"])
        phase = float(rng.uniform(ms["phase"]["min"], ms["phase"]["max"]))
        shapes = ms["shapes"]
        shape = shapes[int(rng.integers(len(shapes)))]
        exp = sample_exp(rng, ms["exp"])
        n_frames = self.n_samples // MOD_SIG_DIVISOR
        frame_sr = self.sr // MOD_SIG_DIVISOR
        if ms.get("combined", False):
            mod = mods.make_combined_mod_sig(rng, n_frames, frame_sr, rate, phase, shapes)
        else:
            mod = mods.np_make_mod_signal(n_frames, frame_sr, rate, phase, shape, exp)
        if ms.get("quasiperiodic", False):
            mod = mods.make_quasi_periodic(
                rng, mod, ms["l_min"], ms["l_max"], ms["r_min"], ms["r_max"],
                ms["lr_split"],
            )
        fx = default_fx()
        fx.update(
            rate_hz=rate,
            phase=phase,
            shape=mods.LFO_SHAPES.index(shape),
            exp=exp,
        )
        return mod, fx

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        rng = self._rng(epoch, idx)
        dry_fields = self._dry_fields(rng)
        mod, fx = self._sample_mod_sig(rng)
        return {
            **dry_fields,
            "mod_sig": mod,
            "fx": fx,
        }


class PhaserDataset(RandomAudioChunkAndModSigDataset):
    """Phaser parameter sampling; rendering happens on device.

    Replaces `PedalboardPhaserDataset` (`datasets.py:401-482`).  Instead of
    processing n_samples + one LFO period and random-cropping (dynamic
    shapes), we draw a uniform random LFO phase and let the device kernel
    start from zero filter state — the phase distribution matches; the
    short allpass warm-up transient is the documented deviation."""

    def __init__(self, fx_config: Dict[str, Any], *args, **kw):
        # bypass parent's requirement for a "mod_sig" block
        RandomAudioChunkDataset.__init__(self, *args, **kw)
        self.fx_config = fx_config
        assert "pedalboard_phaser" in fx_config

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        rng = self._rng(epoch, idx)
        dry_fields = self._dry_fields(rng)
        r = self.fx_config["pedalboard_phaser"]
        fx = default_fx()
        fx.update(
            effect_idx=EFFECT_PHASER,
            rate_hz=sample_log_uniform(rng, r["rate_hz"]["min"], r["rate_hz"]["max"]),
            depth=float(rng.uniform(r["depth"]["min"], r["depth"]["max"])),
            centre_frequency_hz=sample_log_uniform(
                rng, r["centre_frequency_hz"]["min"], r["centre_frequency_hz"]["max"]
            ),
            feedback=float(rng.uniform(r["feedback"]["min"], r["feedback"]["max"])),
            mix=float(rng.uniform(r["mix"]["min"], r["mix"]["max"])),
            phase=float(rng.uniform(0.0, 2.0 * np.pi)),
            shape=mods.LFO_SHAPES.index("cos"),
        )
        return {
            **dry_fields,
            "mod_sig": np.zeros(self.n_samples // MOD_SIG_DIVISOR, np.float32),
            "fx": fx,
        }


class TremoloDataset(RandomAudioChunkAndModSigDataset):
    """Tremolo params + LFO; device-rendered (reference `datasets.py:485-501`)."""

    def __init__(self, fx_config, *args, **kw):
        super().__init__(fx_config, *args, **kw)
        assert "tremolo" in fx_config

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        item = super().getitem(epoch, idx)
        rng = self._rng(epoch, idx ^ 0x5EED)
        r = self.fx_config["tremolo"]
        item["fx"].update(
            effect_idx=EFFECT_TREMOLO,
            mix=float(rng.uniform(r["mix"]["min"], r["mix"]["max"])),
        )
        return item


class FlangerChorusDataset(RandomAudioChunkAndModSigDataset):
    """Flanger/chorus params + LFO; device-rendered.

    Covers what `FlangerCPUDataModule.on_before_batch_transfer` does on
    host in the reference (`data_modules.py:419-458`): per-example
    feedback / min_delay_width / width / depth / mix draws."""

    def __init__(self, fx_config, *args, **kw):
        super().__init__(fx_config, *args, **kw)
        assert "flanger" in fx_config

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        item = super().getitem(epoch, idx)
        rng = self._rng(epoch, idx ^ 0xF1A9)
        r = self.fx_config["flanger"]

        def u(name):
            return float(rng.uniform(r[name]["min"], r[name]["max"]))

        item["fx"].update(
            effect_idx=EFFECT_FLANGER_CHORUS,
            feedback=u("feedback"),
            min_delay_width=u("min_delay_width"),
            width=u("width"),
            depth=u("depth"),
            mix=u("mix"),
            max_min_delay_ms=float(r["max_min_delay_ms"]),
            max_lfo_delay_ms=float(r["max_lfo_delay_ms"]),
        )
        return item


class PreprocessedDataset:
    """Pre-rendered triplets <hash>.pt + _dry.wav + _wet.wav
    (reference `datasets.py:504-534`).  Also accepts .npz payloads with
    mod_sig/fx_params entries."""

    def __init__(self, input_dir: str, n_samples: int, sr: float) -> None:
        self.input_dir = input_dir
        self.n_samples = n_samples
        self.sr = sr
        self.pt_paths = [
            p
            for p in get_file_paths(input_dir, "")
            if p.endswith(".pt") or p.endswith(".npz")
        ]
        assert self.pt_paths, f"no .pt/.npz files under {input_dir}"
        self.dry_paths = [f"{os.path.splitext(p)[0]}_dry.wav" for p in self.pt_paths]
        self.wet_paths = [f"{os.path.splitext(p)[0]}_wet.wav" for p in self.pt_paths]

    def __len__(self) -> int:
        return len(self.pt_paths)

    def _load_meta(self, path: str):
        if path.endswith(".npz"):
            data = np.load(path, allow_pickle=True)
            mod = data["mod_sig"].astype(np.float32)
            fxp = data["fx_params"].item() if "fx_params" in data else {}
        else:
            import torch

            data = torch.load(path, map_location="cpu", weights_only=False)
            mod = data["mod_sig"].numpy().astype(np.float32)
            fxp = {
                k: (float(v) if np.isscalar(v) or hasattr(v, "item") else v)
                for k, v in data["fx_params"].items()
            }
        return mod, fxp

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        mod, fxp = self._load_meta(self.pt_paths[idx])
        dry, sr = wav_read(self.dry_paths[idx])
        assert sr == self.sr and dry.shape[-1] == self.n_samples
        wet, sr = wav_read(self.wet_paths[idx])
        assert sr == self.sr and wet.shape[-1] == self.n_samples
        fx = default_fx()
        for k, v in fxp.items():
            if k == "shape" and isinstance(v, str):
                fx["shape"] = mods.LFO_SHAPES.index(v)
            elif k in fx:
                fx[k] = float(v)
        n_frames = self.n_samples // MOD_SIG_DIVISOR
        if mod.shape[-1] != n_frames:
            mod = mods.np_linear_interp(mod, n_frames)
        return {"dry": dry, "wet": wet, "mod_sig": mod, "fx": fx}


class RandomPreprocessedDataset(PreprocessedDataset):
    """Uniform-with-replacement sampling for a fixed epoch size
    (reference `datasets.py:537-551`)."""

    def __init__(self, num_examples_per_epoch: int, input_dir: str,
                 n_samples: int, sr: float, seed: int = 0) -> None:
        super().__init__(input_dir, n_samples, sr)
        self.num_examples_per_epoch = num_examples_per_epoch
        self.seed = seed

    def __len__(self) -> int:
        return self.num_examples_per_epoch

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, idx]))
        return super().getitem(epoch, int(rng.integers(len(self.pt_paths))))


class InterwovenDataset:
    """Round-robin mix of heterogeneous sub-datasets
    (reference `datasets.py:41-83`), with `n_copies` weighting."""

    def __init__(
        self, dataset_args: List[Dict[str, Any]], common_args: Dict[str, Any]
    ) -> None:
        names, weights, datasets = [], [], []
        for raw in dataset_args:
            ds_args = dict(raw)
            name = ds_args.pop("dataset_name")
            names.append(name)
            n_copies = ds_args.pop("n_copies", 1)
            weights.append(n_copies)
            for k, v in common_args.items():
                ds_args.setdefault(k, v)
            for _ in range(n_copies):
                datasets.append(get_dataset_class(name)(**ds_args))
        self.dataset_names = names
        self.dataset_weightings = weights
        self.datasets = datasets
        self.size = len(datasets[0])
        assert all(len(d) == self.size for d in datasets)

    def __len__(self) -> int:
        return self.size

    def getitem(self, epoch: int, idx: int) -> Dict[str, Any]:
        return self.datasets[idx % len(self.datasets)].getitem(epoch, idx)


def get_dataset_class(name: str) -> Type:
    """Name registry (reference `datasets.py:22-38`), plus device-rendered
    flanger/chorus which the reference drives through its data module."""
    registry = {
        "random_audio_chunk": RandomAudioChunkDataset,
        "random_audio_chunk_dry_wet": RandomAudioChunkDryWetDataset,
        "random_audio_chunk_and_mod_sig": RandomAudioChunkAndModSigDataset,
        "pedalboard_phaser": PhaserDataset,
        "phaser": PhaserDataset,
        "tremolo": TremoloDataset,
        "flanger_chorus": FlangerChorusDataset,
        "preproc": PreprocessedDataset,
        "random_preproc": RandomPreprocessedDataset,
    }
    if name not in registry:
        raise ValueError(f"Unknown dataset name: {name}")
    return registry[name]
