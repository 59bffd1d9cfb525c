"""Data modules: dataset construction, loaders and the render config (the
port's copy of `mod_extraction_tpu/data/modules.py`).

A data module owns:
* train/val dataset construction (the reference's init-arg surface, so its
  YAML configs transfer),
* `Loader`s producing fixed-shape numpy batches, and
* the static `RenderConfig` the train step renders with on the card.

Registry keys accept both the reference class paths
(`mod_extraction.data_modules.X`, with the alias `FlangerCPUDataModule`)
and the short names, as the JAX package's do.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Type

from mod_extraction_tpu_torch.data.constants import (
    EFFECT_FLANGER_CHORUS,
    EFFECT_PHASER,
    EFFECT_TREMOLO,
)
from mod_extraction_tpu_torch.data.datasets import (
    FlangerChorusDataset,
    InterwovenDataset,
    PhaserDataset,
    PreprocessedDataset,
    RandomAudioChunkAndModSigDataset,
    RandomAudioChunkDataset,
    RandomAudioChunkDryWetDataset,
    RandomPreprocessedDataset,
    TremoloDataset,
)
from mod_extraction_tpu_torch.data.loader import Loader
from mod_extraction_tpu_torch.data.synthetic import flanger_max_delay_samples
from mod_extraction_tpu_torch.train.render import RenderConfig

log = logging.getLogger(__name__)


def _flanger_max_delay_samples(fx_config: Dict[str, Any], sr: float) -> int:
    fl = fx_config.get("flanger")
    if fl is None:
        return 0
    return flanger_max_delay_samples(fl["max_min_delay_ms"], fl["max_lfo_delay_ms"], sr)


class BaseDataModule:
    """Shared loader plumbing (reference `data_modules.py:67-83`)."""

    def __init__(self, batch_size: int, num_workers: int = 4, seed: int = 0,
                 transfer_dtype: str = "float32", device_corpus: bool = False):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        # "int16" halves host->device audio traffic (exact for PCM16 wavs)
        self.transfer_dtype = transfer_dtype
        # upload ALL audio to the card once, batches carry chunk offsets
        # only (data/corpus.py): no per-step audio transfer
        self.device_corpus = device_corpus
        self._corpus_index = None
        self._corpus_array = None
        self.train_dataset = None
        self.val_dataset = None

    # subclasses set these in __init__
    render_cfg: RenderConfig

    def setup(self, stage: str = "fit") -> None:
        raise NotImplementedError

    def _chunk_datasets(self) -> list:
        out, unsupported = [], []
        for ds in (self.train_dataset, self.val_dataset):
            if ds is None:
                continue
            subs = getattr(ds, "datasets", None)  # interwoven
            for d in subs if subs is not None else [ds]:
                if hasattr(d, "corpus_paths"):
                    out.append(d)
                else:
                    unsupported.append(type(d).__name__)
        if unsupported:
            # a mixed batch (some items with dry_idx, some with audio)
            # cannot be collated — fail loudly at setup instead
            raise ValueError(
                "device_corpus: these datasets have no corpus support: "
                f"{sorted(set(unsupported))}; disable device_corpus or use "
                "chunk-based datasets only"
            )
        return out

    def corpus_payload(self):
        """Build the flat int16 corpus (once) and attach its index to
        every chunk dataset; None unless `device_corpus: true`.

        Call AFTER setup() and BEFORE iterating loaders; the Trainer does
        this and copies the array to the card once."""
        if not self.device_corpus:
            return None
        from mod_extraction_tpu_torch.data.corpus import CorpusIndex

        dsets = self._chunk_datasets()
        assert dsets, "device_corpus: no chunk datasets (call setup() first)"
        paths = sorted({p for d in dsets for p in d.corpus_paths()})
        if self._corpus_index is None or sorted(self._corpus_index.base) != paths:
            self._corpus_index = CorpusIndex(paths)
            self._corpus_array = self._corpus_index.build_array()
        for d in dsets:
            d.corpus_index = self._corpus_index
        return self._corpus_array

    def train_loader(self) -> Loader:
        assert self.train_dataset is not None, "call setup('fit') first"
        return Loader(
            self.train_dataset,
            self.batch_size,
            shuffle=True,
            num_workers=self.num_workers,
            seed=self.seed,
            transfer_dtype=self.transfer_dtype,
        )

    def val_loader(self) -> Loader:
        assert self.val_dataset is not None
        return Loader(
            self.val_dataset,
            self.batch_size,
            shuffle=False,
            num_workers=self.num_workers,
            seed=self.seed + 1,
            transfer_dtype=self.transfer_dtype,
        )


class RandomAudioChunkDataModule(BaseDataModule):
    """Dry chunks only (reference `data_modules.py:86-174`)."""

    dataset_cls: Type = RandomAudioChunkDataset
    needs_fx_config = False

    def __init__(
        self,
        batch_size: int,
        train_dir: str,
        val_dir: str,
        train_num_examples_per_epoch: int,
        val_num_examples_per_epoch: int,
        n_samples: int,
        sr: float,
        ext: str = "wav",
        silence_fraction_allowed: float = 0.1,
        silence_threshold_energy: float = 1e-6,
        n_retries: int = 10,
        num_workers: int = 4,
        check_dataset: bool = True,
        end_buffer_n_samples: int = 0,
        should_peak_norm: bool = False,
        peak_norm_db: float = -1.0,
        fx_config: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        transfer_dtype: str = "float32",
        device_corpus: bool = False,
    ) -> None:
        super().__init__(batch_size, num_workers, seed, transfer_dtype, device_corpus)
        self.train_dir = train_dir
        self.val_dir = val_dir
        self.train_num = train_num_examples_per_epoch
        self.val_num = val_num_examples_per_epoch
        self.n_samples = n_samples
        self.sr = sr
        self.fx_config = fx_config or {}
        self.ds_kwargs = dict(
            n_samples=n_samples,
            sr=sr,
            ext=ext,
            silence_fraction_allowed=silence_fraction_allowed,
            silence_threshold_energy=silence_threshold_energy,
            n_retries=n_retries,
            check_dataset=check_dataset,
            end_buffer_n_samples=end_buffer_n_samples,
            should_peak_norm=should_peak_norm,
            peak_norm_db=peak_norm_db,
            seed=seed,
        )
        self.render_cfg = self._make_render_cfg()

    def _make_render_cfg(self) -> RenderConfig:
        return RenderConfig(sr=self.sr, n_samples=self.n_samples, effects=())

    def _make_dataset(self, input_dir: str, num_examples: int):
        kw = dict(self.ds_kwargs, num_examples_per_epoch=num_examples)
        if self.needs_fx_config:
            return self.dataset_cls(fx_config=self.fx_config, input_dir=input_dir, **kw)
        return self.dataset_cls(input_dir=input_dir, **kw)

    def setup(self, stage: str = "fit") -> None:
        if stage == "fit":
            self.train_dataset = self._make_dataset(self.train_dir, self.train_num)
        self.val_dataset = self._make_dataset(self.val_dir, self.val_num)


class PedalboardPhaserDataModule(RandomAudioChunkDataModule):
    """Phaser params host-side, render on device
    (replaces `data_modules.py:259-328` + worker pedalboard calls)."""

    dataset_cls = PhaserDataset
    needs_fx_config = True

    def _make_render_cfg(self) -> RenderConfig:
        return RenderConfig(
            sr=self.sr, n_samples=self.n_samples, effects=(EFFECT_PHASER,)
        )


class RandomAudioChunkAndModSigDataModule(RandomAudioChunkDataModule):
    """Chunk + LFO; audio fed as the WET input (reference mapping at
    `data_modules.py:369-371`)."""

    dataset_cls = RandomAudioChunkAndModSigDataset
    needs_fx_config = True

    def _make_render_cfg(self) -> RenderConfig:
        return RenderConfig(
            sr=self.sr, n_samples=self.n_samples, effects=(), audio_as_wet=True
        )


class TremoloDataModule(RandomAudioChunkDataModule):
    dataset_cls = TremoloDataset
    needs_fx_config = True

    def _make_render_cfg(self) -> RenderConfig:
        return RenderConfig(
            sr=self.sr, n_samples=self.n_samples, effects=(EFFECT_TREMOLO,)
        )


class FlangerDataModule(RandomAudioChunkDataModule):
    """Flanger/chorus: params host-side, delay-line render on device.

    Replaces `FlangerCPUDataModule` (`data_modules.py:374-458`) — the name
    `FlangerCPUDataModule` is kept as a registry alias so reference
    configs load; the 'CPU' part is, happily, no longer true."""

    dataset_cls = FlangerChorusDataset
    needs_fx_config = True

    def _make_render_cfg(self) -> RenderConfig:
        return RenderConfig(
            sr=self.sr,
            n_samples=self.n_samples,
            effects=(EFFECT_FLANGER_CHORUS,),
            max_delay_samples=_flanger_max_delay_samples(self.fx_config, self.sr),
        )


class RandomAudioChunkDryWetDataModule(RandomAudioChunkDataModule):
    """Paired dry/wet from disk (reference `data_modules.py:177-256`)."""

    def __init__(
        self,
        batch_size: int,
        dry_train_dir: str,
        dry_val_dir: str,
        wet_train_dir: str,
        wet_val_dir: str,
        train_num_examples_per_epoch: int,
        val_num_examples_per_epoch: int,
        n_samples: int,
        sr: float,
        **kw,
    ) -> None:
        super().__init__(
            batch_size,
            dry_train_dir,
            dry_val_dir,
            train_num_examples_per_epoch,
            val_num_examples_per_epoch,
            n_samples,
            sr,
            **kw,
        )
        self.wet_train_dir = wet_train_dir
        self.wet_val_dir = wet_val_dir

    def setup(self, stage: str = "fit") -> None:
        if stage == "fit":
            self.train_dataset = RandomAudioChunkDryWetDataset(
                dry_dir=self.train_dir,
                wet_dir=self.wet_train_dir,
                num_examples_per_epoch=self.train_num,
                **self.ds_kwargs,
            )
        self.val_dataset = RandomAudioChunkDryWetDataset(
            dry_dir=self.val_dir,
            wet_dir=self.wet_val_dir,
            num_examples_per_epoch=self.val_num,
            **self.ds_kwargs,
        )


class InterwovenDataModule(BaseDataModule):
    """Round-robin heterogeneous datasets (reference `data_modules.py:20-83`),
    with shared_args / shared_train_args / shared_val_args merging."""

    def __init__(
        self,
        batch_size: int,
        train_dataset_args,
        val_dataset_args,
        shared_train_args: Optional[Dict[str, Any]] = None,
        shared_val_args: Optional[Dict[str, Any]] = None,
        shared_args: Optional[Dict[str, Any]] = None,
        num_workers: int = 4,
        seed: int = 0,
        transfer_dtype: str = "float32",
        device_corpus: bool = False,
    ) -> None:
        super().__init__(batch_size, num_workers, seed, transfer_dtype, device_corpus)
        self.train_dataset_args = train_dataset_args
        self.val_dataset_args = val_dataset_args
        self.shared_train_args = dict(shared_train_args or {})
        self.shared_val_args = dict(shared_val_args or {})
        for k, v in (shared_args or {}).items():
            self.shared_train_args.setdefault(k, v)
            self.shared_val_args.setdefault(k, v)

        sr = self.shared_train_args.get("sr", 44100)
        n_samples = self.shared_train_args.get("n_samples", 88200)
        effects = set()
        max_delay = 0
        for args in list(train_dataset_args) + list(val_dataset_args):
            name = args.get("dataset_name", "")
            fx = args.get("fx_config", {})
            if name in ("pedalboard_phaser", "phaser"):
                effects.add(EFFECT_PHASER)
            elif name == "tremolo":
                effects.add(EFFECT_TREMOLO)
            elif name == "flanger_chorus":
                effects.add(EFFECT_FLANGER_CHORUS)
                max_delay = max(max_delay, _flanger_max_delay_samples(fx, sr))
        self.render_cfg = RenderConfig(
            sr=sr,
            n_samples=n_samples,
            effects=tuple(sorted(effects)),
            max_delay_samples=max_delay,
        )

    def setup(self, stage: str = "fit") -> None:
        if stage == "fit":
            self.train_dataset = InterwovenDataset(
                [dict(a) for a in self.train_dataset_args], self.shared_train_args
            )
            assert len(self.train_dataset.datasets) <= self.batch_size
        self.val_dataset = InterwovenDataset(
            [dict(a) for a in self.val_dataset_args], self.shared_val_args
        )
        assert len(self.val_dataset.datasets) <= self.batch_size


class PreprocessedDataModule(BaseDataModule):
    """Pre-rendered triplets from disk (reference `data_modules.py:461-503`)."""

    def __init__(
        self,
        batch_size: int,
        train_dir: str,
        val_dir: str,
        n_samples: int,
        sr: float,
        num_workers: int = 4,
        train_num_examples_per_epoch: Optional[int] = None,
        val_num_examples_per_epoch: Optional[int] = None,
        seed: int = 0,
        transfer_dtype: str = "float32",
    ) -> None:
        super().__init__(batch_size, num_workers, seed, transfer_dtype)
        self.train_dir = train_dir
        self.val_dir = val_dir
        self.n_samples = n_samples
        self.sr = sr
        self.render_cfg = RenderConfig(sr=sr, n_samples=n_samples, effects=())

    def setup(self, stage: str = "fit") -> None:
        if stage == "fit":
            self.train_dataset = PreprocessedDataset(
                self.train_dir, self.n_samples, self.sr
            )
        self.val_dataset = PreprocessedDataset(self.val_dir, self.n_samples, self.sr)


class RandomPreprocessedDataModule(PreprocessedDataModule):
    def __init__(
        self,
        train_num_examples_per_epoch: int,
        val_num_examples_per_epoch: int,
        batch_size: int,
        train_dir: str,
        val_dir: str,
        n_samples: int,
        sr: float,
        num_workers: int = 4,
        seed: int = 0,
        transfer_dtype: str = "float32",
    ) -> None:
        super().__init__(
            batch_size, train_dir, val_dir, n_samples, sr, num_workers,
            seed=seed, transfer_dtype=transfer_dtype,
        )
        self.train_num = train_num_examples_per_epoch
        self.val_num = val_num_examples_per_epoch

    def setup(self, stage: str = "fit") -> None:
        if stage == "fit":
            self.train_dataset = RandomPreprocessedDataset(
                self.train_num, self.train_dir, self.n_samples, self.sr, self.seed
            )
        self.val_dataset = RandomPreprocessedDataset(
            self.val_num, self.val_dir, self.n_samples, self.sr, self.seed + 1
        )


DATA_MODULE_REGISTRY: Dict[str, Type[BaseDataModule]] = {
    # native names
    "interwoven": InterwovenDataModule,
    "random_audio_chunk": RandomAudioChunkDataModule,
    "random_audio_chunk_dry_wet": RandomAudioChunkDryWetDataModule,
    "phaser": PedalboardPhaserDataModule,
    "random_audio_chunk_and_mod_sig": RandomAudioChunkAndModSigDataModule,
    "tremolo": TremoloDataModule,
    "flanger": FlangerDataModule,
    "preproc": PreprocessedDataModule,
    "random_preproc": RandomPreprocessedDataModule,
    # reference class-path aliases (configs transfer unmodified)
    "mod_extraction.data_modules.InterwovenDataModule": InterwovenDataModule,
    "mod_extraction.data_modules.RandomAudioChunkDataModule": RandomAudioChunkDataModule,
    "mod_extraction.data_modules.RandomAudioChunkDryWetDataModule": RandomAudioChunkDryWetDataModule,
    "mod_extraction.data_modules.PedalboardPhaserDataModule": PedalboardPhaserDataModule,
    "mod_extraction.data_modules.RandomAudioChunkAndModSigDataModule": RandomAudioChunkAndModSigDataModule,
    "mod_extraction.data_modules.FlangerCPUDataModule": FlangerDataModule,
    "mod_extraction.data_modules.PreprocessedDataModule": PreprocessedDataModule,
    "mod_extraction.data_modules.RandomPreprocessedDataModule": RandomPreprocessedDataModule,
}


def get_data_module_class(name: str) -> Type[BaseDataModule]:
    if name not in DATA_MODULE_REGISTRY:
        raise KeyError(f"Unknown data module: {name}")
    return DATA_MODULE_REGISTRY[name]
