"""On-device effect rendering (port of `mod_extraction_tpu/train/render.py`).

The batch arrives as (dry or corpus offsets, frame-rate mod_sig, fx params)
and leaves as (dry, wet, mod_sig, fx), all on the batch's device.  A batch
may mix effects (interwoven training): each enabled effect runs on the
whole batch and rows are `where`-selected by `fx["effect_idx"]`.  Flanger
and chorus share one delay-line launch whose length is the static maximum
(exact: unwritten slots read zero either way).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from mod_extraction_tpu_torch.data.constants import (
    EFFECT_FLANGER_CHORUS,
    EFFECT_PHASER,
    EFFECT_TREMOLO,
    MOD_SIG_DIVISOR,
)
from mod_extraction_tpu_torch.ops.fx import apply_phaser, apply_tremolo, phaser_freq_max
from mod_extraction_tpu_torch.ops.fx_kernels import flanger
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim


@dataclass(frozen=True)
class RenderConfig:
    sr: float
    n_samples: int
    effects: Tuple[int, ...] = ()
    max_delay_samples: int = 0  # unified flanger/chorus buffer length
    phaser_n_stages: int = 6
    # RandomAudioChunkAndModSigDataModule: the chunk is the WET input and
    # the dry input is silence
    audio_as_wet: bool = False

    @property
    def n_mod_frames(self) -> int:
        return self.n_samples // MOD_SIG_DIVISOR


def flanger_delay_samples(fx: Dict, mod_audio: torch.Tensor, sr: float) -> torch.Tensor:
    """Per-sample delay mld*width*mod + min_delay_width*mmd, (B, 1, T)."""
    mmd = torch.round(fx["max_min_delay_ms"] / 1000.0 * sr)[:, None, None]
    mld = torch.round(fx["max_lfo_delay_ms"] / 1000.0 * sr)[:, None, None]
    return (
        mld * fx["width"][:, None, None] * mod_audio
        + fx["min_delay_width"][:, None, None] * mmd
    )


def phaser_params(fx: Dict, sr: float) -> Dict[str, torch.Tensor]:
    """`apply_phaser` keyword arguments from the fx params, clamped to the
    JUCE-valid ranges (rate > 0, centre within the 20 .. 0.49*sr sweep)."""
    return dict(
        rate_hz=torch.clamp(fx["rate_hz"], min=1e-3),
        depth=fx["depth"],
        centre_frequency_hz=torch.clamp(
            fx["centre_frequency_hz"], 20.0, phaser_freq_max(sr)
        ),
        feedback=fx["feedback"],
        mix=fx["mix"],
        phase=fx["phase"],
    )


def render_batch(
    batch: Dict, cfg: RenderConfig, corpus: torch.Tensor | None = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """(dry, wet, mod_sig_frames, fx), rendered on the batch's device.

    Batches from a device corpus carry `dry_idx`/`dry_gain` (and maybe
    `wet_*`) instead of audio; their chunks are gathered from `corpus`
    (int16 PCM is dequantized, then scaled by the gain)."""

    def dequant(a):
        if a.dtype == torch.int16:
            return a.to(torch.float32) / 32768.0
        return a

    def gather(side):
        if corpus is None:
            raise ValueError(f"batch carries {side}_idx but no corpus was given")
        offs = batch[f"{side}_idx"].to(torch.int64)
        idx = offs[:, None] + torch.arange(cfg.n_samples, device=offs.device)
        return dequant(corpus[idx])[:, None, :] * batch[f"{side}_gain"][:, None, None]

    dry = gather("dry") if "dry_idx" in batch else dequant(batch["dry"])
    if "wet_idx" in batch:
        wet = gather("wet")
    elif "wet" in batch:
        wet = dequant(batch["wet"])
    else:
        wet = torch.zeros_like(dry)
    mod_frames = batch["mod_sig"]
    fx = batch["fx"]
    eff = fx["effect_idx"]
    t = dry.shape[-1]

    if cfg.audio_as_wet:
        return torch.zeros_like(dry), dry, mod_frames, fx

    if EFFECT_TREMOLO in cfg.effects or EFFECT_FLANGER_CHORUS in cfg.effects:
        # align_corners=True upsample to audio rate
        mod_audio = linear_interpolate_last_dim(mod_frames, t)[:, None, :]

    if EFFECT_TREMOLO in cfg.effects:
        wet_trem = apply_tremolo(dry, mod_audio[:, 0, :], fx["mix"])
        wet = torch.where((eff == EFFECT_TREMOLO)[:, None, None], wet_trem, wet)

    if EFFECT_FLANGER_CHORUS in cfg.effects:
        if cfg.max_delay_samples <= 0:
            raise ValueError("flanger/chorus rendering needs max_delay_samples > 0")
        wet_fl = flanger(
            dry,
            flanger_delay_samples(fx, mod_audio, cfg.sr),
            fx["feedback"][:, None, None],
            fx["depth"][:, None, None],
            fx["mix"][:, None, None],
            cfg.max_delay_samples,
        )
        wet = torch.where((eff == EFFECT_FLANGER_CHORUS)[:, None, None], wet_fl, wet)

    if EFFECT_PHASER in cfg.effects:
        wet_ph, mod_ph = apply_phaser(
            dry, cfg.sr, **phaser_params(fx, cfg.sr), n_stages=cfg.phaser_n_stages
        )
        wet = torch.where((eff == EFFECT_PHASER)[:, None, None], wet_ph, wet)
        # the phaser's GT LFO, at frame rate
        mod_ph_frames = linear_interpolate_last_dim(mod_ph, cfg.n_mod_frames)
        mod_frames = torch.where(
            (eff == EFFECT_PHASER)[:, None], mod_ph_frames, mod_frames
        )

    return dry, wet, mod_frames, fx
