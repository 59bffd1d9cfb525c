"""Plotting and media logging (the port's copy of
`mod_extraction_tpu/utils/plotting.py`): spectrogram images, LFO overlay
plots with the paper's L1%-error title, and stacked waveform plots, saved as
PNGs (and WAVs) under the out dir on val batch 0.

Importing this module imports matplotlib, so only `custom.log_media: true`
imports it (`cli.py::_media_callback_for`): the training, eval and serving
paths never do.  The media callbacks render and extract through the port's
task, on its device (on the card: K1 or K2 to render, K3 for the effect
model), and leave its random generator where they found it.
"""

from __future__ import annotations

import os
from typing import Optional

import matplotlib
import numpy as np
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mod_extraction_tpu_torch.data.wav import wav_write  # noqa: E402
from mod_extraction_tpu_torch.models.lstm import lstm_init_state  # noqa: E402
from mod_extraction_tpu_torch.ops.stft import hann_window  # noqa: E402
from mod_extraction_tpu_torch.paths import OUT_DIR, ensure_dir  # noqa: E402
from mod_extraction_tpu_torch.train.render import render_batch  # noqa: E402


def _log_spec(audio: np.ndarray, n_fft: int = 512, hop: int = 128) -> np.ndarray:
    pad = n_fft // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = (len(x) - n_fft) // hop + 1
    win = hann_window(n_fft)
    frames = np.stack([x[i * hop : i * hop + n_fft] * win for i in range(n_frames)])
    mag = np.abs(np.fft.rfft(frames, axis=-1)).T
    return np.log(np.maximum(mag, 1e-7))


def _faded(audio: np.ndarray) -> np.ndarray:
    """A short linear fade in and out against clicks (the reference applies
    torchaudio's Fade)."""
    fade = min(256, len(audio) // 8)
    env = np.ones_like(audio)
    ramp = np.linspace(0.0, 1.0, fade, dtype=audio.dtype)
    env[:fade] = ramp
    env[-fade:] = ramp[::-1]
    return audio * env


def mod_sig_title(mod_sig_hat: np.ndarray, mod_sig: Optional[np.ndarray], save_name: str) -> str:
    """The overlay's title: the name, with the L1 error in percent over the
    common length when the ground truth is given."""
    if mod_sig is None:
        return save_name
    n = min(len(mod_sig), len(mod_sig_hat))
    l1 = float(np.mean(np.abs(mod_sig[:n] - mod_sig_hat[:n])))
    return f"{save_name}  l1: {l1 * 100:.2f}%"


def plot_spectrogram(
    audio: np.ndarray,
    save_name: str,
    title: str = "",
    sr: float = 44100.0,
    save_dir: Optional[str] = None,
    save_audio: bool = False,
) -> str:
    """Log-spectrogram PNG (reference `plotting.py:35-68`); optional WAV."""
    save_dir = ensure_dir(save_dir or os.path.join(OUT_DIR, "media"))
    audio = np.asarray(audio).reshape(-1)
    spec = _log_spec(audio)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.imshow(spec, origin="lower", aspect="auto", cmap="magma")
    ax.set_title(title or save_name)
    ax.set_xlabel("frames")
    ax.set_ylabel("bins")
    path = os.path.join(save_dir, f"{save_name}.png")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    if save_audio:
        wav_write(os.path.join(save_dir, f"{save_name}.wav"), _faded(audio), int(sr))
    return path


def plot_mod_sig(
    mod_sig_hat: np.ndarray,
    mod_sig: Optional[np.ndarray] = None,
    save_name: str = "mod_sig",
    save_dir: Optional[str] = None,
) -> str:
    """Overlaid ground-truth and estimated LFO with the L1%-error title
    (reference `plotting.py:71-97`)."""
    save_dir = ensure_dir(save_dir or os.path.join(OUT_DIR, "media"))
    mod_sig_hat = np.asarray(mod_sig_hat).reshape(-1)
    if mod_sig is not None:
        mod_sig = np.asarray(mod_sig).reshape(-1)
    fig, ax = plt.subplots(figsize=(6, 2.5))
    ax.plot(mod_sig_hat, label="mod_sig_hat", color="tab:orange")
    if mod_sig is not None:
        n = min(len(mod_sig), len(mod_sig_hat))
        ax.plot(mod_sig[:n], label="mod_sig", color="tab:blue", alpha=0.7)
    ax.set_ylim(-0.05, 1.05)
    ax.set_title(mod_sig_title(mod_sig_hat, mod_sig, save_name))
    ax.legend(loc="upper right", fontsize=7)
    path = os.path.join(save_dir, f"{save_name}.png")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_waveforms_stacked(
    waveforms: list[np.ndarray],
    labels: list[str],
    save_name: str = "waveforms",
    sr: float = 44100.0,
    save_dir: Optional[str] = None,
) -> str:
    """Stacked waveform plot (reference `plotting.py:113-155`)."""
    save_dir = ensure_dir(save_dir or os.path.join(OUT_DIR, "media"))
    n = len(waveforms)
    fig, axes = plt.subplots(n, 1, figsize=(6, 1.6 * n), sharex=True)
    if n == 1:
        axes = [axes]
    for ax, w, label in zip(axes, waveforms, labels):
        w = np.asarray(w).reshape(-1)
        t = np.arange(len(w)) / sr
        ax.plot(t, w, linewidth=0.4)
        ax.set_ylabel(label, fontsize=8)
        ax.set_ylim(-1.05, 1.05)
    axes[-1].set_xlabel("seconds")
    path = os.path.join(save_dir, f"{save_name}.png")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def _media_dir(trainer, epoch: int) -> str:
    return ensure_dir(os.path.join(trainer.out_dir, trainer.run_name + "_media", f"ep{epoch}"))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def lfo_media_callback(max_examples: int = 4):
    """Media hook of the extractor's Trainer: on val batch 0, spectrograms of
    the wet audio and LFO overlays for the first few examples (reference
    `callbacks.py:37-99`)."""

    @torch.no_grad()
    def cb(trainer, batch, epoch):
        task = trainer.task
        state = task.generator.get_state()
        if task.has_params:
            task.model.eval()
        try:
            dry, wet, mod_frames, fx = render_batch(batch, task.render_cfg, trainer.corpus)
            mod_hat, _ = task._extract(dry, wet, fx, None)
            mod_hat, mod_gt = task._postprocess(mod_hat, mod_frames)
        finally:
            task.generator.set_state(state)
        mod_hat, mod_gt, wet = _numpy(mod_hat), _numpy(mod_gt), _numpy(wet)
        save_dir = _media_dir(trainer, epoch)
        for i in range(min(max_examples, wet.shape[0])):
            plot_mod_sig(mod_hat[i], mod_gt[i], save_name=f"{i}_mod_sig", save_dir=save_dir)
            plot_spectrogram(wet[i, 0], f"{i}_wet", sr=task.render_cfg.sr, save_dir=save_dir)

    return cb


def em_media_callback(max_examples: int = 4, save_audio: bool = True):
    """Media hook of the TBPTT effect-model Trainer: on val batch 0, stacked
    dry / wet / wet_hat waveform plots and audio for the first few examples
    (reference `callbacks.py:102-184`, LogAudioCallback).  wet_hat is one
    no-gradient pass of the effect model over the whole cropped clip."""

    @torch.no_grad()
    def cb(trainer, batch, epoch):
        task = trainer.task
        em = task.effect_model
        state = task.generator.get_state()
        em.eval()
        try:
            dry, wet, mod_sr, _, _ = task._prepare(batch, trainer.corpus)
            h0 = lstm_init_state(dry.shape[0], em.n_hidden, task.device)
            wet_hat, _ = em(dry, task._latent(mod_sr, wet), h0)
        finally:
            task.generator.set_state(state)
        dry, wet, wet_hat = _numpy(dry), _numpy(wet), _numpy(wet_hat)
        sr = task.render_cfg.sr
        save_dir = _media_dir(trainer, epoch)
        for i in range(min(max_examples, dry.shape[0])):
            plot_waveforms_stacked(
                [dry[i, 0], wet[i, 0], wet_hat[i, 0]], ["dry", "wet", "wet_hat"],
                save_name=f"{i}_waveforms", sr=sr, save_dir=save_dir,
            )
            if save_audio:
                for name, a in (("dry", dry), ("wet", wet), ("wet_hat", wet_hat)):
                    wav_write(os.path.join(save_dir, f"{i}_{name}.wav"), a[i], int(sr))

    return cb
