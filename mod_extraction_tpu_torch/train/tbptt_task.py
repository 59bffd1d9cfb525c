"""TBPTT effect-model training: the conditional LSTM on a frozen extractor
(port of `mod_extraction_tpu/train/tbptt_task.py`, the frozen-extractor,
RandomLFO and ground-truth-LFO conditionings).

A step renders the batch, extracts its LFO with the frozen extractor (or
draws it from a `RandomLFO` baseline, or takes the ground-truth one when
`lfo_model` is None), smooths it,
stretches its corners and centre-crops the audio to match, weights out the
examples whose LFO fails the validity rules, and upsamples the LFO to audio
rate.  `train_step` then runs a warm-up of the LSTM without gradient (K3)
and a Python loop over the chunks: forward (K4), loss, backward (K5), an
AdamW step, and a detach of the hidden state.  `val_step` runs one
no-gradient forward over the whole cropped clip (K3).

Invalid LFOs keep their place in the batch with weight zero, so every
weighted mean leaves them out (the JAX package's deviation from the
reference, which drops them).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mod_extraction_tpu_torch.losses.losses import BatchWeights, WeightedLossDict
from mod_extraction_tpu_torch.models.lstm import (
    LSTMEffectModel,
    detach_state,
    lstm_init_state,
)
from mod_extraction_tpu_torch.models.random_lfo import RandomLFO
from mod_extraction_tpu_torch.ops.corners import (
    find_valid_mod_sig_mask,
    smoothen,
    stretch_corners,
)
from mod_extraction_tpu_torch.parallel.dist import (
    all_reduce_grads,
    all_reduce_mean,
    rank_sum,
    reduce_metrics,
    world,
)
from mod_extraction_tpu_torch.train.lfo_task import (
    OptimizerFactory,
    TrainableTask,
    center_crop_last,
    make_optimizer,
)
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
from mod_extraction_tpu_torch.utils.device import resolve_device, set_float32_numerics
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim


# the TBPTT variants not ported yet
VARIANTS_QUEUED = "the TBPTT variants are queued in ROADMAP.md, queue 1 item 3"


def _global_weights(weights: torch.Tensor) -> BatchWeights:
    """The batch's validity weights with the ranks' mean weight sum: one
    all-reduce a batch serves every weighted loss of its chunks."""
    return BatchWeights(weights, all_reduce_mean(weights.sum()))


class TBPTTEffectModelingTask(TrainableTask):
    """Owns the effect model, the frozen extractor and the optimizer;
    `train_step` / `val_step` take a batch dict of tensors on the task's
    device.  `optimizer` and `lr_schedule` as in `LFOExtractionTask`; the
    schedule advances once per chunk update (`updates_per_batch` a batch).
    `use_dry=False` gives the extractor the wet signal alone.  The
    unfrozen extractor, a `param_model` and `stretch_smooth_n_frames`
    raise `NotImplementedError`."""

    has_params = True  # the effect model always trains, whatever conditions it

    def __init__(
        self,
        effect_model: LSTMEffectModel,
        render_cfg: RenderConfig,
        warmup_n_samples: int = 1024,
        step_n_samples: int = 1024,
        lfo_model: Optional[torch.nn.Module | RandomLFO] = None,
        freeze_lfo_model: bool = True,
        param_model: Optional[torch.nn.Module] = None,
        optimizer: Optional[OptimizerFactory] = None,
        lr_schedule: Optional[Callable[[int], float]] = None,
        use_dry: bool = True,
        model_smooth_n_frames: int = 8,
        should_stretch: bool = True,
        max_n_corners: int = 16,
        stretch_smooth_n_frames: int = 0,
        discard_invalid_lfos: bool = True,
        loss_dict: Optional[Dict[str, float]] = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        if not freeze_lfo_model and lfo_model is not None and not isinstance(lfo_model, RandomLFO):
            raise NotImplementedError(f"freeze_lfo_model: false (an unfrozen extractor): {VARIANTS_QUEUED}")
        if param_model is not None:
            raise NotImplementedError(f"param_model: {VARIANTS_QUEUED}")
        if stretch_smooth_n_frames:
            raise NotImplementedError(f"stretch_smooth_n_frames: {stretch_smooth_n_frames}: {VARIANTS_QUEUED}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_float32_numerics()
        self.effect_model = effect_model.to(self.device)
        self.lfo_model = lfo_model
        self.is_random_lfo = isinstance(lfo_model, RandomLFO)
        if lfo_model is not None and not self.is_random_lfo:
            self.lfo_model = lfo_model.to(self.device).eval().requires_grad_(False)
        # the RandomLFO conditioning draws from this host generator
        self.lfo_generator = self.generator = torch.Generator().manual_seed(seed)
        self.render_cfg = render_cfg
        self.warmup_n_samples = warmup_n_samples
        self.step_n_samples = step_n_samples
        self.trained_model = self.effect_model
        self.optimizer, self.scheduler = make_optimizer(
            self.effect_model.parameters(), optimizer, lr_schedule
        )
        self.use_dry = use_dry
        self.model_smooth_n_frames = model_smooth_n_frames
        self.should_stretch = should_stretch
        self.max_n_corners = max_n_corners
        self.discard_invalid_lfos = discard_invalid_lfos
        self.losses = WeightedLossDict(loss_dict or {"l1": 1.0, "esr": 0.0, "dc": 0.0})

    def state_dict(self) -> Dict:
        """The trainable state plus the frozen extractor's weights, as the
        JAX package's train state keeps `lfo_params`: a checkpoint hands on
        both (`scripts/extract_torch_weights.py ... lfo_model`)."""
        state = super().state_dict()
        if self.lfo_model is not None and not self.is_random_lfo:
            state["lfo_model"] = self.lfo_model.state_dict()
        return state

    def load_state_dict(self, state: Dict) -> None:
        super().load_state_dict(state)
        if "lfo_model" in state:
            self.lfo_model.load_state_dict(state["lfo_model"])

    # ------------------------------------------------------------- geometry
    def _cropped_n_samples(self) -> int:
        """Audio length after the proportional centre crop that follows
        the smoothing of the LFO."""
        t = self.render_cfg.n_samples
        if self.lfo_model is None or self.is_random_lfo:
            n_hat = self.render_cfg.n_mod_frames
        else:
            n_hat = t // 256 + 1  # extractor frames
        removed = max(0, self.model_smooth_n_frames - 1)
        return int(((n_hat - removed) / n_hat) * t)

    @property
    def updates_per_batch(self) -> int:
        """Optimizer updates (chunks) per batch."""
        return max((self._cropped_n_samples() - self.warmup_n_samples) // self.step_n_samples, 1)

    # --------------------------------------------------------------- LFO
    @torch.no_grad()
    def _extract_mod_sig(self, dry, wet, mod_frames, fx=None, lfo_draws=None):
        """The LFO (B, F) that conditions the effect model: the frozen
        extractor's output on cat(dry, wet) (on wet alone without
        `use_dry`), a RandomLFO baseline's draw
        (anchored to `fx` as it is configured; `lfo_draws` feeds its random
        numbers in the tests), or the ground truth without an extractor."""
        if self.lfo_model is None:
            return mod_frames
        if self.is_random_lfo:
            w = world()
            return self.lfo_model(
                self.lfo_generator, wet.shape[0], fx, draws=lfo_draws, device=self.device,
                shard=(w.rank, w.size),
            )[:, 0, :]
        model_in = torch.cat([dry, wet], dim=1) if self.use_dry else wet
        return self.lfo_model(model_in)[0][:, 0, :].to(torch.float32)

    def _smooth_stretch(self, mod_hat):
        """Smoothed, corner-stretched LFO and the frames this removed."""
        orig = mod_hat.shape[-1]
        if self.model_smooth_n_frames > 1:
            mod_hat = smoothen(mod_hat, self.model_smooth_n_frames)
        if self.should_stretch:
            mod_hat = stretch_corners(mod_hat, max_n_corners=self.max_n_corners, smooth_n_frames=0)
        return mod_hat, orig - mod_hat.shape[-1]

    @torch.no_grad()
    def _prepare(self, batch, corpus=None, lfo_draws=None):
        """render -> extract -> smooth/stretch -> crop -> validity ->
        upsample.  Returns (dry, wet, mod_sr (B, 1, T'), mod_hat (B, F'),
        weights (B,))."""
        dry_full, wet_full, mod_frames, fx = render_batch(batch, self.render_cfg, corpus)
        t = dry_full.shape[-1]
        if t < self.warmup_n_samples + self.step_n_samples:
            raise ValueError(f"a clip of {t} samples holds no chunk after the warm-up")
        mod_hat, removed = self._smooth_stretch(
            self._extract_mod_sig(dry_full, wet_full, mod_frames, fx, lfo_draws)
        )
        n_frames = mod_hat.shape[-1]
        n_samples = int((n_frames / (n_frames + removed)) * t)
        dry = center_crop_last(dry_full, n_samples)
        wet = center_crop_last(wet_full, n_samples)
        if self.discard_invalid_lfos:
            weights = find_valid_mod_sig_mask(mod_hat).to(torch.float32)
        else:
            weights = torch.ones(dry.shape[0], dtype=torch.float32, device=dry.device)
        mod_sr = linear_interpolate_last_dim(mod_hat, n_samples)[:, None, :]
        return dry, wet, mod_sr, mod_hat, weights

    # --------------------------------------------------------------- steps
    def train_step(
        self, batch: Dict, corpus: Optional[torch.Tensor] = None, lfo_draws: Optional[dict] = None
    ) -> Dict[str, torch.Tensor]:
        """One batch: a no-gradient warm-up, then one AdamW update per
        chunk with the hidden state detached between chunks.  The metrics
        compare the chunks' outputs (each from the weights before its
        update) with the wet audio, warm-up excluded.

        Under data parallelism (`parallel/dist.py`) `batch` is this rank's
        rows: each chunk's gradients are averaged over the ranks before its
        update, the weighted losses divide by the global weight sum (summed
        over the ranks once a batch), and the metrics are those of the
        global batch."""
        em = self.effect_model
        em.train()
        dry, wet, mod_sr, _, weights = self._prepare(batch, corpus, lfo_draws)
        bw, ranks = _global_weights(weights), rank_sum()
        w, s = self.warmup_n_samples, self.step_n_samples
        n_chunks = (dry.shape[-1] - w) // s
        with torch.no_grad():
            h0 = lstm_init_state(dry.shape[0], em.n_hidden, self.device)
            _, hidden = em(dry[:, :, :w], mod_sr[:, :, :w], h0)
        ys = []
        for i in range(n_chunks):
            a, e = w + i * s, w + (i + 1) * s
            self.optimizer.zero_grad(set_to_none=True)
            y, new_hidden = em(dry[:, :, a:e], mod_sr[:, :, a:e], hidden)
            loss, _ = self.losses(y, wet[:, :, a:e], bw, ranks)
            loss.backward()
            all_reduce_grads(em.parameters())
            self._update()
            hidden = detach_state(new_hidden)
            ys.append(y.detach())
        with torch.no_grad():
            _, metrics = self.losses(torch.cat(ys, dim=-1), wet[:, :, w : w + n_chunks * s], bw, ranks)
        metrics["valid_fraction"] = weights.mean()
        return reduce_metrics({k: v.detach() for k, v in metrics.items()})

    @torch.no_grad()
    def val_step(
        self, batch: Dict, corpus: Optional[torch.Tensor] = None, lfo_draws: Optional[dict] = None
    ) -> Dict[str, torch.Tensor]:
        """One forward over the whole cropped clip (the reference's chunk
        loop without updates), warm-up excluded from the metrics."""
        em = self.effect_model
        em.eval()
        dry, wet, mod_sr, _, weights = self._prepare(batch, corpus, lfo_draws)
        w, s = self.warmup_n_samples, self.step_n_samples
        end = w + (dry.shape[-1] - w) // s * s
        h0 = lstm_init_state(dry.shape[0], em.n_hidden, self.device)
        wet_hat, _ = em(dry[:, :, :end], mod_sr[:, :, :end], h0)
        _, metrics = self.losses(wet_hat[:, :, w:], wet[:, :, w:end], _global_weights(weights), rank_sum())
        metrics["valid_fraction"] = weights.mean()
        return reduce_metrics(metrics)
