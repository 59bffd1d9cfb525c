"""TBPTT effect-model training: the conditional LSTM on an LFO extractor
(port of `mod_extraction_tpu/train/tbptt_task.py`).

A step renders the batch, extracts its LFO with the extractor (or draws it
from a `RandomLFO` baseline, or takes the ground-truth one when `lfo_model`
is None), smooths it, stretches its corners (after a smoothing of its own
when `stretch_smooth_n_frames` > 1) and centre-crops the audio to match,
weights out the examples whose LFO fails the validity rules, and upsamples
the LFO to audio rate.  `train_step` then runs a warm-up of the LSTM
without gradient (K3) and a Python loop over the chunks: forward (K4),
loss, backward (K5), an AdamW step, and a detach of the hidden state.
`val_step` runs one no-gradient forward over the whole cropped clip (K3).

The variants of the JAX task:

* `param_model` (a `SpectralDSTCN`): a clip-level latent of the cropped wet
  signal, repeated over the samples and concatenated after the LFO on the
  LSTM's input channels.  The warm-up takes it without gradient; every
  chunk recomputes it with gradient, so K5's `dseq` rows of the latent
  train the param model; `val_step` takes it over the whole clip.
* `freeze_lfo_model: false` (an unfrozen extractor): the validity weights,
  the warm-up's LFO and the crop come from the extractor's weights at the
  start of the step, without gradient; each chunk then extracts again from
  the full uncropped clip with the CURRENT weights (chunk i sees the
  extractor after i updates), and the gradient flows through the
  smoothing, the corner stretch, the upsampling and K5's `dseq` into it.
  The extractor runs as the JAX package applies it, without SpecAugment.

Every trained part (effect model, param model, unfrozen extractor) sits in
one `trained_model`: the effect model alone on the frozen path (the
checkpoint layout of the shipped configs), else a `ModuleDict` {effect,
param?, lfo?} (the JAX `init_state`'s layout).  One optimizer covers it,
its schedule advanced once a chunk, and one gradient all-reduce a chunk
(`parallel/dist.py`) covers every part.

On the card the chunk updates of a conditioning fixed for the step (the
frozen extractor, a RandomLFO, the ground truth; no param model) replay a
CUDA graph by the rule of `utils/graphs.py`, one launch an update in place
of about seventy: the step lays its conditioning, dry and wet audio out
chunk by chunk in static buffers (`_ChunkGraph`, one per batch and chunk
shape), and the graph reads its chunk through a device-side index it
advances itself, carries (h, c) in a static slot and writes its output
into the chunk's slot.  The optimizer is then capturable
(`lfo_task.optimizer_form`).  The CPU, data parallelism, the unfrozen
extractor and the param model keep the eager loop.

Invalid LFOs keep their place in the batch with weight zero, so every
weighted mean leaves them out (the JAX package's deviation from the
reference, which drops them).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

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
    is_distributed,
    rank_sum,
    reduce_metrics,
    world,
)
from mod_extraction_tpu_torch.train.lfo_task import (
    OptimizerFactory,
    TrainableTask,
    can_capture,
    center_crop_last,
    make_optimizer,
)
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
from mod_extraction_tpu_torch.utils.device import resolve_device, set_float32_numerics
from mod_extraction_tpu_torch.utils.graphs import GraphCache
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim
from mod_extraction_tpu_torch.utils.spans import span


class _ChunkGraph:
    """One chunk shape's static buffers: the step's conditioning, dry and
    wet audio from the warm-up's end laid out chunk by chunk, (B, L + C_in
    + C_out, n_chunks, step); the batch weights and their global sum; the
    carried (h, c); the index of the chunk the update reads, which it
    advances; the outputs' slots (B, C_out, n_chunks, step)."""

    __slots__ = ("split", "inputs", "weights", "state", "index", "ys")

    def __init__(self, b: int, split: Tuple[int, int, int], n: int, s: int, hid: int, device) -> None:
        f32 = dict(dtype=torch.float32, device=device)
        self.split = split  # channels of the conditioning, the dry and the wet audio
        self.inputs = torch.empty(b, sum(split), n, s, **f32)
        self.weights = torch.empty(b + 1, **f32)
        self.state = torch.empty(2, b, hid, **f32)
        self.index = torch.zeros(1, dtype=torch.long, device=device)
        self.ys = torch.empty(b, split[2], n, s, **f32)

    def load(self, lat, dry, wet, start: int, bw: BatchWeights, hidden) -> None:
        """The step's inputs from sample `start`, its weights and the
        warm-up's state, in four launches (the index to 0 the last)."""
        b, c, n, s = self.inputs.shape
        seg = slice(start, start + n * s)
        torch.cat([lat[..., seg], dry[..., seg], wet[..., seg]], dim=1, out=self.inputs.view(b, c, n * s))
        torch.cat([bw.values, bw.total.reshape(1)], out=self.weights)
        torch.stack(hidden, out=self.state)
        self.index.zero_()

    def batch_weights(self) -> BatchWeights:
        b = self.state.shape[1]
        return BatchWeights(self.weights[:b], self.weights[b])


def _global_weights(weights: torch.Tensor) -> BatchWeights:
    """The batch's validity weights with the ranks' mean weight sum: one
    all-reduce a batch serves every weighted loss of its chunks."""
    return BatchWeights(weights, all_reduce_mean(weights.sum()))


class TBPTTEffectModelingTask(TrainableTask):
    """Owns the effect model, the extractor (frozen or trained), a param
    model if any, and the optimizer;
    `train_step` / `val_step` take a batch dict of tensors on the task's
    device.  `optimizer` and `lr_schedule` as in `LFOExtractionTask`, over
    every trained part; the schedule advances once per chunk update
    (`updates_per_batch` a batch).  `use_dry=False` gives the extractor the
    wet signal alone."""

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
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_float32_numerics()
        self.effect_model = effect_model.to(self.device)
        self.lfo_model = lfo_model
        self.is_random_lfo = isinstance(lfo_model, RandomLFO)
        self.trainable_lfo = lfo_model is not None and not freeze_lfo_model and not self.is_random_lfo
        if lfo_model is not None and not self.is_random_lfo:
            # eval: no SpecAugment, as the JAX task applies it with train=False
            self.lfo_model = lfo_model.to(self.device).eval().requires_grad_(self.trainable_lfo)
        # the RandomLFO conditioning draws from this host generator
        self.lfo_generator = self.generator = torch.Generator().manual_seed(seed)
        self.render_cfg = render_cfg
        self.warmup_n_samples = warmup_n_samples
        self.step_n_samples = step_n_samples
        self.use_dry = use_dry
        self.model_smooth_n_frames = model_smooth_n_frames
        self.should_stretch = should_stretch
        self.max_n_corners = max_n_corners
        self.stretch_smooth_n_frames = stretch_smooth_n_frames
        self.discard_invalid_lfos = discard_invalid_lfos
        self.losses = WeightedLossDict(loss_dict or {"l1": 1.0, "esr": 0.0, "dc": 0.0})
        self.param_model = None if param_model is None else param_model.to(self.device).eval()
        if hasattr(self.param_model, "n_samples"):
            # it sees the centre-cropped wet signal (the JAX task sets its length so)
            self.param_model.n_samples = self._cropped_n_samples()
        parts = {"effect": self.effect_model}
        if self.param_model is not None:
            parts["param"] = self.param_model
        if self.trainable_lfo:
            parts["lfo"] = self.lfo_model
        self.multi_params = len(parts) > 1
        self.trained_model = nn.ModuleDict(parts) if self.multi_params else self.effect_model
        graphs = self.device.type == "cuda" and self._static_conditioning()
        self.optimizer, self.scheduler = make_optimizer(
            self.trained_model.parameters(), optimizer, lr_schedule, capturable=graphs
        )
        self.capturable = graphs and can_capture(self.optimizer)
        # the chunk updates from static buffers (`_static_chunks`), 4 shapes (B, split, n_chunks,
        # step) kept in `graphs`; off, the eager loop (tests and tools hold the two together)
        self.static_chunks = self.capturable
        self.graphs = GraphCache(4, self.device, "tbptt.capture")

    def state_dict(self) -> Dict:
        """The trainable state plus a frozen extractor's weights, as the JAX
        package's train state keeps `lfo_params`: a checkpoint hands on both
        (`scripts/extract_torch_weights.py ... lfo_model`).  An unfrozen
        extractor is `trained_model`'s "lfo" part."""
        state = super().state_dict()
        if self.lfo_model is not None and not self.is_random_lfo and not self.trainable_lfo:
            state["lfo_model"] = self.lfo_model.state_dict()
        return state

    def load_state_dict(self, state: Dict) -> None:
        """The state, its optimizer put back in the task's form; captured
        updates are dropped (they hold the optimizer state's old tensors)."""
        self.graphs.clear()
        super().load_state_dict(state)
        if "lfo_model" in state:
            self.lfo_model.load_state_dict(state["lfo_model"])

    def _static_conditioning(self) -> bool:
        """Whether a step's conditioning is fixed before its chunks (no
        unfrozen extractor, no param model): what `_static_chunks` needs."""
        return not self.trainable_lfo and self.param_model is None

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
        if self.stretch_smooth_n_frames > 1 and self.should_stretch:
            removed += self.stretch_smooth_n_frames - 1
        return int(((n_hat - removed) / n_hat) * t)

    @property
    def updates_per_batch(self) -> int:
        """Optimizer updates (chunks) per batch."""
        return max((self._cropped_n_samples() - self.warmup_n_samples) // self.step_n_samples, 1)

    # --------------------------------------------------------------- LFO
    def _extract_mod_sig(self, dry, wet, mod_frames, fx=None, lfo_draws=None):
        """The LFO (B, F) that conditions the effect model: the extractor's
        output on cat(dry, wet) (on wet alone without
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
            mod_hat = stretch_corners(
                mod_hat, max_n_corners=self.max_n_corners, smooth_n_frames=self.stretch_smooth_n_frames
            )
        return mod_hat, orig - mod_hat.shape[-1]

    @torch.no_grad()
    def _prepare(self, batch, corpus=None, lfo_draws=None):
        """render -> extract -> smooth/stretch -> crop -> validity ->
        upsample.  Returns (dry, wet, mod_sr (B, 1, T'), mod_hat (B, F'),
        weights (B,))."""
        return self._condition(*render_batch(batch, self.render_cfg, corpus), lfo_draws)

    @torch.no_grad()
    def _condition(self, dry_full, wet_full, mod_frames, fx, lfo_draws=None):
        """`_prepare` from the rendered clips."""
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

    def _chunk_mod_sr(self, dry_full, wet_full, n_samples: int) -> torch.Tensor:
        """The unfrozen extractor's LFO at audio rate (B, 1, n_samples) from
        its current weights, with gradient."""
        mod_hat, _ = self._smooth_stretch(self._extract_mod_sig(dry_full, wet_full, None))
        return linear_interpolate_last_dim(mod_hat, n_samples)[:, None, :]

    def _latent(self, mod_sr: torch.Tensor, wet: torch.Tensor) -> torch.Tensor:
        """The effect model's conditioning over mod_sr's samples: the LFO,
        and after it the param model's clip latent of the cropped `wet`
        repeated over them."""
        if self.param_model is None:
            return mod_sr
        lat = self.param_model(wet)  # (B, L)
        return torch.cat([mod_sr, lat[:, :, None].expand(-1, -1, mod_sr.shape[-1])], dim=1)

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
        global batch.

        With `static_chunks` (on the card by default where the
        conditioning is fixed for the step, without data parallelism) the
        chunks run `_static_chunks`; otherwise the eager loop.

        Its spans (`utils/spans.py`): `tbptt.step` over `render`,
        `tbptt.condition` (extraction, smoothing and stretch, crop,
        validity, upsampling), `tbptt.warmup` (K3), one `tbptt.chunk` per
        update, and `tbptt.metrics`.  In the eager loop each chunk spans
        `tbptt.forward` (latent, K4, loss), `tbptt.backward` (K5) and
        `tbptt.update` (all-reduce, AdamW, schedule, detach); a static
        chunk has no inner spans, and a capture spans `tbptt.capture`
        (host only)."""
        with span("tbptt.step"):
            em = self.effect_model
            em.train()
            with torch.no_grad():
                full = render_batch(batch, self.render_cfg, corpus)
            with span("tbptt.condition"):
                dry, wet, mod_sr, _, weights = self._condition(*full, lfo_draws)
                bw, ranks = _global_weights(weights), rank_sum()
            w, s = self.warmup_n_samples, self.step_n_samples
            t = dry.shape[-1]
            n_chunks = (t - w) // s
            with span("tbptt.warmup"), torch.no_grad():
                h0 = lstm_init_state(dry.shape[0], em.n_hidden, self.device)
                _, hidden = em(dry[:, :, :w], self._latent(mod_sr[:, :, :w], wet), h0)
            if self.static_chunks and not is_distributed():
                ys = self._static_chunks(self._latent(mod_sr, wet), dry, wet, bw, hidden, n_chunks)
            else:
                ys = self._eager_chunks(full, dry, wet, mod_sr, bw, ranks, hidden, n_chunks)
            with span("tbptt.metrics"), torch.no_grad():
                _, metrics = self.losses(ys, wet[:, :, w : w + n_chunks * s], bw, ranks)
                metrics["valid_fraction"] = weights.mean()
                return reduce_metrics({k: v.detach() for k, v in metrics.items()})

    def _eager_chunks(self, full, dry, wet, mod_sr, bw, ranks, hidden, n_chunks: int) -> torch.Tensor:
        """The chunk updates one operation at a time: their outputs (B,
        C_out, n_chunks * step)."""
        em = self.effect_model
        w, s, t = self.warmup_n_samples, self.step_n_samples, dry.shape[-1]
        ys = []
        for i in range(n_chunks):
            with span("tbptt.chunk"):
                a, e = w + i * s, w + (i + 1) * s
                self.optimizer.zero_grad(set_to_none=True)
                with span("tbptt.forward"):
                    mod_c = (self._chunk_mod_sr(full[0], full[1], t) if self.trainable_lfo
                             else mod_sr)[:, :, a:e]
                    y, new_hidden = em(dry[:, :, a:e], self._latent(mod_c, wet), hidden)
                    loss, _ = self.losses(y, wet[:, :, a:e], bw, ranks)
                with span("tbptt.backward"):
                    loss.backward()
                with span("tbptt.update"):
                    all_reduce_grads(self.trained_model.parameters())
                    self._update()
                    hidden = detach_state(new_hidden)
                    ys.append(y.detach())
        return torch.cat(ys, dim=-1)

    def _static_chunks(self, lat, dry, wet, bw: BatchWeights, hidden, n_chunks: int) -> torch.Tensor:
        """The chunk updates from the static buffers of the step's shape
        (`_ChunkGraph`, filled once), each `_static_update` run through
        `graphs`; the schedule advances after each.  Returns the outputs
        (B, C_out, n_chunks * step), a view of the shape's slots."""
        if not self._static_conditioning():
            raise ValueError("static chunk updates need a conditioning fixed for the step: "
                             "no unfrozen extractor and no param model")
        b, s = dry.shape[0], self.step_n_samples
        split = (lat.shape[1], dry.shape[1], wet.shape[1])
        entry = self.graphs.entry((b, split, n_chunks, s), lambda: _ChunkGraph(
            b, split, n_chunks, s, self.effect_model.n_hidden, self.device))
        g = entry.buffers
        g.load(lat, dry, wet, self.warmup_n_samples, bw, hidden)
        for _ in range(n_chunks):
            with span("tbptt.chunk"):
                self.graphs.run(entry, lambda: self._static_update(g))
                if self.scheduler is not None:
                    self.scheduler.step()
        return g.ys.view(b, split[2], n_chunks * s)

    def _static_update(self, g: _ChunkGraph) -> None:
        """One chunk update read from `g` at its index: the chunk's
        conditioning, dry and wet audio, K4, the weighted loss, K5, the
        optimizer step; then the new (h, c) into the state slot, the output
        into its slot, and the index advanced."""
        self.optimizer.zero_grad(set_to_none=True)
        lat, dry, wet = g.inputs.index_select(2, g.index).squeeze(2).split(g.split, dim=1)
        y, hidden = self.effect_model(dry, lat, (g.state[0], g.state[1]))
        loss, _ = self.losses(y, wet, g.batch_weights())
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            torch.stack(hidden, out=g.state)
            g.ys.index_copy_(2, g.index, y.unsqueeze(2))
            g.index += 1

    def train_steps(
        self, batches: Sequence[Dict], corpus: Optional[torch.Tensor] = None,
        lfo_draws: Optional[Sequence[dict]] = None,
    ) -> Dict[str, torch.Tensor]:
        """`train_step` over each of `batches` in turn; the per-step
        metrics stacked on a leading axis (the JAX task scans the steps in
        one compiled program)."""
        per_step = [
            self.train_step(b, corpus, None if lfo_draws is None else lfo_draws[i])
            for i, b in enumerate(batches)
        ]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

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
        wet_hat, _ = em(dry[:, :, :end], self._latent(mod_sr[:, :, :end], wet), h0)
        _, metrics = self.losses(wet_hat[:, :, w:], wet[:, :, w:end], _global_weights(weights), rank_sum())
        metrics["valid_fraction"] = weights.mean()
        return reduce_metrics(metrics)
