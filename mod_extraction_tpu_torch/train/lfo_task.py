"""LFO-extraction task: render -> extractor -> losses -> AdamW (port of
`mod_extraction_tpu/train/lfo_task.py`).

Step semantics (the JAX `_loss_fn`):
* the batch is rendered on its device (no gradient flows through it)
* model input = cat(dry, wet) when use_dry else wet
* the GT mod_sig is resampled (align_corners=True) to the model's frames
* optional output smoothing with a center crop of the target
* optional `stretch_corners` post-processing
* weighted loss dict, zero-weight metrics still logged
* `sub_batch_size` microbatching: gradients and metrics averaged over the
  sub-batches, each with its own SpecAugment draws, then one AdamW step
* the RandomLFO baseline in place of a model (no parameters, `val_step` only)
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from mod_extraction_tpu_torch.losses.losses import BatchWeights, WeightedLossDict
from mod_extraction_tpu_torch.models.random_lfo import RandomLFO
from mod_extraction_tpu_torch.ops.corners import smoothen, stretch_corners
from mod_extraction_tpu_torch.parallel.dist import (
    all_reduce_grads,
    rank_sum,
    reduce_metrics,
    sub_batch_shares,
    world,
)
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
from mod_extraction_tpu_torch.utils.device import resolve_device, set_float32_numerics
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim
from mod_extraction_tpu_torch.utils.spans import span


def center_crop_last(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-1] == size:
        return x
    padding = x.shape[-1] - size
    pad_l = padding // 2
    pad_r = padding - pad_l
    return x[..., pad_l : x.shape[-1] - pad_r]


def adamw(params, lr: float = 1e-4) -> torch.optim.AdamW:
    """The reference optimizer: AdamW, betas (0.8, 0.99), eps 1e-8 and
    weight decay 1e-4 — `optax.adamw`'s default decay, which the JAX task
    uses (torch's own default, 1e-2, would diverge from it)."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.8, 0.99), eps=1e-8, weight_decay=1e-4
    )


# builds the optimizer over a task's trainable parameters (`cli.py::
# build_optimizer` returns one from a config)
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def make_optimizer(
    params, optimizer: Optional[OptimizerFactory], lr_schedule: Optional[Callable[[int], float]]
):
    """(optimizer, scheduler) over `params`: `optimizer` (the tasks' own
    default `adamw` when None), and a `LambdaLR` that sets its lr to
    `lr_schedule(u)` before update u, counted from 0 as optax's schedules
    count updates; the task advances it once per optimizer update.  The
    decoupled weight decay of AdamW is multiplied by the scheduled lr, as
    optax's `adamw` multiplies it."""
    opt = (optimizer or adamw)(params)
    if lr_schedule is None:
        return opt, None
    base = opt.param_groups[0]["lr"]
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda u: lr_schedule(u) / base)
    return opt, scheduler


class TrainableTask:
    """What the Trainer and the checkpoints need of a task that trains:
    `trained_model`, `optimizer`, `scheduler` and `generator` (the host
    generator of the task's random draws)."""

    trained_model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    generator: torch.Generator

    def _update(self) -> None:
        """One optimizer update, then the schedule's advance."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> Dict:
        return {
            "model": self.trained_model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: Dict) -> None:
        self.trained_model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])


def _slice_batch(batch, sl: slice):
    """The examples `sl` of a (nested) batch dict."""
    if isinstance(batch, dict):
        return {k: _slice_batch(v, sl) for k, v in batch.items()}
    return batch[sl]


def _batch_size(batch) -> int:
    while isinstance(batch, dict):
        batch = next(iter(batch.values()))
    return batch.shape[0]


class LFOExtractionTask(TrainableTask):
    """Owns the extractor (or the RandomLFO baseline) and its optimizer;
    `train_step` / `val_step` take a batch dict of tensors on the task's
    device.  `optimizer` builds the optimizer over the model's parameters
    (the default `adamw` when None); `lr_schedule` maps an update count to
    the lr (see `make_optimizer`)."""

    def __init__(
        self,
        model: torch.nn.Module | RandomLFO,
        render_cfg: RenderConfig,
        optimizer: Optional[OptimizerFactory] = None,
        lr_schedule: Optional[Callable[[int], float]] = None,
        use_dry: bool = True,
        model_smooth_n_frames: int = 4,
        should_stretch: bool = False,
        max_n_corners: int = 16,
        stretch_smooth_n_frames: int = 0,
        sub_batch_size: Optional[int] = None,
        loss_dict: Optional[Dict[str, float]] = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_float32_numerics()
        self.is_random_lfo = isinstance(model, RandomLFO)
        # the RandomLFO baseline is the only task with no trainable parameters
        self.has_params = not self.is_random_lfo
        self.model = model if self.is_random_lfo else model.to(self.device)
        self.render_cfg = render_cfg
        if self.has_params:
            self.trained_model = self.model
            self.optimizer, self.scheduler = make_optimizer(
                self.model.parameters(), optimizer, lr_schedule
            )
        self.use_dry = use_dry
        self.model_smooth_n_frames = model_smooth_n_frames
        self.should_stretch = should_stretch
        self.max_n_corners = max_n_corners
        self.stretch_smooth_n_frames = stretch_smooth_n_frames
        self.sub_batch_size = sub_batch_size
        self.losses = WeightedLossDict(loss_dict)
        # SpecAugment's four uniforms per (sub-)batch and the RandomLFO
        # baseline's draws come from this host generator
        self.mask_generator = self.generator = torch.Generator().manual_seed(seed)

    def _extract(self, dry, wet, fx, mask_draws, lfo_draws=None):
        """(mod_hat (B, F), the extractor's latent (B, C, F), None for the
        RandomLFO baseline)."""
        if self.is_random_lfo:
            w = world()
            mod_hat = self.model(
                self.mask_generator, wet.shape[0],
                {"shape": fx["shape"], "phase": fx["phase"], "rate_hz": fx["rate_hz"]},
                draws=lfo_draws, device=self.device, shard=(w.rank, w.size),
            )
            return mod_hat[:, 0, :], None
        model_in = torch.cat([dry, wet], dim=1) if self.use_dry else wet
        mod_hat, latent = self.model(model_in, mask_draws=mask_draws)
        return mod_hat[:, 0, :], latent

    def _postprocess(self, mod_hat, mod_gt):
        """smooth + stretch + target resampling and cropping."""
        mod_gt = linear_interpolate_last_dim(mod_gt, mod_hat.shape[-1])
        if self.model_smooth_n_frames > 1:
            mod_hat = smoothen(mod_hat, self.model_smooth_n_frames)
            mod_gt = center_crop_last(mod_gt, mod_hat.shape[-1])
        if self.should_stretch:
            mod_hat = stretch_corners(
                mod_hat,
                max_n_corners=self.max_n_corners,
                smooth_n_frames=self.stretch_smooth_n_frames,
            )
            if self.stretch_smooth_n_frames > 1:
                mod_gt = center_crop_last(mod_gt, mod_hat.shape[-1])
        return mod_hat, mod_gt

    def _loss(self, batch, corpus, mask_draws, lfo_draws=None, weights=None):
        with torch.no_grad():
            dry, wet, mod_frames, fx = render_batch(batch, self.render_cfg, corpus)
        with span("lfo.forward"):
            mod_hat, _ = self._extract(dry, wet, fx, mask_draws, lfo_draws)
            mod_hat, mod_gt = self._postprocess(mod_hat, mod_frames)
            return self.losses(mod_hat, mod_gt, weights, sum_over_ranks=rank_sum())

    def train_step(
        self,
        batch: Dict,
        corpus: Optional[torch.Tensor] = None,
        mask_draws: Optional[Sequence[float]] = None,
    ) -> Dict[str, torch.Tensor]:
        """One AdamW step.  `mask_draws` overrides the SpecAugment uniforms
        (tests feed the numbers JAX drew): four numbers, or with
        `sub_batch_size` one row of four per sub-batch.

        Under data parallelism (`parallel/dist.py`) `batch` is this rank's
        rows (with `sub_batch_size`, its shares of the sub-batches:
        `shard_batch(..., sub_batch_size=)`): every rank draws the same
        SpecAugment numbers, the gradients are averaged over the ranks
        before the update, and the metrics are those of the global batch.

        Its spans (`utils/spans.py`): `lfo.step` over `render`,
        `lfo.forward` (extraction, post-processing, losses), `lfo.backward`
        and `lfo.update` (all-reduce, AdamW, schedule); the sub-batched
        step has the first three per sub-batch."""
        assert self.has_params, "the RandomLFO baseline has no parameters to train"
        with span("lfo.step"):
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            if self.sub_batch_size is not None:
                metrics = self._backward_subbatched(batch, corpus, mask_draws)
            else:
                if mask_draws is None:
                    mask_draws = torch.rand(4, generator=self.mask_generator)
                loss, metrics = self._loss(batch, corpus, mask_draws)
                with span("lfo.backward"):
                    loss.backward()
            with span("lfo.update"):
                all_reduce_grads(self.model.parameters())
                self._update()
            return reduce_metrics({k: v.detach() for k, v in metrics.items()})

    def _backward_subbatched(self, batch, corpus, mask_draws):
        """Gradients (left in `.grad`) and metrics averaged over the
        sub-batches, each with its own SpecAugment draws.

        Under a world of W > 1, `batch` holds this rank's share of each
        global sub-batch (`parallel/dist.py::sub_batch_shares`; B / W rows
        in all).  A share's losses are weighted sums over the sub-batch's
        size over W (`BatchWeights`), so their mean over the ranks is the
        sub-batch's mean whatever the shares' sizes, and the gradient
        all-reduce after the last sub-batch averages them.  A rank skips a
        sub-batch it holds no row of: no loss starts a collective but
        `mrstft`, whose 2048-point FFT is longer than a stage-1 LFO."""
        sub = self.sub_batch_size
        rank, size, _ = world()
        b = _batch_size(batch) * size
        assert b % sub == 0 and b >= sub
        n = b // sub
        if mask_draws is None:
            mask_draws = torch.rand(n, 4, generator=self.mask_generator)
        mean, start = None, 0
        for i, (lo, hi) in enumerate(sub_batch_shares(b, sub, rank, size)):
            if hi == lo:
                continue
            sb = _slice_batch(batch, slice(start, start + hi - lo))
            start += hi - lo
            weights = None
            if size > 1:
                ones = torch.ones(hi - lo, device=self.device)
                weights = BatchWeights(ones, torch.tensor(sub / size, device=self.device))
            loss, metrics = self._loss(sb, corpus, mask_draws[i], weights=weights)
            with span("lfo.backward"):
                (loss / n).backward()  # .grad accumulates the mean gradient
            metrics = {k: v.detach() / n for k, v in metrics.items()}
            mean = metrics if mean is None else {k: mean[k] + v for k, v in metrics.items()}
        return mean

    def train_steps(
        self,
        batches: Sequence[Dict],
        corpus: Optional[torch.Tensor] = None,
        mask_draws: Optional[Sequence] = None,
    ) -> Dict[str, torch.Tensor]:
        """Several optimizer steps in one call: `batches` holds one batch
        per step; returns the per-step metrics stacked on a leading axis.
        The JAX task scans the steps in one compiled program; here it is a
        Python loop over `train_step`."""
        per_step: List[Dict[str, torch.Tensor]] = [
            self.train_step(b, corpus, None if mask_draws is None else mask_draws[i])
            for i, b in enumerate(batches)
        ]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    @torch.no_grad()
    def val_step(
        self,
        batch: Dict,
        corpus: Optional[torch.Tensor] = None,
        lfo_draws: Optional[dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Extraction and metrics, without SpecAugment or an update.
        `lfo_draws` feeds the RandomLFO baseline's random numbers (tests)."""
        if self.has_params:
            self.model.eval()
        _, metrics = self._loss(batch, corpus, None, lfo_draws)
        return reduce_metrics(metrics)
