"""LFO-extraction task: render -> extractor -> losses -> AdamW (port of
`mod_extraction_tpu/train/lfo_task.py`).

Step semantics (the JAX `_loss_fn`):
* the batch is rendered on its device (no gradient flows through it)
* model input = cat(dry, wet) when use_dry else wet
* the GT mod_sig is resampled (align_corners=True) to the model's frames
* optional output smoothing with a center crop of the target
* weighted loss dict, zero-weight metrics still logged
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from mod_extraction_tpu_torch.losses.losses import WeightedLossDict
from mod_extraction_tpu_torch.ops.corners import smoothen
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
from mod_extraction_tpu_torch.utils.device import resolve_device, set_float32_numerics
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim


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


class LFOExtractionTask:
    """Owns the extractor and its optimizer; `train_step` / `val_step`
    take a batch dict of tensors on the task's device."""

    def __init__(
        self,
        model: torch.nn.Module,
        render_cfg: RenderConfig,
        optimizer: Optional[torch.optim.Optimizer] = None,
        use_dry: bool = True,
        model_smooth_n_frames: int = 4,
        loss_dict: Optional[Dict[str, float]] = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_float32_numerics()
        self.model = model.to(self.device)
        self.render_cfg = render_cfg
        self.optimizer = optimizer or adamw(self.model.parameters())
        self.use_dry = use_dry
        self.model_smooth_n_frames = model_smooth_n_frames
        self.losses = WeightedLossDict(loss_dict)
        # SpecAugment's four uniforms per step come from this host generator
        self.mask_generator = torch.Generator().manual_seed(seed)

    def _postprocess(self, mod_hat, mod_gt):
        """smooth + target resampling and cropping."""
        mod_gt = linear_interpolate_last_dim(mod_gt, mod_hat.shape[-1])
        if self.model_smooth_n_frames > 1:
            mod_hat = smoothen(mod_hat, self.model_smooth_n_frames)
            mod_gt = center_crop_last(mod_gt, mod_hat.shape[-1])
        return mod_hat, mod_gt

    def _loss(self, batch, corpus, mask_draws):
        with torch.no_grad():
            dry, wet, mod_frames, _ = render_batch(batch, self.render_cfg, corpus)
            model_in = torch.cat([dry, wet], dim=1) if self.use_dry else wet
        mod_hat, _ = self.model(model_in, mask_draws=mask_draws)
        mod_hat, mod_gt = self._postprocess(mod_hat[:, 0, :], mod_frames)
        return self.losses(mod_hat, mod_gt)

    def train_step(
        self,
        batch: Dict,
        corpus: Optional[torch.Tensor] = None,
        mask_draws: Optional[Sequence[float]] = None,
    ) -> Dict[str, torch.Tensor]:
        """One AdamW step.  `mask_draws` overrides the four SpecAugment
        uniforms (tests feed the numbers JAX drew)."""
        if mask_draws is None:
            mask_draws = torch.rand(4, generator=self.mask_generator)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._loss(batch, corpus, mask_draws)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def val_step(
        self, batch: Dict, corpus: Optional[torch.Tensor] = None
    ) -> Dict[str, torch.Tensor]:
        """Extraction and metrics, without SpecAugment or an update."""
        self.model.eval()
        _, metrics = self._loss(batch, corpus, None)
        return metrics
