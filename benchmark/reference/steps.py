"""Plain PyTorch training steps that the train cells' program steps are
held against: AdamW written out, the stage-1 extractor step and the stage-2
TBPTT step, each from given starting weights and the batches the benchmark
made.  They import nothing of the program.

`precision` "config" computes as the configuration states (trunk convs in
bf16, everything else float32 with TF32 off); "control" one step below
(trunk conv operands in float8 e4m3, scaled per tensor; float32 matmuls,
convs and the LSTM with TF32 on): the control that has to fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.harness import generator
from benchmark.reference import extractor, lfo_post, render
from benchmark.reference.lstm import EffectModel, npz_params


class AdamW:
    """Decoupled weight decay Adam (Loshchilov and Hutter): p -= lr * wd * p,
    then the bias-corrected Adam step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas, eps, weight_decay):
        self.p = params
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in self.p.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(self.m[k] / c1, (self.v[k] / c2).sqrt().add_(self.eps), value=-self.lr)
            p.grad = None


def set_precision(precision: str) -> None:
    tf32 = precision == "control"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def fp8_quantize(v: torch.Tensor) -> torch.Tensor:
    """v rounded to float8 e4m3 with a per-tensor scale to its range; the
    gradient passes as it is, as fp8 training passes it."""
    scale = v.detach().abs().amax().clamp(min=1e-12).float() / 448.0
    q = ((v.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(v.dtype)
    return v + (q - v).detach()


def _quant(precision: str):
    return fp8_quantize if precision == "control" else None


def _central_diff(x):
    return (x[..., 2:] - x[..., :-2]) / 2.0


def stage1_loss(y_hat: torch.Tensor, y: torch.Tensor, weights: Dict[str, float]) -> torch.Tensor:
    """l1, l1 of first and of second central differences, and mse, each a
    mean over frames then over examples, weighted and summed."""
    terms = {
        "l1": (y_hat - y).abs(),
        "fdl1": (_central_diff(y_hat) - _central_diff(y)).abs(),
        "sdl1": (_central_diff(_central_diff(y_hat)) - _central_diff(_central_diff(y))).abs(),
        "mse": (y_hat - y) ** 2,
    }
    total = torch.zeros((), device=y_hat.device)
    for name, w in weights.items():
        if w > 0:
            total = total + w * terms[name].mean(dim=-1).mean()
    return total


def _render(batches, corpus, config, traffic, n_stages=6):
    sr = config["sr"]
    return render.render_batches(batches, corpus, config["n_samples"], sr, generator.effects(traffic),
                                 generator.max_delay_samples(traffic, sr), n_stages)


def stage1(init: Dict[str, torch.Tensor], batches: List[Dict], corpus: np.ndarray,
           draws: Sequence, config: dict, traffic: dict, device, precision: str = "config") -> Dict:
    """Steps of the extractor from `init` over `batches`: each step's loss,
    the first step's gradient and the weights after the last step."""
    set_precision(precision)
    ex, s1, sr, t = config["extractor"], config["stage1"], config["sr"], config["n_samples"]
    conv_dtype = getattr(torch, config["precision"]["trunk_convs"])
    rendered = _render(batches, corpus, config, traffic, s1["phaser_n_stages"])
    params = {k: v.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)
              for k, v in init.items()}
    opt = AdamW(params, s1["lr"], s1["betas"], s1["eps"], s1["weight_decay"])
    losses, grad1 = [], None
    for k, (dry, wet, frames) in enumerate(rendered):
        x = torch.as_tensor(np.concatenate([dry, wet], axis=1), device=device)
        y_hat = extractor.forward(params, x, ex, sr, draws[k], conv_dtype, _quant(precision))
        y = torch.as_tensor(render.resample_aligned(frames, y_hat.shape[-1]), device=device)
        loss = stage1_loss(y_hat, y, s1["loss"])
        loss.backward()
        if grad1 is None:
            grad1 = {n: p.grad.detach().clone() for n, p in params.items()}
        losses.append(float(loss.detach()))
        opt.step()
    set_precision("config")
    return {"losses": losses, "grad1": grad1, "params": {n: p.detach() for n, p in params.items()}}


def _crop(x: np.ndarray, n: int) -> np.ndarray:
    pad = x.shape[-1] - n
    lo = pad // 2
    return x[..., lo: x.shape[-1] - (pad - lo)]


def stage2(ex_path: str, em_path: str, batches: List[Dict], corpus: np.ndarray, config: dict,
           traffic: dict, device, precision: str = "config") -> Dict:
    """TBPTT steps of the effect model over `batches` with the frozen
    extractor: each step's loss (weighted l1 over its chunks), the first
    update's gradient, the effect model's weights after the last step, and
    each step's share of valid LFOs."""
    set_precision(precision)
    ex, s2, sr, t = config["extractor"], config["stage2"], config["sr"], config["n_samples"]
    conv_dtype = getattr(torch, config["precision"]["trunk_convs"])
    rendered = _render(batches, corpus, config, traffic)
    ex_params = {k: v.to(device) for k, v in extractor.npz_params(ex_path).items()}
    model = EffectModel(npz_params(em_path), device)
    params = dict(model.named_parameters())
    opt = AdamW(params, s2["lr"], s2["betas"], s2["eps"], s2["weight_decay"])
    w, s = s2["warmup_n_samples"], s2["step_n_samples"]
    losses, valid_shares, grad1 = [], [], None
    for dry_full, wet_full, _ in rendered:
        with torch.no_grad():
            x = torch.as_tensor(np.concatenate([dry_full, wet_full], axis=1), device=device)
            lfo = extractor.forward(ex_params, x, ex, sr, None, conv_dtype, _quant(precision))
        lfo = lfo.float().cpu().numpy()
        n_frames = lfo.shape[-1]
        lfo = lfo_post.smooth(lfo, s2["model_smooth_n_frames"])
        if s2["should_stretch"]:
            lfo = lfo_post.stretch(lfo, s2["max_n_corners"])
        n = int((lfo.shape[-1] / n_frames) * t)
        dry, wet = _crop(dry_full, n), _crop(wet_full, n)
        wts = lfo_post.valid(lfo).astype(np.float32) if s2["discard_invalid_lfos"] else np.ones(len(lfo), np.float32)
        valid_shares.append(float(wts.mean()))
        mod = render.resample_aligned(lfo, n)[:, None]
        dry_t, wet_t, mod_t = (torch.as_tensor(a, device=device) for a in (dry, wet, mod))
        wts_t = torch.as_tensor(wts, device=device)

        def l1(y, target):
            per = (y - target).abs().reshape(y.shape[0], -1).mean(dim=-1)
            return (per * wts_t).sum() / wts_t.sum().clamp(min=1e-8)

        hid = model.lstm.hidden_size
        state = (torch.zeros(len(dry), hid, device=device), torch.zeros(len(dry), hid, device=device))
        with torch.no_grad():
            _, state = model(dry_t[:, :, :w], mod_t[:, :, :w], state)
        ys = []
        for i in range((n - w) // s):
            a, e = w + i * s, w + (i + 1) * s
            y, new_state = model(dry_t[:, :, a:e], mod_t[:, :, a:e], state)
            l1(y, wet_t[:, :, a:e]).backward()
            if grad1 is None:
                grad1 = {k: v.detach().clone() for k, v in _leaf_grads(model).items()}
            opt.step()
            state = (new_state[0].detach(), new_state[1].detach())
            ys.append(y.detach())
        losses.append(float(l1(torch.cat(ys, dim=-1), wet_t[:, :, w: w + len(ys) * s])))
    set_precision("config")
    leaves = {k: v.detach().clone() for k, v in model.leaves().items()}
    return {"losses": losses, "grad1": grad1, "params": leaves, "valid": valid_shares}


def _leaf_grads(model: EffectModel) -> Dict[str, torch.Tensor]:
    """The program's leaves' gradients from the model's."""
    gi = model.lstm.weight_ih_l0.grad
    return {"w_ih": gi[:, :2].t(), "b_gates": gi[:, 2], "w_hh": model.lstm.weight_hh_l0.grad.t(),
            "fc_kernel": model.fc_k.grad, "fc_bias": model.fc_b.grad}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def change_norms(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float((after[k].double().cpu() - before[k].double().cpu()).norm()) for k in after}


def moved_leaves(grad_norms: Dict[str, float], rule: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is at least `rule` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v >= rule * med and math.isfinite(v)]
