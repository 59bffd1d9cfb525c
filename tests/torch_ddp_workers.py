"""What the data-parallel tests run in each rank (`tests/test_torch_ddp.py`,
`parallel/dist.py::run_ranks`), and the same work in one process without a
group for the reference.  Imports torch, numpy and the port only: spawned
ranks import this module by name, and JAX stays in the test process.

Shapes are those of `tests/test_multidevice.py`: 4000-sample clips at
8 kHz, a two-layer 8-channel Spectral2DCNN, an LSTM-8 on 256-sample
chunks, a global batch of 16.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from mod_extraction_tpu_torch.data.synthetic import batch_to_torch
from mod_extraction_tpu_torch.losses.losses import _LOSS_REGISTRY, BatchWeights, WeightedLossDict
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.random_lfo import RandomLFO
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.parallel.dist import (
    all_reduce_grads,
    all_reduce_mean,
    check_replicated,
    rank_sum,
    reduce_metrics,
    shard_batch,
    to_numpy,
    world,
)
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

SR, N = 8000.0, 4000
CNN = dict(in_ch=2, n_samples=N, sr=SR, n_fft=256, hop_len=64, n_mels=32, out_channels=(8, 8),
           bin_dilations=(1, 1), temp_dilations=(1, 2), pool_size=(2, 1), freq_mask_amount=0.25,
           time_mask_amount=0.25)
LOSSES = {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}
TBPTT = dict(warmup_n_samples=256, step_n_samples=256, model_smooth_n_frames=8, should_stretch=True,
             max_n_corners=16, discard_invalid_lfos=True, loss_dict={"l1": 1.0, "esr": 0.0, "dc": 0.0})
HID = 8


def render_cfg() -> RenderConfig:
    return RenderConfig(sr=SR, n_samples=N, effects=(1, 2, 3), max_delay_samples=89)


def lfo_task(params) -> LFOExtractionTask:
    model = Spectral2DCNN(**CNN)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return LFOExtractionTask(model, render_cfg(), loss_dict=LOSSES, device="cpu", seed=3)


def tbptt_task(params) -> TBPTTEffectModelingTask:
    em = LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=HID, latent_dim=1)
    em.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return TBPTTEffectModelingTask(em, render_cfg(), lfo_model=None, device="cpu", **TBPTT)


def _rows(batch):
    rank, size, _ = world()
    return batch_to_torch(shard_batch(batch, rank, size), "cpu")


def step(kind: str, params, batch, mask_draws=None, corpus=None) -> dict:
    """One train step of `kind` ("lfo" or "tbptt") on this rank's rows of
    `batch` (all of it without a group): the metrics, the parameters after
    the update and, for TBPTT, this rank's validity-weight sum."""
    if kind == "lfo":
        task = lfo_task(params)
        c = None if corpus is None else torch.as_tensor(corpus)
        m = task.train_step(_rows(batch), c, mask_draws=mask_draws)
        extra = {}
    else:
        task = tbptt_task(params)
        local = _rows(batch)
        extra = {"weight_sum": float(task._prepare(local)[4].sum())}
        m = task.train_step(local)
    return dict(metrics={k: float(v) for k, v in m.items()},
                params=to_numpy(task.trained_model.state_dict()), **extra)


def steps(cases: dict) -> dict:
    """`step` for each of `cases` ({name: (kind, params, batch, mask_draws,
    corpus)})."""
    return {name: step(*args) for name, args in cases.items()}


def random_lfo_val(batch) -> dict:
    """The RandomLFO baseline's val metrics (its draws from the task's
    generator, the global batch's draws sliced to this rank's rows) and
    the generator's next draw, which must not depend on the rank."""
    model = RandomLFO(n_samples=N // 256 + 1, sr=SR / 256, use_shape_gt=False, use_phase_gt=True,
                      use_freq_gt=False, phase_error=0.5)
    task = LFOExtractionTask(model, render_cfg(), loss_dict=LOSSES, device="cpu", seed=5)
    m = task.val_step(_rows(batch))
    return dict(metrics={k: float(v) for k, v in m.items()},
                next_draw=float(torch.rand(1, generator=task.generator)))


def losses_and_grads(y_hat, y, weights) -> dict:
    """Every registered loss on this rank's rows of (y_hat, y), unweighted
    and weighted by `weights`: the global value (the metric the tasks
    report, `reduce_metrics`) and the gradient of this rank's rows of y_hat
    as data parallelism sees it, the rank's own gradient over the world size
    (the ranks' gradients are averaged).  Without a group: the full batch's."""
    rank, size, _ = world()
    out = {}
    for name in sorted(_LOSS_REGISTRY):
        for weighted in (False, True):
            p = torch.nn.Parameter(torch.as_tensor(shard_batch(y_hat, rank, size)).clone())
            target = torch.as_tensor(shard_batch(y, rank, size))
            w = torch.as_tensor(shard_batch(weights, rank, size)) if weighted else None
            if w is not None:  # as the tasks make it
                w = BatchWeights(w, all_reduce_mean(w.sum()))
            loss, metrics = WeightedLossDict({name: 1.0})(p, target, w, rank_sum())
            loss.backward()
            out[f"{name}/{'weighted' if weighted else 'unweighted'}"] = dict(
                value=float(reduce_metrics({"v": metrics[name].detach()})["v"]),
                grad=(p.grad / size).numpy())
    return out


def losses_without_collectives(y_hat, y, weights):
    """Rank 0 alone (the others return None at once): every loss on its
    rows with a plain weight tensor and no sum over the ranks, with every
    collective made to raise; the metrics.  A loss starts no collective of
    its own, so rank 0 can compute one while the others are elsewhere."""
    from unittest import mock

    rank, size, _ = world()
    if rank != 0:
        return None
    rows = [torch.as_tensor(shard_batch(a, rank, size)) for a in (y_hat, y, weights)]
    stop = AssertionError("a loss started a collective")
    with mock.patch.object(torch.distributed, "all_reduce", side_effect=stop), \
            mock.patch.object(torch.distributed, "broadcast", side_effect=stop):
        _, metrics = WeightedLossDict({name: 1.0 for name in _LOSS_REGISTRY})(*rows)
    return {k: float(v) for k, v in metrics.items()}


def check_replicated_detects(perturb_rank: int) -> bool:
    """Whether `check_replicated` raises on this rank when `perturb_rank`
    holds other weights than rank 0."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    if world().rank == perturb_rank:
        with torch.no_grad():
            model.bias[1] += 1e-6
    try:
        check_replicated(model.parameters())
    except RuntimeError:
        return True
    return False


def fit(config: dict, out_dir: str, resume: bool = False, max_epochs=None) -> dict:
    """`cli.fit` on the CPU; returns the trained model's weights."""
    from mod_extraction_tpu_torch import cli

    task = cli.fit(copy.deepcopy(config), out_dir=out_dir, device="cpu", resume=resume,
                   max_epochs=max_epochs)
    return to_numpy(task.trained_model.state_dict())


def sub_batched_step_raises(params, batch) -> str:
    task = lfo_task(params)
    task.sub_batch_size = 4
    try:
        task.train_step(_rows(batch))
    except NotImplementedError as e:
        return str(e)
    return ""


def environment() -> dict:
    return {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")} | {"world": tuple(world())}


def gradients_after_all_reduce(values) -> np.ndarray:
    """Each rank's gradient is its rank + 1 times `values`: after the
    all-reduce every rank holds their mean."""
    rank = world().rank
    p = torch.nn.Parameter(torch.zeros(len(values)))
    p.grad = torch.as_tensor(values, dtype=torch.float32) * (rank + 1)
    all_reduce_grads([p])
    return p.grad.numpy()
