"""One data-parallel step of each training path at tiny shapes (the port's
counterpart of `__graft_entry__.py::dryrun_multichip`).

    python -m mod_extraction_tpu_torch.parallel.dryrun [n_ranks] [--device cpu]

`dryrun_multichip(n)` spawns n ranks (`parallel/dist.py::run_ranks`) on the
card unless the caller asks for the CPU: NCCL, one card a rank, when the
host has n cards, else n gloo ranks over CUDA tensors sharing its cards
(NCCL refuses two ranks on one card); without a card it raises.  With
`device="cpu"`, n gloo ranks on the CPU.  Each rank
runs one step of the LFO-extraction task (on-device flanger/phaser/tremolo
render, extractor forward and backward, gradient all-reduce, AdamW), one of
the same task on a device corpus (the corpus whole on every rank, its
offsets sharded with the batch), and one TBPTT step of an LSTM-16 on the
ground-truth LFO, each on its rows of one global batch of 2n, and returns
the global metrics.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from mod_extraction_tpu_torch.parallel.dist import put_replicated, run_ranks, shard_batch, world
from mod_extraction_tpu_torch.utils.device import resolve_device

N_SAMPLES, SR = 8000, 8000.0


def _steps(device: str) -> Dict[str, Dict[str, float]]:
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import RenderConfig
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    rank, size, _ = world()
    render_cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(1, 2, 3), max_delay_samples=89)
    model = Spectral2DCNN(
        in_ch=2, n_samples=N_SAMPLES, sr=SR, n_fft=256, hop_len=64, n_mels=32, out_channels=(8, 8),
        bin_dilations=(1, 1), temp_dilations=(1, 2), pool_size=(2, 1), freq_mask_amount=0.25,
        time_mask_amount=0.25,
    )
    task = LFOExtractionTask(model, render_cfg, loss_dict={"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0},
                             device=device)
    batch = make_synthetic_batch(0, 2 * size, N_SAMPLES, SR, "flanger")
    out = {}

    def scalars(m):
        return {k: float(v) for k, v in m.items()}

    out["lfo"] = scalars(task.train_step(batch_to_torch(shard_batch(batch, rank, size), task.device)))

    dry = np.asarray(batch["dry"])  # (B, 1, T)
    corpus = put_replicated(np.clip(dry.reshape(-1) * 32768.0, -32768, 32767).astype(np.int16), task.device)
    corpus_batch = {
        "dry_idx": np.arange(2 * size, dtype=np.int32) * N_SAMPLES,
        "dry_gain": np.ones(2 * size, np.float32),
        "mod_sig": batch["mod_sig"],
        "fx": batch["fx"],
    }
    local = batch_to_torch(shard_batch(corpus_batch, rank, size), task.device)
    out["lfo_device_corpus"] = scalars(task.train_step(local, corpus))

    tb_task = TBPTTEffectModelingTask(
        LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=16, latent_dim=1), render_cfg,
        warmup_n_samples=256, step_n_samples=256, lfo_model=None, model_smooth_n_frames=8,
        should_stretch=True, device=device,
    )
    out["tbptt"] = scalars(tb_task.train_step(batch_to_torch(shard_batch(batch, rank, size), tb_task.device)))
    return out


def dryrun_multichip(n_ranks: int, device: str = "cuda", timeout: float = 300.0) -> List[Dict[str, Dict[str, float]]]:
    """Runs the three steps on `n_ranks` ranks and prints rank 0's global
    metrics; returns every rank's (they agree: the metrics are all-reduced)."""
    if resolve_device(device).type == "cuda":  # raises without a card
        cards = torch.cuda.device_count()
        if cards >= n_ranks:
            backend, local_ranks, where = None, list(range(n_ranks)), f"{n_ranks} cards (NCCL)"
        else:
            backend, local_ranks = "gloo", [r % cards for r in range(n_ranks)]
            where = f"{n_ranks} gloo ranks on {cards} card{'s' if cards > 1 else ''}"
        device = "cuda"
    else:
        backend, local_ranks, where = None, None, f"{n_ranks} CPU ranks (gloo)"
    results = run_ranks(_steps, n_ranks, args=(device,), device=device, backend=backend, local_ranks=local_ranks,
                        timeout=timeout)
    for name, label in (("lfo", "LFO-extraction step"), ("lfo_device_corpus", "LFO-extraction device-corpus step"),
                        ("tbptt", "TBPTT step")):
        print(f"[dryrun] {label} OK on {where}:", results[0][name])
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="One data-parallel step of each training path at tiny shapes.")
    parser.add_argument("n_ranks", type=int, nargs="?", default=None,
                        help="ranks (default: the cards on this host, at least 2)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    n = args.n_ranks or max(2, torch.cuda.device_count() if args.device == "cuda" else 0)
    dryrun_multichip(n, device=args.device)
