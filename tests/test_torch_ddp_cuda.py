"""Data parallelism and the resampler on the card (`cuda`: skipped without
one).  No JAX here, so on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_ddp_cuda.py

* one LFO train step (on-device render through K1 and K2) in a rank of a
  real one-rank NCCL group equals the step with no group bit for bit;
* `dryrun_multichip(2)` on the card by default (two gloo ranks sharing one
  card where there is one, NCCL where there are two);
* the resampler on the card within 1e-6 max-abs of its CPU run (float32
  dot products summed in another order)."""

import numpy as np
import pytest
import torch

from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.ops.resample import resample
from mod_extraction_tpu_torch.parallel.dist import run_ranks, to_numpy
from mod_extraction_tpu_torch.parallel.dryrun import dryrun_multichip
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
from mod_extraction_tpu_torch.train.render import RenderConfig

SR, N = 8000.0, 4000


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")


def lfo_step() -> dict:
    """One LFO step on the card from seeded weights and batch."""
    torch.backends.cudnn.deterministic = True
    model = Spectral2DCNN(in_ch=2, n_samples=N, sr=SR, n_fft=256, hop_len=64, n_mels=32, out_channels=(8, 8),
                          temp_dilations=(1, 2), pool_size=(2, 1), freq_mask_amount=0.25,
                          time_mask_amount=0.25, seed=1)
    cfg = RenderConfig(sr=SR, n_samples=N, effects=(1, 2, 3), max_delay_samples=89)
    task = LFOExtractionTask(model, cfg, loss_dict={"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0}, device="cuda")
    m = task.train_step(batch_to_torch(make_synthetic_batch(0, 8, N, SR, "flanger"), task.device))
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": to_numpy(task.model.state_dict())}


@pytest.mark.cuda
def test_one_rank_nccl_step_is_the_no_group_step():
    _need_card()
    (ranked,) = run_ranks(lfo_step, 1, device="cuda", timeout=120.0)
    alone = lfo_step()
    assert ranked["metrics"] == alone["metrics"]
    for k, v in alone["params"].items():
        np.testing.assert_array_equal(ranked["params"][k], v, err_msg=k)


@pytest.mark.cuda
def test_dryrun_multichip_runs_on_the_card(capsys):
    _need_card()
    results = dryrun_multichip(2, timeout=300.0)
    out = capsys.readouterr().out
    assert out.count("[dryrun]") == 3 and ("2 cards (NCCL)" in out or "2 gloo ranks on 1 card" in out)
    for name in ("lfo", "lfo_device_corpus", "tbptt"):
        assert results[0][name] == results[1][name]
        assert all(np.isfinite(v) for v in results[0][name].values())


@pytest.mark.cuda
@pytest.mark.parametrize("orig,new", [(44100, 48000), (48000, 44100), (48000, 16000)])
def test_resample_on_the_card_is_the_cpu_run(orig, new):
    _need_card()
    x = (0.5 * np.random.default_rng(0).standard_normal((2, orig))).astype(np.float32)
    card = resample(x, orig, new, device="cuda")
    assert card.device.type == "cuda"
    cpu = resample(x, orig, new, device="cpu")
    assert card.shape == cpu.shape
    assert float((card.cpu() - cpu).abs().max()) <= 1e-6
