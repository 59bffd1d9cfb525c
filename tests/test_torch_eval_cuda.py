"""The port's eval path on the card against the CPU: `cli.validate_many` on
two tiny configs, an LFO-extraction eval whose flanger renders in K1 and a
TBPTT eval whose val walk runs K3, each with a data variant and a second
checkpoint.  The same metrics within rtol 1e-3 (float32 sums in another
order, as `chip_smoke.py` holds the val steps).

Also the tiny eval configs `tests/test_torch_eval.py` holds against the JAX
package.  This file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_cuda.py
"""

import copy
import math
import os

import pytest
import torch

from mod_extraction_tpu_torch import cli as tcli
from mod_extraction_tpu_torch.models.convert import (
    lstm_state_dict_to_flax,
    spectral_2dcnn_state_dict_to_flax,
)
from mod_extraction_tpu_torch.train.checkpoints import save_weights
from test_torch_fit import N_TBPTT, SR, TINY_CNN, TINY_EXTRACTOR, tbptt_config, write_corpus

N_LFO = 4000
VAL_RTOL = 1e-3
MOD_SIG = {"rate_hz": {"min": 0.5, "max": 3.0}, "phase": {"min": 0.0, "max": 6.28318530718},
           "shapes": ["cos", "tri"], "exp": 1.0}


def lfo_eval_config(corpus: str, ckpt=None, mod_sig=None, batch: int = 4, n_val: int = 8) -> dict:
    """`configs/eval_lfo_flanger.yml` at a tiny size: the flanger module
    (rendered by K1), pinned effect parameters, a tiny Spectral2DCNN."""
    cfg = {
        "seed_everything": 7,
        "custom": {"model_name": "m", "dataset_name": "d", "cpu_batch_size": batch,
                   "cpu_val_num_examples_per_epoch": n_val},
        "data": {"class_path": "mod_extraction.data_modules.FlangerCPUDataModule", "init_args": {
            "batch_size": batch, "num_workers": 2, "train_dir": os.path.join(corpus, "train"),
            "val_dir": os.path.join(corpus, "val"), "train_num_examples_per_epoch": 0,
            "val_num_examples_per_epoch": n_val, "n_samples": N_LFO, "sr": SR, "ext": "wav",
            "silence_fraction_allowed": 0.1, "silence_threshold_energy": 1e-4, "n_retries": 10,
            "check_dataset": False, "fx_config": {
                "mod_sig": copy.deepcopy(mod_sig or MOD_SIG),
                "flanger": {"max_min_delay_ms": 1.0, "max_lfo_delay_ms": 4.0,
                            "feedback": {"min": 0.25, "max": 0.25},
                            "min_delay_width": {"min": 1.0, "max": 1.0}, "width": {"min": 1.0, "max": 1.0},
                            "depth": {"min": 1.0, "max": 1.0}, "mix": {"min": 1.0, "max": 1.0}}}}},
        "model": {"class_path": "mod_extraction.lightning.LFOExtraction", "init_args": {
            "model": {"class_path": "mod_extraction.models.Spectral2DCNN", "init_args": dict(TINY_CNN)},
            "use_dry": True, "model_smooth_n_frames": 4, "should_stretch": False,
            "loss_dict": {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}}},
    }
    if ckpt:
        cfg["ckpt_path"] = ckpt
    return cfg


def tbptt_eval_config(corpus: str, lstm_npz: str, extractor_npz: str, n_val: int = 3) -> dict:
    """`configs/eval_em_sim.yml` at a tiny size: an H 8 LSTM on a frozen
    tiny extractor over dry/wet pairs."""
    cfg = tbptt_config(corpus, lstm_npz, extractor_npz)
    cfg["ckpt_path"] = lstm_npz
    cfg["seed_everything"] = 47
    args = cfg["data"]["init_args"]
    args.update(batch_size=n_val, train_num_examples_per_epoch=0, val_num_examples_per_epoch=n_val)
    cfg["custom"].update(cpu_batch_size=n_val, cpu_val_num_examples_per_epoch=n_val)
    del cfg["custom"]["init_weights_path"]
    return cfg


def port_weights(root: str, seed: int) -> dict:
    """Seeded port-initialised `.npz` files (flax layout) of the tiny CNN,
    the tiny extractor and the H 8 LSTM, two of each kind."""
    out = {}
    for i in range(2):
        cnn = tcli.build_model({"class_path": "Spectral2DCNN", "init_args": dict(TINY_CNN)},
                               {"n_samples": N_LFO, "sr": SR}, seed + i)
        ext = tcli.build_model({"class_path": "Spectral2DCNN", "init_args": dict(TINY_EXTRACTOR)},
                               {"n_samples": N_TBPTT, "sr": SR}, seed + 10 + i)
        lstm = tcli.build_model({"class_path": "LSTMEffectModel", "init_args": {
            "in_ch": 1, "out_ch": 1, "n_hidden": 8, "latent_dim": 1}}, {}, seed + 20 + i)
        for kind, tree in (("cnn", spectral_2dcnn_state_dict_to_flax(cnn.state_dict())),
                           ("ext", spectral_2dcnn_state_dict_to_flax(ext.state_dict())),
                           ("lstm", lstm_state_dict_to_flax(lstm.state_dict()))):
            path = os.path.join(root, f"{kind}{i}.npz")
            save_weights(path, tree)
            out[f"{kind}{i}"] = path
    return out


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    write_corpus(os.path.join(root, "corpus"))
    write_corpus(os.path.join(root, "pairs"), n_files=(2, 2), dur_s=1.5, wet=True)
    return root, port_weights(root, 3)


def lfo_variants(root, w):
    corpus = os.path.join(root, "corpus")
    return [("a", lfo_eval_config(corpus, w["cnn0"])),
            ("a tri", lfo_eval_config(corpus, w["cnn0"], dict(MOD_SIG, shapes=["tri"]))),
            ("b", lfo_eval_config(corpus, w["cnn1"]))]


def tbptt_variants(root, w):
    pairs = os.path.join(root, "pairs")
    a = tbptt_eval_config(pairs, w["lstm0"], w["ext0"])
    b = copy.deepcopy(a)
    b["ckpt_path"] = w["lstm1"]
    return [("a", a), ("b", b)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lfo", "tbptt"])
def test_validate_many_on_card_matches_cpu(kind, eval_setup, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    from mod_extraction_tpu_torch.ops import fx_kernels, lstm_kernels

    root, w = eval_setup
    variants = (lfo_variants if kind == "lfo" else tbptt_variants)(root, w)
    cpu = tcli.validate_many(copy.deepcopy(variants), out_dir=str(tmp_path / "cpu"), device="cpu")
    fx_kernels.reset_launch_counts()
    lstm_kernels.reset_launch_counts()
    card = tcli.validate_many(copy.deepcopy(variants), out_dir=str(tmp_path / "card"), device="cuda")
    assert [lb for lb, _ in card] == [lb for lb, _ in cpu]
    for (lb, m_card), (_, m_cpu) in zip(card, cpu):
        assert set(m_card) == set(m_cpu)
        for k in m_cpu:
            assert math.isclose(m_card[k], m_cpu[k], rel_tol=VAL_RTOL, abs_tol=1e-6), (lb, k, m_card[k], m_cpu[k])
    if kind == "lfo":  # one K1 launch a val batch
        assert fx_kernels.LAUNCHES["flanger"] == len(variants) * 2
    else:  # one K3 walk a val batch
        assert lstm_kernels.LAUNCHES["lstm_forward"] == len(variants)
