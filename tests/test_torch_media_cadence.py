"""Media-hook cadence of the port's Trainer (mirrors
`tests/test_media_cadence.py`): the hook runs on val batch 0 of every
`media_every_n_epochs`-th epoch, epoch 0 included, and only on rank 0.
Also `custom.log_media` through `cli`: the hook for each task, matplotlib
imported only then (without it, an ImportError that names it), and a
CPU fit that writes its media on the cadence epochs."""

import os
import sys

import numpy as np
import pytest
import torch

from mod_extraction_tpu_torch import cli as tcli
from mod_extraction_tpu_torch.parallel.dist import World
from mod_extraction_tpu_torch.train import loop as tloop


class _StubLoader:
    def epoch(self, epoch):
        yield {"x": np.zeros((8, 4), np.float32)}
        yield {"x": np.ones((8, 4), np.float32)}


class _StubTask:
    device = torch.device("cpu")

    def val_step(self, batch, corpus):
        return {"loss": torch.tensor(0.25)}


class _StubDM:
    def corpus_payload(self):
        return None


def _trainer(tmp_path, every):
    calls = []
    t = tloop.Trainer(
        _StubTask(), _StubDM(), out_dir=str(tmp_path), run_name="media_cadence",
        media_callback=lambda tr, batch, epoch: calls.append((epoch, float(batch["x"].sum()))),
        media_every_n_epochs=every,
    )
    return t, calls


def test_media_only_on_cadence_epochs(tmp_path):
    trainer, calls = _trainer(tmp_path, every=10)
    for epoch in range(12):
        m = trainer.validate(_StubLoader(), epoch)
        assert m == {"loss": 0.25}
    assert calls == [(0, 0.0), (10, 0.0)]  # val batch 0 (all zeros)


def test_media_every_epoch_when_one(tmp_path):
    trainer, calls = _trainer(tmp_path, every=1)
    for epoch in range(3):
        trainer.validate(_StubLoader(), epoch)
    assert [e for e, _ in calls] == [0, 1, 2]


def test_media_only_on_rank_zero(tmp_path, monkeypatch):
    monkeypatch.setattr(tloop, "world", lambda: World(1, 2, 1))
    trainer, calls = _trainer(tmp_path, every=1)
    for epoch in range(3):
        trainer.validate(_StubLoader(), epoch)
    assert calls == []


class _Run:
    def __init__(self, task, log_media=True):
        self.raw = {"custom": {"log_media": log_media}}
        self.task = task


def test_log_media_picks_the_tasks_hook():
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    assert tcli._media_callback_for(_Run(object(), log_media=False)) is None
    lfo = tcli._media_callback_for(_Run(object()))
    em = tcli._media_callback_for(_Run(TBPTTEffectModelingTask.__new__(TBPTTEffectModelingTask)))
    assert "lfo_media_callback" in lfo.__qualname__ and "em_media_callback" in em.__qualname__


def test_log_media_without_matplotlib_names_it(monkeypatch):
    import mod_extraction_tpu_torch.utils as utils

    monkeypatch.delitem(sys.modules, "mod_extraction_tpu_torch.utils.plotting", raising=False)
    monkeypatch.delattr(utils, "plotting", raising=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tcli._media_callback_for(_Run(object()))


def test_fit_with_log_media_writes_val_batch_0_on_the_cadence(tmp_path):
    """`custom.log_media: true`, `media_every_n_epochs: 2` over three
    epochs: media of epochs 0 and 2, for the first four examples."""
    from test_torch_fit import lfo_config, write_corpus

    write_corpus(str(tmp_path / "corpus"))
    cfg = lfo_config(str(tmp_path / "corpus"), None, log_media=True, media_every_n_epochs=2)
    del cfg["custom"]["init_weights_path"]
    cfg["optimizer"].pop("lr_schedule")
    torch.set_num_threads(1)
    tcli.fit(cfg, out_dir=str(tmp_path / "out"), device="cpu", max_epochs=3)
    media = tmp_path / "out" / "m__lfo_media"
    assert sorted(os.listdir(media)) == ["ep0", "ep2"]
    assert sorted(os.listdir(media / "ep2")) == sorted(f"{i}_{k}.png" for i in range(4) for k in ("mod_sig", "wet"))
