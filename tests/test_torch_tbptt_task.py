"""One stage-2 `val_step` and one `train_step` of the port against the JAX
`TBPTTEffectModelingTask` on the CPU (its scan path), at a short clip, a
few chunks and an LSTM-16, for both conditionings: the ground-truth LFO
(`lfo_model=None`, corners stretched, invalid LFOs weighted out) and a
tiny frozen Spectral2DCNN whose JAX weights are carried across (the LFO of
a randomly initialised extractor fails every validity rule, so that case
keeps every example: `discard_invalid_lfos=False`).  Flanger-rendered
synthetic batches, the same initial LSTM weights, the same loss dict and
optimizer settings.

Tolerances: validity weights exact; the stretched LFO 1e-5 max-abs;
metrics rtol 1e-4 (float32, reordered sums through render, extractor and
recurrence); LSTM parameters after the
train step 2e-5 max-abs (each AdamW step moves a weight by up to about lr
= 1e-4 whatever its gradient's size, so a gradient that is nearly zero may
move its weight differently by a fraction of lr; over the chunks these
stay well below 2e-5 here).  Also pins `updates_per_batch` and the cropped
length at the shipped configuration (83 and 86410)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mod_extraction_tpu.models import LSTMEffectModel as JLSTM
from mod_extraction_tpu.models import Spectral2DCNN as JSpectral2DCNN
from mod_extraction_tpu.train.render import RenderConfig as JRenderConfig
from mod_extraction_tpu.train.tbptt_task import TBPTTEffectModelingTask as JTask
from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, flax_to_state_dict
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

SR, N, HID, CHUNK = 8000.0, 8000, 16, 512
TINY = dict(
    in_ch=2, n_samples=N, sr=SR, n_fft=256, hop_len=64, n_mels=16,
    out_channels=(4, 4), bin_dilations=(1, 1), temp_dilations=(1, 2), pool_size=(2, 1),
)
RENDER = dict(sr=SR, n_samples=N, effects=(2,), max_delay_samples=89)
TASK = dict(
    warmup_n_samples=CHUNK, step_n_samples=CHUNK, model_smooth_n_frames=8,
    should_stretch=True, max_n_corners=16, loss_dict={"l1": 1.0, "esr": 0.0, "dc": 0.0},
)
METRICS = {"l1", "esr", "dc", "loss", "valid_fraction"}


def _tasks(with_extractor: bool):
    j_lfo = j_lfo_params = t_lfo = None
    if with_extractor:
        j_lfo = JSpectral2DCNN(**TINY)
        j_lfo_params = j_lfo.init(jax.random.PRNGKey(2), jnp.zeros((1, 2, N)))
        t_lfo = Spectral2DCNN(**TINY)
        t_lfo.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, j_lfo_params)))
    j_task = JTask(
        effect_model=JLSTM(in_ch=1, out_ch=1, n_hidden=HID, latent_dim=1),
        render_cfg=JRenderConfig(**RENDER), lfo_model=j_lfo, lfo_params=j_lfo_params,
        optimizer=optax.adamw(1e-4, b1=0.8, b2=0.99), lstm_impl="scan",
        discard_invalid_lfos=not with_extractor, **TASK,
    )
    state = j_task.init_state(jax.random.PRNGKey(1))
    params0 = jax.tree.map(np.asarray, state.params)
    em = LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=HID, latent_dim=1)
    em.load_state_dict(flax_lstm_to_state_dict(params0))
    t_task = TBPTTEffectModelingTask(
        em, RenderConfig(**RENDER), lfo_model=t_lfo, device="cpu",
        discard_invalid_lfos=not with_extractor, **TASK,
    )
    return j_task, state, t_task


def _assert_metrics_close(mt, mj):
    assert set(mt) == set(mj) == METRICS
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("with_extractor", [False, True], ids=["gt_lfo", "frozen_extractor"])
def test_val_and_train_step_match_jax(with_extractor):
    j_task, state, t_task = _tasks(with_extractor)
    assert t_task.updates_per_batch == j_task.updates_per_batch
    np_batch = make_synthetic_batch(3, 6, N, SR, "flanger")
    j_batch = jax.tree.map(jnp.asarray, np_batch)
    key = jax.random.PRNGKey(0)

    t_batch = batch_to_torch(np_batch, "cpu")
    prep_t = t_task._prepare(t_batch)
    prep_j = j_task._prepare(j_batch, key)
    np.testing.assert_allclose(prep_t[3].numpy(), np.asarray(prep_j[3]), rtol=0, atol=1e-5)
    weights_t = prep_t[4]
    np.testing.assert_array_equal(weights_t.numpy(), np.asarray(prep_j[5]))
    if not with_extractor:
        assert 0 < float(weights_t.sum()) < len(weights_t)  # both kinds of example

    _assert_metrics_close(t_task.val_step(t_batch), j_task.val_step(state.params, j_batch, key))

    new_state, mj = j_task.train_step(state, j_batch, key)
    mt = t_task.train_step(t_batch)
    _assert_metrics_close(mt, mj)
    ref = flax_lstm_to_state_dict(jax.tree.map(np.asarray, new_state.params))
    for k, v in t_task.effect_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=2e-5, err_msg=k)


def test_shipped_config_geometry():
    """configs/train_em_sim_flanger_r7.yml with the r7 extractor: a 2 s
    clip at 44.1 kHz, 345 extractor frames less 7 by smoothing, keeps
    86410 samples and runs 83 updates of 1024 after a 1024 warm-up."""
    render = dict(sr=44100.0, n_samples=88200, effects=(2,), max_delay_samples=485)
    kw = dict(warmup_n_samples=1024, step_n_samples=1024, model_smooth_n_frames=8)
    paper = dict(in_ch=2, n_samples=88200, sr=44100.0, out_channels=(4,), n_mels=16)
    j_task = JTask(
        effect_model=JLSTM(n_hidden=64), render_cfg=JRenderConfig(**render),
        lfo_model=JSpectral2DCNN(**paper), **kw,
    )
    t_task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=64), RenderConfig(**render),
        lfo_model=Spectral2DCNN(**paper), device="cpu", **kw,
    )
    assert t_task._cropped_n_samples() == j_task._cropped_n_samples() == 86410
    assert t_task.updates_per_batch == j_task.updates_per_batch == 83
    gt = TBPTTEffectModelingTask(LSTMEffectModel(n_hidden=64), RenderConfig(**render), device="cpu", **kw)
    j_gt = JTask(effect_model=JLSTM(n_hidden=64), render_cfg=JRenderConfig(**render), **kw)
    assert gt.updates_per_batch == j_gt.updates_per_batch


@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
def test_random_lfo_conditioning_matches_jax(anchored):
    """A RandomLFO baseline as `lfo_model`: the conditioning LFO is drawn,
    not extracted.  The JAX task hands its step key straight to the
    baseline, which splits it in three (phase, frequency, shape); the port
    is fed those draws.  The prepared LFO 1e-5, weights exact, `val_step`
    metrics rtol 1e-4, the LSTM after a `train_step` 2e-5, as above."""
    from mod_extraction_tpu.models.random_lfo import RandomLFO as JRandomLFO
    from mod_extraction_tpu_torch.models.random_lfo import RandomLFO

    n_frames = RenderConfig(**RENDER).n_mod_frames
    shapes = ("cos", "tri", "rect_cos", "inv_rect_cos")
    cfg = dict(n_samples=n_frames, sr=n_frames / (N / SR), use_shape_gt=anchored,
               use_phase_gt=anchored, use_freq_gt=anchored, shapes=shapes,
               freq_min=0.5, freq_max=3.0, phase_error=0.25, freq_error=0.1)
    j_task = JTask(
        effect_model=JLSTM(in_ch=1, out_ch=1, n_hidden=HID, latent_dim=1),
        render_cfg=JRenderConfig(**RENDER), lfo_model=JRandomLFO(**cfg),
        optimizer=optax.adamw(1e-4, b1=0.8, b2=0.99), lstm_impl="scan",
        discard_invalid_lfos=True, **TASK,
    )
    state = j_task.init_state(jax.random.PRNGKey(1))
    em = LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=HID, latent_dim=1)
    em.load_state_dict(flax_lstm_to_state_dict(jax.tree.map(np.asarray, state.params)))
    t_task = TBPTTEffectModelingTask(
        em, RenderConfig(**RENDER), lfo_model=RandomLFO(**cfg), device="cpu",
        discard_invalid_lfos=True, **TASK,
    )
    assert t_task.is_random_lfo and t_task.updates_per_batch == j_task.updates_per_batch
    assert t_task._cropped_n_samples() == j_task._cropped_n_samples()

    np_batch = make_synthetic_batch(3, 6, N, SR, "flanger")
    j_batch = jax.tree.map(jnp.asarray, np_batch)
    t_batch = batch_to_torch(np_batch, "cpu")
    key = jax.random.PRNGKey(7)
    k_phase, k_freq, k_shape = jax.random.split(key, 3)
    draws = {
        "phase": np.array(jax.random.uniform(k_phase, (6,))),
        "freq": np.array(jax.random.uniform(k_freq, (6,))),
        "shape": np.array(jax.random.randint(k_shape, (6,), 0, len(shapes))),
    }
    prep_t = t_task._prepare(t_batch, lfo_draws=draws)
    prep_j = j_task._prepare(j_batch, key)
    np.testing.assert_allclose(prep_t[3].numpy(), np.asarray(prep_j[3]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(prep_t[4].numpy(), np.asarray(prep_j[5]))
    assert float(prep_t[4].sum()) > 0

    _assert_metrics_close(t_task.val_step(t_batch, lfo_draws=draws), j_task.val_step(state.params, j_batch, key))
    new_state, mj = j_task.train_step(state, j_batch, key)
    _assert_metrics_close(t_task.train_step(t_batch, lfo_draws=draws), mj)
    ref = flax_lstm_to_state_dict(jax.tree.map(np.asarray, new_state.params))
    for k, v in t_task.effect_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=2e-5, err_msg=k)
    # without fed draws the task's own generator gives another LFO each call
    a, b = t_task._prepare(t_batch)[3], t_task._prepare(t_batch)[3]
    assert not np.array_equal(a.numpy(), b.numpy())
