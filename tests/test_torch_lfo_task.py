"""One stage-1 `train_step` and one `val_step` of the port against the JAX
`LFOExtractionTask` on the CPU: an interwoven (flanger + chorus + phaser)
synthetic batch at a short clip, a tiny extractor (2 layers x 8 channels,
float32), the same initial weights (converted from the JAX init) and the
same SpecAugment draws.

Tolerances: metrics rtol 1e-4 (float32, reordered sums through render,
frontend and trunk); gradients 1e-3 of each leaf's largest magnitude;
parameters after the AdamW step 1e-5 absolute (lr 1e-4: a first Adam step
moves each weight by about lr * g / (|g| + eps), so a gradient that is
nearly zero may move differently by a fraction of lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from mod_extraction_tpu.models import Spectral2DCNN as JSpectral2DCNN
from mod_extraction_tpu.train.lfo_task import LFOExtractionTask as JTask
from mod_extraction_tpu.train.render import RenderConfig as JRenderConfig
from mod_extraction_tpu_torch.data.synthetic import (
    batch_to_torch,
    flanger_max_delay_samples,
    make_interwoven_batch,
)
from mod_extraction_tpu_torch.models.convert import flax_to_state_dict
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
from mod_extraction_tpu_torch.train.render import RenderConfig

SR, N = 44100.0, 4410
TINY = dict(
    in_ch=2, n_samples=N, sr=SR, n_fft=1024, hop_len=256, n_mels=32,
    kernel_size=(5, 13), out_channels=(8, 8), temp_dilations=(1, 2),
    pool_size=(2, 1), freq_mask_amount=0.25, time_mask_amount=0.25,
)
LOSSES = {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}


def _setup():
    d = flanger_max_delay_samples(30.0, 10.0, SR)  # the chorus line, 1764
    np_batch = make_interwoven_batch(3, 6, N, SR)
    j_task = JTask(
        model=JSpectral2DCNN(**TINY),
        render_cfg=JRenderConfig(sr=SR, n_samples=N, effects=(2, 3), max_delay_samples=d),
        optimizer=optax.adamw(1e-4, b1=0.8, b2=0.99),
        loss_dict=LOSSES,
    )
    state = j_task.init_state(jax.random.PRNGKey(1))
    params0 = jax.tree.map(np.asarray, state.params)
    t_model = Spectral2DCNN(**TINY)
    t_model.load_state_dict(flax_to_state_dict(params0))
    t_task = LFOExtractionTask(
        t_model,
        RenderConfig(sr=SR, n_samples=N, effects=(2, 3), max_delay_samples=d),
        loss_dict=LOSSES,
        device="cpu",
    )
    return np_batch, j_task, state, params0, t_task


def _assert_metrics_close(mt, mj):
    assert set(mt) == set(mj) == {"l1", "fdl1", "sdl1", "mse", "loss"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=k)


def test_train_step_matches_jax():
    np_batch, j_task, state, params0, t_task = _setup()
    key = jax.random.PRNGKey(5)
    j_batch = jax.tree.map(jnp.asarray, np_batch)
    grads_j = jax.grad(lambda p: j_task._loss_fn(p, j_batch, key, True)[0])(state.params)
    new_state, mj = j_task.train_step(state, j_batch, key)
    k_mask = jax.random.split(key, 3)[1]
    draws = [float(jax.random.uniform(k)) for k in jax.random.split(k_mask, 4)]

    mt = t_task.train_step(batch_to_torch(np_batch, "cpu"), mask_draws=draws)
    _assert_metrics_close(mt, mj)
    assert float(mt["loss"]) > 0

    grads_t = {k: p.grad.numpy() for k, p in t_task.model.named_parameters()}
    g_conv = {k: torch.as_tensor(v) for k, v in flax_to_state_dict(jax.tree.map(np.asarray, grads_j)).items()}
    new_t = t_task.model.state_dict()
    new_j = flax_to_state_dict(jax.tree.map(np.asarray, new_state.params))
    old = flax_to_state_dict(params0)
    for k in new_j:
        gj = g_conv[k].numpy()
        np.testing.assert_allclose(grads_t[k], gj, atol=1e-3 * np.abs(gj).max(), err_msg=k)
        np.testing.assert_allclose(new_t[k].numpy(), new_j[k].numpy(), atol=1e-5, err_msg=k)
        assert not np.array_equal(new_t[k].numpy(), old[k].numpy()), k


def test_val_step_matches_jax():
    np_batch, j_task, state, _, t_task = _setup()
    mj = j_task.val_step(state.params, jax.tree.map(jnp.asarray, np_batch), jax.random.PRNGKey(0))
    mt = t_task.val_step(batch_to_torch(np_batch, "cpu"))
    _assert_metrics_close(mt, mj)
