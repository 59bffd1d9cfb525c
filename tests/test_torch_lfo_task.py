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
import pytest
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


# --- the rest of the task ---------------------------------------------------


def jax_mask_draws(key):
    """The four SpecAugment uniforms `_loss_fn` draws from its step key."""
    k_mask = jax.random.split(key, 3)[1]
    return [float(jax.random.uniform(k)) for k in jax.random.split(k_mask, 4)]


def _assert_step_close(t_task, new_state, params0, grads_j=None, kernel_leaves=()):
    new_t = t_task.model.state_dict()
    new_j = flax_to_state_dict(jax.tree.map(np.asarray, new_state.params))
    old = flax_to_state_dict(params0)
    for k in new_j:
        np.testing.assert_allclose(new_t[k].numpy(), new_j[k].numpy(), atol=1e-5, err_msg=k)
        assert not np.array_equal(new_t[k].numpy(), old[k].numpy()), k
    if grads_j is not None:
        g_conv = flax_to_state_dict(jax.tree.map(np.asarray, grads_j))
        for k, p in t_task.model.named_parameters():
            gj = g_conv[k].numpy()
            tol = 2e-2 if k in kernel_leaves else 1e-3
            np.testing.assert_allclose(p.grad.numpy(), gj, atol=tol * np.abs(gj).max(), err_msg=k)


def _setup_with(model_opts=None, **task_opts):
    d = flanger_max_delay_samples(30.0, 10.0, SR)
    np_batch = make_interwoven_batch(3, 6, N, SR)
    model_opts = model_opts or {}
    j_task = JTask(
        model=JSpectral2DCNN(**TINY, **model_opts),
        render_cfg=JRenderConfig(sr=SR, n_samples=N, effects=(2, 3), max_delay_samples=d),
        optimizer=optax.adamw(1e-4, b1=0.8, b2=0.99), loss_dict=LOSSES, **task_opts,
    )
    state = j_task.init_state(jax.random.PRNGKey(1))
    params0 = jax.tree.map(np.asarray, state.params)
    t_model = Spectral2DCNN(**TINY, **model_opts)
    t_model.load_state_dict(flax_to_state_dict(params0))
    t_task = LFOExtractionTask(
        t_model, RenderConfig(sr=SR, n_samples=N, effects=(2, 3), max_delay_samples=d),
        loss_dict=LOSSES, device="cpu", **task_opts,
    )
    return np_batch, j_task, state, params0, t_task


def test_train_step_with_kernel_wgrad_matches_jax(monkeypatch):
    """`wgrad_impl="pallas"`: the port's step (K6's plain version on the CPU)
    against the JAX step with the TPU kernel in interpret mode, substituted
    on the name the JAX model imported.  The second layer's conv weight (8
    input channels, the one the kernel covers) carries the bf16 rounding of
    x and dy on both sides: 2e-2 of its largest magnitude; every other leaf
    1e-3 as in the default configuration."""
    import functools

    import mod_extraction_tpu.models.spectral_2dcnn as jmod
    from mod_extraction_tpu.ops.pallas_conv import make_conv2d_custom as j_make
    from mod_extraction_tpu_torch.ops import conv_kernels

    monkeypatch.setattr(jmod, "make_conv2d_custom", functools.partial(j_make, interpret=True))
    np_batch, j_task, state, params0, t_task = _setup_with(dict(wgrad_impl="pallas"))
    key = jax.random.PRNGKey(5)
    j_batch = jax.tree.map(jnp.asarray, np_batch)
    grads_j = jax.grad(lambda p: j_task._loss_fn(p, j_batch, key, True)[0])(state.params)
    new_state, mj = j_task.train_step(state, j_batch, key)
    conv_kernels.reset_launch_counts()
    mt = t_task.train_step(batch_to_torch(np_batch, "cpu"), mask_draws=jax_mask_draws(key))
    assert conv_kernels.LAUNCHES == {"conv_wgrad": 0}  # the CPU path launches nothing
    _assert_metrics_close(mt, mj)
    _assert_step_close(t_task, new_state, params0, grads_j, kernel_leaves=("convs.1.weight",))


def test_sub_batched_train_step_matches_jax():
    """`sub_batch_size=2` over a batch of 6: gradients and metrics averaged
    over three sub-batches, each masked with the draws of its own JAX key."""
    np_batch, j_task, state, params0, t_task = _setup_with(sub_batch_size=2)
    key = jax.random.PRNGKey(9)
    new_state, mj = j_task.train_step(state, jax.tree.map(jnp.asarray, np_batch), key)
    draws = [jax_mask_draws(k) for k in jax.random.split(key, 3)]
    mt = t_task.train_step(batch_to_torch(np_batch, "cpu"), mask_draws=draws)
    _assert_metrics_close(mt, mj)
    _assert_step_close(t_task, new_state, params0)
    # and it is not the unsplit step: one mask for the whole batch differs
    _, _, _, _, whole = _setup_with()
    mw = whole.train_step(batch_to_torch(np_batch, "cpu"), mask_draws=draws[0])
    assert abs(float(mw["loss"]) - float(mt["loss"])) > 1e-7


def test_train_steps_equals_sequential_steps():
    _, _, _, _, many = _setup_with()
    _, _, _, _, single = _setup_with()
    batches = [batch_to_torch(make_interwoven_batch(s, 6, N, SR), "cpu") for s in (3, 4, 5)]
    draws = np.random.default_rng(0).uniform(0, 1, (3, 4)).astype(np.float32)
    stacked = many.train_steps(batches, mask_draws=draws)
    seq = [single.train_step(b, mask_draws=draws[i]) for i, b in enumerate(batches)]
    assert set(stacked) == {"l1", "fdl1", "sdl1", "mse", "loss"}
    for k, v in stacked.items():
        assert tuple(v.shape) == (3,)
        assert torch.equal(v, torch.stack([m[k] for m in seq])), k
    for (k, a), (_, b) in zip(many.model.state_dict().items(), single.model.state_dict().items()):
        assert torch.equal(a, b), k
    # drawn from the task's own generator when no draws are fed
    assert set(many.train_steps(batches[:2])) == set(stacked)


@pytest.mark.parametrize("stretch_smooth", [0, 3])
def test_val_step_with_stretch_matches_jax(stretch_smooth):
    opts = dict(should_stretch=True, max_n_corners=16, stretch_smooth_n_frames=stretch_smooth)
    np_batch, j_task, state, _, t_task = _setup_with(**opts)
    mj = j_task.val_step(state.params, jax.tree.map(jnp.asarray, np_batch), jax.random.PRNGKey(0))
    mt = t_task.val_step(batch_to_torch(np_batch, "cpu"))
    _assert_metrics_close(mt, mj)
    _, _, _, _, plain = _setup_with()
    assert float(plain.val_step(batch_to_torch(np_batch, "cpu"))["l1"]) != float(mt["l1"])


@pytest.mark.parametrize("use_gt", [False, True], ids=["free", "anchored"])
def test_random_lfo_val_step_matches_jax(use_gt):
    """The RandomLFO baseline in place of a model: no parameters, `val_step`
    only, the same draws on both sides (JAX's, taken as `_loss_fn` and
    `make_rand_mod_signal` split their keys)."""
    from mod_extraction_tpu.models.random_lfo import RandomLFO as JRandomLFO
    from mod_extraction_tpu_torch.models.random_lfo import RandomLFO

    d = flanger_max_delay_samples(30.0, 10.0, SR)
    np_batch = make_interwoven_batch(3, 6, N, SR)
    n_frames = np_batch["mod_sig"].shape[-1]
    shapes = ("cos", "tri", "rect_cos", "inv_rect_cos")
    cfg = dict(n_samples=n_frames, sr=n_frames / (N / SR), use_shape_gt=use_gt, use_phase_gt=use_gt,
               use_freq_gt=use_gt, shapes=shapes, phase_error=0.25, freq_error=0.1)
    render = dict(sr=SR, n_samples=N, effects=(2, 3), max_delay_samples=d)
    j_task = JTask(model=JRandomLFO(**cfg), render_cfg=JRenderConfig(**render), loss_dict=LOSSES)
    t_task = LFOExtractionTask(RandomLFO(**cfg), RenderConfig(**render), loss_dict=LOSSES, device="cpu")
    assert t_task.is_random_lfo and not t_task.has_params and t_task.optimizer is None
    key = jax.random.PRNGKey(4)
    mj = j_task.val_step(None, jax.tree.map(jnp.asarray, np_batch), key)
    k_phase, k_freq, k_shape = jax.random.split(jax.random.split(key, 3)[1], 3)
    draws = {
        "phase": np.asarray(jax.random.uniform(k_phase, (6,))),
        "freq": np.asarray(jax.random.uniform(k_freq, (6,))),
        "shape": np.asarray(jax.random.randint(k_shape, (6,), 0, len(shapes))),
    }
    mt = t_task.val_step(batch_to_torch(np_batch, "cpu"), lfo_draws=draws)
    _assert_metrics_close(mt, mj)
    with pytest.raises(AssertionError):
        t_task.train_step(batch_to_torch(np_batch, "cpu"))
    # from the task's own generator: finite metrics, another draw each call
    a = t_task.val_step(batch_to_torch(np_batch, "cpu"))
    b = t_task.val_step(batch_to_torch(np_batch, "cpu"))
    assert np.isfinite(float(a["loss"])) and float(a["loss"]) != float(b["loss"])
