"""The TBPTT variants of the port (`mod_extraction_tpu_torch/train/
tbptt_task.py`) against the JAX `TBPTTEffectModelingTask` on the CPU (its
scan path): one `val_step` and one `train_step` of each at the shapes of
`tests/test_tbptt_variants.py` (8 kHz, 4000-sample clips, 256-sample
chunks, an LSTM-8, a tiny SpectralDSTCN and a tiny Spectral2DCNN):

* `param_model`: a SpectralDSTCN clip latent (latent_dim 2) after the
  ground-truth LFO, the LSTM's latent_dim 3;
* `unfrozen`: the tiny extractor trained with the LSTM every chunk, the
  LFO smoothed (4) and corner-stretched, so the gradient crosses both; its
  convs in float32 (`compute_dtype="float32"`, both packages' default), so
  the comparison does not read bf16 rounding;
* `stretch_smooth`: `stretch_smooth_n_frames` 4 on the ground-truth LFO
  (the crop, `updates_per_batch` and the validity weights follow);
* `train_steps` over two batches (JAX scans them in one program).

Both sides are fed the same synthetic flanger batch (each package renders
it) and the same initial weights: the port's seeded ones, carried to the
JAX state by `models/convert.py`.  Also: the parameter layout ({effect,
param?, lfo?} as JAX's `init_state`, the frozen path flat), the schedule
advanced once per chunk, and the gradient all-reduce covering every
trained part (by mock, as `tests/test_torch_ddp.py` mocks collectives).

Tolerances: losses atol 1e-6 / rtol 1e-4 (`ROADMAP.md`'s LSTM training
loss); every trained part's parameters after the step within 5e-4 of the
largest update JAX made to that tensor, plus 2e-7 (float32 rounding of the
weights themselves; AdamW moves a weight by about lr whatever its
gradient's size, so the update's scale is the step's own)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mod_extraction_tpu.models import LSTMEffectModel as JLSTM
from mod_extraction_tpu.models import Spectral2DCNN as JSpectral2DCNN
from mod_extraction_tpu.models.tcn import SpectralDSTCN as JSpectralDSTCN
from mod_extraction_tpu.train.render import RenderConfig as JRenderConfig
from mod_extraction_tpu.train.render import render_batch as j_render_batch
from mod_extraction_tpu.train.tbptt_task import TBPTTEffectModelingTask as JTask
from mod_extraction_tpu.train.tbptt_task import TBPTTState
from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
from mod_extraction_tpu_torch.models.convert import (
    flax_lstm_to_state_dict,
    flax_to_state_dict,
    lstm_state_dict_to_flax,
    spectral_2dcnn_state_dict_to_flax,
    tcn_flax_to_state_dict,
    tcn_state_dict_to_flax,
)
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.models.tcn import SpectralDSTCN
from mod_extraction_tpu_torch.train import tbptt_task as ttask
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

SR, N, CHUNK, HID = 8000.0, 4000, 256, 8
RENDER = dict(sr=SR, n_samples=N, effects=(2,), max_delay_samples=89)
BASE = dict(warmup_n_samples=CHUNK, step_n_samples=CHUNK, loss_dict={"l1": 1.0, "esr": 0.0, "dc": 0.0})
DSTCN = dict(n_samples=N, n_fft=256, hop_len=64, kernel_size=5, out_channels=(4, 4), dilations=(1, 2),
             strides=(2, 2), n_fc_units=8, latent_dim=2)
TINY = dict(in_ch=2, n_samples=N, sr=SR, n_fft=256, hop_len=64, n_mels=16, out_channels=(4, 4),
            bin_dilations=(1, 1), temp_dilations=(1, 2), pool_size=(2, 1), compute_dtype="float32")
VARIANTS = {
    "param_model": dict(param=True, task=dict(model_smooth_n_frames=0, should_stretch=False,
                                              discard_invalid_lfos=False)),
    "unfrozen": dict(lfo=True, task=dict(freeze_lfo_model=False, model_smooth_n_frames=8,
                                         should_stretch=True, discard_invalid_lfos=False)),
    "stretch_smooth": dict(task=dict(model_smooth_n_frames=8, should_stretch=True,
                                     stretch_smooth_n_frames=4, discard_invalid_lfos=True)),
}
LOSS_ATOL, LOSS_RTOL = 1e-6, 1e-4
# the stretched LFO: the stretch divides by each segment's range, which
# multiplies the extractor's 1e-7 rounding by up to a few hundred on a
# random-init extractor's flat LFO (its output itself is held at 1e-6)
LFO_ATOL = {"unfrozen": 1e-4}
UPDATE_REL, PARAM_ATOL = 5e-4, 2e-7
PARTS = {  # trained part -> (JAX params -> port state_dict, port state_dict -> JAX params)
    "effect": (flax_lstm_to_state_dict, lambda sd: {"params": lstm_state_dict_to_flax(sd)}),
    "param": (tcn_flax_to_state_dict, tcn_state_dict_to_flax),
    "lfo": (flax_to_state_dict, lambda sd: {"params": spectral_2dcnn_state_dict_to_flax(sd)}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(name: str):
    """(JAX task, its state holding the port's initial weights, port task)."""
    v = VARIANTS[name]
    latent = 1 + (DSTCN["latent_dim"] if v.get("param") else 0)
    t_task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=HID, latent_dim=latent, generator=torch.Generator().manual_seed(1)),
        RenderConfig(**RENDER), lfo_model=Spectral2DCNN(**TINY, seed=2) if v.get("lfo") else None,
        param_model=SpectralDSTCN(**DSTCN, seed=3) if v.get("param") else None,
        device="cpu", **BASE, **v["task"],
    )
    j_task = JTask(
        effect_model=JLSTM(in_ch=1, out_ch=1, n_hidden=HID, latent_dim=latent),
        render_cfg=JRenderConfig(**RENDER), lfo_model=JSpectral2DCNN(**TINY) if v.get("lfo") else None,
        param_model=JSpectralDSTCN(**DSTCN) if v.get("param") else None,
        optimizer=optax.adamw(1e-4, b1=0.8, b2=0.99), lstm_impl="scan", **BASE, **v["task"],
    )
    params = {part: jax.tree.map(jnp.asarray, PARTS[part][1](sd)) for part, sd in _parts(t_task).items()}
    if not t_task.multi_params:
        params = params["effect"]
    state = TBPTTState(params=params, opt_state=j_task.optimizer.init(params), step=jnp.zeros((), jnp.int32))
    return j_task, state, t_task


def _parts(t_task) -> dict:
    """{part: state_dict} of the port task's trained parts."""
    if not t_task.multi_params:
        return {"effect": t_task.trained_model.state_dict()}
    return {part: m.state_dict() for part, m in t_task.trained_model.items()}


def _j_parts(params) -> dict:
    params = jax.tree.map(np.asarray, params)
    if "effect" not in params:
        params = {"effect": params}
    return {part: PARTS[part][0](p) for part, p in params.items()}


def _batches(n=1, seed=3, bs=4):
    return [make_synthetic_batch(seed + i, bs, N, SR, "flanger") for i in range(n)]


def _metrics_close(mt, mj, what):
    assert set(mt) == set(mj), what
    for k in mj:
        np.testing.assert_allclose(np.asarray(mt[k]), np.asarray(mj[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"{what} {k}")


def _params_close(t_task, before: dict, new_params):
    """Every trained part's tensors within 5e-4 of JAX's largest update to
    each (and float32 rounding)."""
    got, want = _parts(t_task), _j_parts(new_params)
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys(), part
        for k, w in want[part].items():
            upd = float((w - before[part][k]).abs().max())
            err = float((got[part][k] - w).abs().max())
            assert upd > 0 or part != "effect", f"{part}.{k} did not move"
            assert err <= UPDATE_REL * upd + PARAM_ATOL, f"{part}.{k}: |d| {err} against update {upd}"


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_val_and_train_step_match_jax(name):
    j_task, state, t_task = _tasks(name)
    assert t_task.updates_per_batch == j_task.updates_per_batch
    assert t_task._cropped_n_samples() == j_task._cropped_n_samples()
    (np_batch,) = _batches()
    j_batch, t_batch = jax.tree.map(jnp.asarray, np_batch), batch_to_torch(np_batch, "cpu")
    key = jax.random.PRNGKey(0)
    prep_t = t_task._prepare(t_batch)
    prep_j = j_task._prepare(j_batch, key, lfo_params=state.params.get("lfo"))
    np.testing.assert_array_equal(prep_t[4].numpy(), np.asarray(prep_j[5]))
    np.testing.assert_allclose(prep_t[3].numpy(), np.asarray(prep_j[3]), rtol=0, atol=LFO_ATOL.get(name, 1e-5))
    if name == "unfrozen":  # the extractor's own output, before the stretch amplifies its rounding
        raw_t = t_task._extract_mod_sig(*render_batch(t_batch, t_task.render_cfg)[:3])
        jr = j_render_batch(j_batch, j_task.render_cfg)
        raw_j, _ = j_task._extract_mod_sig(*jr, key, lfo_params=state.params["lfo"])
        np.testing.assert_allclose(raw_t.detach().numpy(), np.asarray(raw_j), rtol=0, atol=1e-6)
    if name == "stretch_smooth":  # the stretch's own smoothing shortened the LFO by 3 frames
        assert prep_t[3].shape[-1] == RenderConfig(**RENDER).n_mod_frames - 7 - 3
        assert 0 < float(prep_t[4].sum()) < len(prep_t[4])

    _metrics_close(t_task.val_step(t_batch), j_task.val_step(state.params, j_batch, key), "val_step")
    before = {p: {k: v.clone() for k, v in sd.items()} for p, sd in _parts(t_task).items()}
    new_state, mj = j_task.train_step(state, j_batch, key)
    _metrics_close(t_task.train_step(t_batch), mj, "train_step")
    _params_close(t_task, before, new_state.params)
    for part in set(before) - {"effect"}:  # the param model / extractor trained too
        assert any(not torch.equal(v, before[part][k]) for k, v in _parts(t_task)[part].items()), part


def test_train_steps_match_jax():
    """`train_steps` over two batches against JAX's scan of two steps."""
    j_task, state, t_task = _tasks("param_model")
    nb = _batches(2, seed=11)
    j_batches = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *nb)
    keys = jnp.stack([jax.random.PRNGKey(0)] * 2)
    before = {p: {k: v.clone() for k, v in sd.items()} for p, sd in _parts(t_task).items()}
    new_state, mj = j_task.train_steps(state, j_batches, keys)
    mt = t_task.train_steps([batch_to_torch(b, "cpu") for b in nb])
    assert all(v.shape == (2,) for v in mt.values())
    _metrics_close(mt, mj, "train_steps")
    _params_close(t_task, before, new_state.params)


def test_train_steps_equal_sequential_steps():
    """The port's `train_steps` is `train_step` in turn, bit for bit."""
    nb = [batch_to_torch(b, "cpu") for b in _batches(2, seed=11)]
    _, _, many = _tasks("param_model")
    _, _, one = _tasks("param_model")
    stacked = many.train_steps(nb)
    seq = [one.train_step(b) for b in nb]
    for k in stacked:
        assert torch.equal(stacked[k], torch.stack([m[k] for m in seq])), k
    for k, v in many.trained_model.state_dict().items():
        assert torch.equal(v, one.trained_model.state_dict()[k]), k


@pytest.mark.parametrize("name", ["frozen", "param_model", "unfrozen"])
def test_parameter_layout_matches_jax_init_state(name):
    """{effect, param?, lfo?} as JAX's `init_state` lays out its params;
    the frozen path keeps the flat layout (checkpoints of the shipped
    configs load unchanged) and a checkpoint of it keeps the extractor apart."""
    if name == "frozen":
        kw = dict(model_smooth_n_frames=0, should_stretch=False)
        t_task = TBPTTEffectModelingTask(LSTMEffectModel(n_hidden=HID), RenderConfig(**RENDER),
                                         lfo_model=Spectral2DCNN(**TINY), device="cpu", **BASE, **kw)
        j_task = JTask(effect_model=JLSTM(n_hidden=HID), render_cfg=JRenderConfig(**RENDER),
                       lfo_model=JSpectral2DCNN(**TINY), **BASE, **kw)
    else:
        j_task, _, t_task = _tasks(name)
    shapes = jax.eval_shape(j_task.init_state, jax.random.PRNGKey(0)).params
    assert t_task.multi_params == j_task.multi_params == (name != "frozen")
    if name == "frozen":
        assert "params" in shapes and t_task.trained_model is t_task.effect_model
        assert set(t_task.state_dict()["model"]) == set(flax_lstm_to_state_dict(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)))
        assert "lfo_model" in t_task.state_dict()
        return
    assert set(shapes) == set(t_task.trained_model.keys())
    got = _parts(t_task)
    for part, tree in shapes.items():
        want = PARTS[part][0](jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree))
        assert {k: tuple(v.shape) for k, v in got[part].items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert "lfo_model" not in t_task.state_dict()
    # one optimizer over every part
    assert {id(p) for g in t_task.optimizer.param_groups for p in g["params"]} == \
        {id(p) for p in t_task.trained_model.parameters()}


def test_schedule_advances_once_per_chunk():
    seen = []

    def schedule(u):
        seen.append(u)
        return 1e-4

    t_task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=HID, latent_dim=3), RenderConfig(**RENDER),
        param_model=SpectralDSTCN(**DSTCN), lr_schedule=schedule, device="cpu", **BASE,
        **VARIANTS["param_model"]["task"],
    )
    t_task.train_step(batch_to_torch(_batches()[0], "cpu"))
    n = t_task.updates_per_batch
    assert n == (N - CHUNK) // CHUNK
    assert t_task.scheduler.last_epoch == n and max(seen) == n


@pytest.mark.parametrize("name", ["param_model", "unfrozen"])
def test_gradient_all_reduce_covers_every_trained_part(name, monkeypatch):
    """Each chunk's all-reduce is handed every trained parameter, with its
    gradient: the param model's and the extractor's too."""
    _, _, t_task = _tasks(name)
    seen = []
    monkeypatch.setattr(ttask, "all_reduce_grads",
                        lambda params: seen.append({id(p) for p in params if p.grad is not None}))
    batch = batch_to_torch(_batches()[0], "cpu")
    n_chunks = (t_task._prepare(batch)[0].shape[-1] - CHUNK) // CHUNK
    t_task.train_step(batch)
    want = {id(p) for p in t_task.trained_model.parameters()}
    part = t_task.param_model if name == "param_model" else t_task.lfo_model
    assert {id(p) for p in part.parameters()} <= want
    assert len(seen) == n_chunks and all(s == want for s in seen)
