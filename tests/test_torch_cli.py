"""The port's config layer (`mod_extraction_tpu_torch/cli.py`) against the
JAX package's: every shipped config with a task builds a port `RunConfig`
on the CPU whose optimizer has the hyper-parameters the JAX
`build_optimizer` gives (read from the optax call it makes), `build_lr`
equals optax's schedules (rtol 1e-6), the optimizers step as optax's do,
the knobs once deferred (the TCN extractors and the TBPTT variants) build
the model and task the JAX `RunConfig` builds, and what the port does not
take raises, naming why."""

import copy
import glob
import inspect
import math
import os
import sys

import numpy as np
import optax
import pytest
import torch

from mod_extraction_tpu import cli as jcli
from mod_extraction_tpu_torch import cli as tcli
from mod_extraction_tpu_torch.paths import CONFIGS_DIR
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask, make_optimizer
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

CONFIGS = sorted(glob.glob(os.path.join(CONFIGS_DIR, "*.yml")))
TASK_CONFIGS = [p for p in CONFIGS if "model" in tcli.load_yaml_with_includes(p)]
R7_TBPTT = os.path.join(CONFIGS_DIR, "train_em_sim_flanger_r7.yml")
R7_LFO = os.path.join(CONFIGS_DIR, "train_lfo_interwoven_all_live_r7.yml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the suite runs in
    several processes at once, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_optimizer_call(opt_cfg, monkeypatch):
    """(name, keyword arguments) of the optax constructor the JAX
    `build_optimizer` calls for `opt_cfg`, defaults filled in."""
    calls = []
    for name in ("adamw", "adam", "sgd"):
        real = getattr(optax, name)

        def record(*args, _name=name, _real=real, **kw):
            bound = inspect.signature(_real).bind(*args, **kw)
            bound.apply_defaults()
            calls.append((_name, dict(bound.arguments)))
            return _real(*args, **kw)

        monkeypatch.setattr(jcli.optax, name, record)
    jcli.build_optimizer(opt_cfg)
    (call,) = calls
    return call


@pytest.mark.parametrize("path", TASK_CONFIGS, ids=[os.path.basename(p) for p in TASK_CONFIGS])
def test_config_builds_with_the_jax_optimizer(path, monkeypatch):
    cfg = tcli.load_yaml_with_includes(path)
    run = tcli.RunConfig(copy.deepcopy(cfg), device="cpu")
    assert run.data_module is not None and run.task.device.type == "cpu"
    opt_cfg = cfg.get("optimizer")
    name, kw = jax_optimizer_call(opt_cfg, monkeypatch)
    if not run.task.has_params:  # the RandomLFO baseline: nothing to optimize
        return
    opt = run.task.optimizer
    assert type(opt).__name__.lower() == name
    group = opt.param_groups[0]
    lr = kw["learning_rate"]
    want_lr = float(lr(0)) if callable(lr) else lr
    assert math.isclose(group["lr"], want_lr, rel_tol=1e-6, abs_tol=1e-12)
    assert (run.task.scheduler is not None) == callable(lr)
    if name in ("adamw", "adam"):
        assert group["betas"] == (kw["b1"], kw["b2"])
        assert group["eps"] == kw["eps"] == 1e-8
    if name == "adamw":
        assert group["weight_decay"] == kw["weight_decay"]
    else:
        assert group["weight_decay"] == 0.0
    if isinstance(run.task, TBPTTEffectModelingTask):
        args = cfg["model"]["init_args"]
        assert run.task.use_dry == args.get("use_dry", True)
        assert run.task.updates_per_batch == jax_updates_per_batch(run.task)


def _module_args(dm, render_fields) -> dict:
    """A data module's attributes before `setup` (its arguments as kept),
    with the `render_fields` of its render config (the JAX one also names
    its flanger backend)."""
    args = dict(vars(dm))
    args["render_cfg"] = {f: getattr(dm.render_cfg, f) for f in render_fields}
    return args


@pytest.mark.parametrize("path", TASK_CONFIGS, ids=[os.path.basename(p) for p in TASK_CONFIGS])
def test_data_module_is_built_as_in_jax(path):
    """The port's `build_data_module` keeps what the JAX one keeps of each
    shipped config: the same keys dropped (RandomAudioChunkDryWetDataModule's
    `seed`, `device_corpus`, ... that it takes only through `**kw`), the
    same CPU sizes and links."""
    cfg = tcli.load_yaml_with_includes(path)
    custom = cfg.get("custom") or {}
    j, j_links = jcli.build_data_module(copy.deepcopy(cfg["data"]), custom, 3)
    t, t_links = tcli.build_data_module(copy.deepcopy(cfg["data"]), custom, 3, device="cpu")
    assert type(t).__name__ == type(j).__name__
    assert t_links == j_links
    fields = vars(t.render_cfg)
    assert _module_args(t, fields) == _module_args(j, fields)


def jax_updates_per_batch(task) -> int:
    """The JAX task's `updates_per_batch` for the port task's geometry."""
    from mod_extraction_tpu.models.random_lfo import RandomLFO
    from mod_extraction_tpu.train.render import RenderConfig
    from mod_extraction_tpu.train.tbptt_task import TBPTTEffectModelingTask as JaxTask

    lfo = None
    if task.lfo_model is not None:
        lfo = RandomLFO(1, 1.0) if task.is_random_lfo else "an extractor"
    rc = task.render_cfg
    return JaxTask(
        effect_model=None, render_cfg=RenderConfig(sr=rc.sr, n_samples=rc.n_samples),
        warmup_n_samples=task.warmup_n_samples, step_n_samples=task.step_n_samples, lfo_model=lfo,
        model_smooth_n_frames=task.model_smooth_n_frames, should_stretch=task.should_stretch,
    ).updates_per_batch


def test_default_optimizers():
    """No optimizer block: the tasks' default (weight decay 1e-4, optax's
    default); an AdamW block without `weight_decay`: 0.01."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    g = tcli.build_optimizer(None)(params).param_groups[0]
    assert (g["lr"], g["betas"], g["weight_decay"]) == (1e-4, (0.8, 0.99), 1e-4)
    assert inspect.signature(optax.adamw).parameters["weight_decay"].default == 1e-4
    g = tcli.build_optimizer({"init_args": {"lr": 3e-5}})(params).param_groups[0]
    assert (g["lr"], g["betas"], g["weight_decay"]) == (3e-5, (0.8, 0.99), 0.01)


SCHEDULES = [
    {"name": "cosine", "warmup_steps": 300, "decay_steps": 12000, "end_lr": 1e-6},
    {"name": "cosine", "warmup_steps": 0, "decay_steps": 1000, "end_lr": 1e-6},
    {"name": "cosine", "warmup_steps": 1000, "decay_steps": 163200, "end_lr": 1e-6},
    {"name": "linear", "warmup_steps": 50, "decay_steps": 1000, "end_lr": 1e-6},
    {"name": "linear", "decay_steps": 10},
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=[f"{s['name']}-{s.get('warmup_steps', 0)}-{s['decay_steps']}"
                                                  for s in SCHEDULES])
def test_build_lr_equals_optax(sched):
    cfg = {"class_path": "torch.optim.AdamW", "init_args": {"lr": 5e-5}, "lr_schedule": sched}
    mine, theirs = tcli.build_lr(cfg), jcli.build_lr(cfg)
    w, d = sched.get("warmup_steps", 0), sched["decay_steps"]
    counts = sorted({0, 1, max(w - 1, 0), w, w + 1, (w + d) // 2, d - 1, d, d + 1, 5 * d})
    for u in counts:
        assert math.isclose(mine(u), float(theirs(u)), rel_tol=1e-6, abs_tol=1e-15), (u, mine(u), float(theirs(u)))
    assert tcli.build_lr({"init_args": {"lr": 2e-4}}) == 2e-4 == jcli.build_lr({"init_args": {"lr": 2e-4}})
    with pytest.raises(KeyError):
        tcli.build_lr({**cfg, "lr_schedule": {"name": "step", "decay_steps": 3}})


OPTIMIZERS = [
    {"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-2, "betas": [0.8, 0.99]},
     "lr_schedule": {"name": "cosine", "warmup_steps": 2, "decay_steps": 6, "end_lr": 1e-4}},
    {"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-2, "weight_decay": 0.3},
     "lr_schedule": {"name": "linear", "warmup_steps": 1, "decay_steps": 5}},
    {"class_path": "torch.optim.Adam", "init_args": {"lr": 1e-2, "betas": [0.9, 0.95]}},
    {"class_path": "torch.optim.SGD", "init_args": {"lr": 1e-1, "momentum": 0.9}},
    None,
]


@pytest.mark.parametrize("opt_cfg", OPTIMIZERS, ids=["adamw-cosine", "adamw-linear-wd", "adam", "sgd", "default"])
def test_optimizer_steps_as_optax(opt_cfg):
    """Six updates with the same gradients: the port's optimizer (and its
    schedule, advanced once an update) against the optax transformation of
    the JAX `build_optimizer`; float64 parameters on both sides."""
    import jax

    rng = np.random.default_rng(0)
    p0 = rng.uniform(-2, 2, 5)
    grads = rng.standard_normal((6, 5))
    grads[:, 1] = 0.0  # a parameter moved by weight decay alone
    lr = tcli.build_lr(opt_cfg)
    param = torch.nn.Parameter(torch.tensor(p0, dtype=torch.float64))
    opt, scheduler = make_optimizer([param], tcli.build_optimizer(opt_cfg), lr if callable(lr) else None)
    with jax.enable_x64(True):
        tx = jcli.build_optimizer(opt_cfg)
        p = jax.numpy.asarray(p0)
        state = tx.init(p)
        for g in grads:
            upd, state = tx.update(jax.numpy.asarray(g), state, p)
            p = optax.apply_updates(p, upd)
            param.grad = torch.tensor(g)
            opt.step()
            if scheduler is not None:
                scheduler.step()
        want = np.asarray(p)
    np.testing.assert_allclose(param.detach().numpy() - p0, want - p0, rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------ deferred knobs


def _tbptt_cfg():
    return tcli.load_yaml_with_includes(R7_TBPTT)


def _lfo_cfg():
    return tcli.load_yaml_with_includes(R7_LFO)


def _set(cfg, keys, value):
    node = cfg
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value
    return cfg


TCN = {"class_path": "mod_extraction.models.SpectralTCN", "init_args": {}}
# the shipped TCN extractor config (its `smooth_n_frames: 8` is dropped by both CLIs)
SPECTRAL_TCN = os.path.join(CONFIGS_DIR, "models", "spectral_tcn.yml")
DEFERRED = {
    "spectral_tcn": (lambda: _set(_lfo_cfg(), ("model", "init_args", "model"),
                                  tcli.load_yaml_with_includes(SPECTRAL_TCN)), "queue 1 item 2"),
    "spectral_dstcn": (lambda: _set(_lfo_cfg(), ("model", "init_args", "model"),
                                    dict(TCN, class_path="mod_extraction.models.SpectralDSTCN")), "queue 1 item 2"),
    "param_model": (lambda: _set(_tbptt_cfg(), ("model", "init_args", "param_model"),
                                 dict(TCN, class_path="SpectralDSTCN")), "queue 1 item 2"),
    "unfrozen_extractor": (lambda: _set(_tbptt_cfg(), ("model", "init_args", "freeze_lfo_model"), False),
                           "queue 1 item 3"),
    "stretch_smooth": (lambda: _set(_tbptt_cfg(), ("model", "init_args", "stretch_smooth_n_frames"), 4),
                       "queue 1 item 3"),
    # ported since: it raises only where matplotlib is missing, naming it
    "log_media": (lambda: _set(_lfo_cfg(), ("custom", "log_media"), True), "matplotlib"),
    # ported since: the test rewrites the config's r7 extractor as a reference-layout .pt
    "pt_weights": (_tbptt_cfg, "models/torch_port.py"),
}


# ported since: each builds what the JAX `RunConfig` builds
PORTED = {"spectral_tcn", "spectral_dstcn", "param_model", "unfrozen_extractor", "stretch_smooth", "pt_weights"}


def _shapes(sd) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


def _jax_shapes(convert, tree) -> dict:
    """The port state_dict shapes of a flax parameter tree's shapes."""
    import jax

    return _shapes(convert(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)))


def _assert_builds_as_jax(cfg):
    """The port's RunConfig builds the JAX one's model and task: the same
    classes and geometry, and parameters of the same names and shapes."""
    import jax

    from mod_extraction_tpu_torch.models.convert import (
        flax_lstm_to_state_dict,
        flax_to_state_dict,
        tcn_flax_to_state_dict,
    )

    run = tcli.RunConfig(copy.deepcopy(cfg), device="cpu")
    jrun = jcli.RunConfig(copy.deepcopy(cfg))
    task, jtask = run.task, jrun.task
    key = jax.random.PRNGKey(0)
    if isinstance(task, LFOExtractionTask):
        m, jm = task.model, jtask.model
        assert type(m).__name__ == type(jm).__name__
        assert (m.n_samples, m.n_fft, m.hop_len) == (jm.n_samples, jm.n_fft, jm.hop_len)
        assert _shapes(m.state_dict()) == _jax_shapes(tcn_flax_to_state_dict,
                                                      jax.eval_shape(jtask.init_state, key).params)
        return
    assert isinstance(task, TBPTTEffectModelingTask)
    assert task.multi_params == jtask.multi_params and task.trainable_lfo == jtask.trainable_lfo
    assert task.stretch_smooth_n_frames == jtask.stretch_smooth_n_frames
    assert task.updates_per_batch == jtask.updates_per_batch
    assert task._cropped_n_samples() == jtask._cropped_n_samples()
    params = jax.eval_shape(jtask.init_state, key).params
    convert = {"effect": flax_lstm_to_state_dict, "param": tcn_flax_to_state_dict, "lfo": flax_to_state_dict}
    if not task.multi_params:
        assert _shapes(task.trained_model.state_dict()) == _jax_shapes(flax_lstm_to_state_dict, params)
        if jtask.lfo_params is not None:  # the frozen extractor: JAX's weights, bit for bit
            want = flax_to_state_dict(jtask.lfo_params["params"])
            got = task.lfo_model.state_dict()
            assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        return
    assert set(params) == set(task.trained_model.keys())
    for part, tree in params.items():
        assert _shapes(task.trained_model[part].state_dict()) == _jax_shapes(convert[part], tree), part
    if task.param_model is not None:
        assert type(task.param_model).__name__ == type(jtask.param_model).__name__
        assert task.param_model.n_samples == jtask.param_model.n_samples == task._cropped_n_samples()


@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_deferred_knobs_raise(name, monkeypatch, tmp_path):
    """The knobs the port deferred: those ported since build as the JAX
    package's do (a reference-layout `.pt` as `lfo_model_weights_path`
    gives JAX's extractor bit for bit); `log_media` raises only where
    matplotlib is missing."""
    make, queue_item = DEFERRED[name]
    if name in PORTED:
        cfg = make()
        if name == "pt_weights":
            from chip_smoke import reference_layout

            args = cfg["model"]["init_args"]
            pt = str(tmp_path / "r7.pt")
            torch.save(reference_layout(tcli._repo_path(args["lfo_model_weights_path"])), pt)
            args["lfo_model_weights_path"] = pt
        _assert_builds_as_jax(cfg)
        return
    if name == "log_media":
        import mod_extraction_tpu_torch.utils as utils

        run = tcli.RunConfig(make(), device="cpu")
        assert tcli._media_callback_for(run) is not None
        monkeypatch.delitem(sys.modules, "mod_extraction_tpu_torch.utils.plotting", raising=False)
        monkeypatch.delattr(utils, "plotting", raising=False)
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match=queue_item):
            tcli._media_callback_for(run)
        return
    raise AssertionError(f"{name} is neither ported nor log_media")


def test_param_model_alone_names_the_tbptt_variants():
    """A SpectralDSTCN param model alone (ground-truth LFO) trains: its
    weights move in one step, through the latent K5's `dseq` hands back."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
    from mod_extraction_tpu_torch.models.tcn import SpectralDSTCN
    from mod_extraction_tpu_torch.train.render import RenderConfig

    cfg = RenderConfig(sr=44100.0, n_samples=4410, effects=(2,), max_delay_samples=485)
    pm = SpectralDSTCN(n_samples=4410, n_fft=256, hop_len=64, kernel_size=5, out_channels=(4, 4),
                       dilations=(1, 2), n_fc_units=4)
    task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=8, latent_dim=3), cfg, param_model=pm, warmup_n_samples=512,
        step_n_samples=512, model_smooth_n_frames=0, should_stretch=False, discard_invalid_lfos=False,
        device="cpu",
    )
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    metrics = task.train_step(batch_to_torch(make_synthetic_batch(0, 2, 4410, 44100.0, "flanger"), "cpu"))
    assert math.isfinite(metrics["loss"].item())
    assert all(not torch.equal(v, before[k]) for k, v in pm.state_dict().items())


def test_cpu_sizes_and_links():
    """On the CPU the batch and epoch sizes shrink to `custom.cpu_*`; the
    card keeps the config's; n_samples/sr reach the models."""
    cfg = _tbptt_cfg()
    dm, links = tcli.build_data_module(copy.deepcopy(cfg["data"]), cfg["custom"], 1, device="cpu")
    assert (dm.batch_size, dm.train_num, dm.val_num) == (4, 10, 5)
    assert links == {"n_samples": 88200, "sr": 44100}
    dm, _ = tcli.build_data_module(copy.deepcopy(cfg["data"]), cfg["custom"], 1, device="meta")
    assert (dm.batch_size, dm.train_num, dm.val_num) == (32, 512, 128)
    run = tcli.RunConfig(_lfo_cfg(), device="cpu")
    assert isinstance(run.task, LFOExtractionTask)
    assert run.task.model.n_samples == 88200 and run.task.model.sr == 44100
    assert run.run_name == "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7"
    assert run.data_module.batch_size == 9  # custom.cpu_batch_size
