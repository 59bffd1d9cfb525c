"""Config-driven CLI: `fit` / `validate` from reference-style YAML (the port's
copy of `mod_extraction_tpu/cli.py`).

Kept from the JAX package:

* `class_path`/`init_args` instantiation with file-reference composition
  (a string value ending in .yml is loaded as a nested config),
* the `custom.*` namespace (run names, the CPU sizes, `init_weights_path`,
  `log_every_n_steps`, `profile_dir`; `steps_per_dispatch` is accepted and
  has no effect),
* argument linking: `data.n_samples`/`data.sr` are copied into nested model
  configs that accept them,
* the CPU sizes: on the CPU, batch size and epoch sizes shrink to the
  `custom.cpu_*` values (the JAX package does so on its CPU backend; here
  when the caller asks for `device="cpu"`),
* run naming `{model_name}__{dataset_name}`, `seed_everything`,
* `build_optimizer` / `build_lr` with the JAX package's hyper-parameters:
  AdamW's weight decay is 0.01 when the config gives none, and the cosine
  and linear schedules take optax's values at every optimizer update,
* `validate`, which prints the archived `eval/*.txt` table
  (`evaluation/tables.py`) and writes `custom.save_latents`, and
  `validate_many`, which sweeps data/checkpoint variants over one task
  (what `scripts/run_eval_grid_torch.py` calls),
* `custom.log_media` (`utils/plotting.py`, matplotlib imported only then)
  every `custom.media_every_n_epochs` epochs (default 10),
* data parallelism as the JAX package takes every visible device: under
  `torchrun --nproc_per_node N` each entry point joins the process group
  from the environment and trains on its rank's share of the config's
  `batch_size`, the global batch (`parallel/dist.py`).

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU.  Every model and TBPTT variant of the JAX CLI builds here: the
Spectral2DCNN and the TCN extractors (`SpectralTCN`, `SpectralDSTCN`), the
LSTM effect model, the RandomLFO baseline, a `param_model` and an unfrozen
extractor (`freeze_lfo_model: false`).
"""

from __future__ import annotations

import inspect
import logging
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from mod_extraction_tpu_torch.data.modules import DATA_MODULE_REGISTRY
from mod_extraction_tpu_torch.evaluation.tables import format_validate_table
from mod_extraction_tpu_torch.models.convert import (
    flax_lstm_to_state_dict,
    flax_to_state_dict,
    tcn_flax_to_state_dict,
)
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.random_lfo import RandomLFO
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.models.tcn import SpectralDSTCN, SpectralTCN
from mod_extraction_tpu_torch.parallel.dist import check_replicated, process_group
from mod_extraction_tpu_torch.paths import CONFIGS_DIR, ROOT_DIR, ensure_dir
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask, adamw
from mod_extraction_tpu_torch.train.loop import Trainer, _tree_map, host_batch_to_torch
from mod_extraction_tpu_torch.train.render import render_batch
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask
from mod_extraction_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


MODEL_REGISTRY = {
    "mod_extraction.models.Spectral2DCNN": Spectral2DCNN,
    "mod_extraction.models.SpectralTCN": SpectralTCN,
    "mod_extraction.models.SpectralDSTCN": SpectralDSTCN,
    "mod_extraction.models.LSTMEffectModel": LSTMEffectModel,
    "mod_extraction.models.RandomLFO": RandomLFO,
    "Spectral2DCNN": Spectral2DCNN,
    "SpectralTCN": SpectralTCN,
    "SpectralDSTCN": SpectralDSTCN,
    "LSTMEffectModel": LSTMEffectModel,
    "RandomLFO": RandomLFO,
}

TASK_PATHS_LFO = ("mod_extraction.lightning.LFOExtraction", "LFOExtraction")
TASK_PATHS_TBPTT = ("mod_extraction.lightning.TBPTTLFOEffectModeling", "TBPTTEffectModeling")

# model config keys given as YAML lists that the models take as tuples
_TUPLE_KEYS = {
    "kernel_size", "pool_size", "out_channels", "bin_dilations", "temp_dilations", "dilations",
    "strides",
}


def load_yaml_with_includes(path: str, base_dir: Optional[str] = None) -> Any:
    """Load YAML; any string value ending in .yml/.yaml is itself loaded
    (relative to the including file, the configs dir, or the repo root)."""
    path = resolve_config_path(path, base_dir)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    return _resolve_includes(cfg, os.path.dirname(path))


def resolve_config_path(path: str, base_dir: Optional[str] = None) -> str:
    candidates = []
    if os.path.isabs(path):
        candidates.append(path)
    else:
        if base_dir:
            candidates.append(os.path.join(base_dir, path))
        candidates.append(path)
        candidates.append(os.path.join(ROOT_DIR, path))  # `configs/...` from elsewhere
        candidates.append(os.path.join(CONFIGS_DIR, path))
        # reference configs use ../configs/... relative to scripts/
        candidates.append(os.path.join(CONFIGS_DIR, os.path.basename(path)))
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f"config not found: {path} (tried {candidates})")


_SCI_FLOAT_RE = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def _resolve_includes(node: Any, base_dir: str) -> Any:
    if isinstance(node, str) and node.endswith((".yml", ".yaml")):
        try:
            return load_yaml_with_includes(node, base_dir)
        except FileNotFoundError:
            return node  # plain string that happens to end in .yml
    if isinstance(node, str) and _SCI_FLOAT_RE.match(node):
        # PyYAML leaves exponent-without-decimal-point literals like `1e-4`
        # as strings (YAML 1.1 float grammar); configs mean floats
        return float(node)
    if isinstance(node, dict):
        return {k: _resolve_includes(v, base_dir) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_includes(v, base_dir) for v in node]
    return node


def _repo_path(path: str) -> str:
    """`path` as given, or under the repo root when it is relative and only
    exists there (configs name `models/...` from the root)."""
    if not os.path.isabs(path) and not os.path.exists(path):
        rooted = os.path.join(ROOT_DIR, path)
        if os.path.exists(rooted):
            return rooted
    return path


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of `kwargs` that `cls.__init__` names, as the JAX package's
    CLI filters them: keys a class takes only through `**kw` are dropped
    (RandomAudioChunkDryWetDataModule's `seed`, `device_corpus`, ...; an
    open fault of both packages, ROADMAP.md section 3)."""
    accepted = set(inspect.signature(cls.__init__).parameters)
    dropped = [k for k in kwargs if k not in accepted]
    if dropped:
        log.info("%s: ignoring config keys %s", cls.__name__, dropped)
    return {k: v for k, v in kwargs.items() if k in accepted}


def build_model(cfg: Dict[str, Any], data_links: Dict[str, Any], seed: int = 0):
    """Instantiate a model from {class_path, init_args}, linking n_samples/sr
    from the data config when the model accepts them; the initial weights
    of a Spectral2DCNN or a TCN model are drawn from `seed`."""
    cls = MODEL_REGISTRY[cfg["class_path"]]
    args = dict(cfg.get("init_args") or {})
    for key in ("n_samples", "sr"):
        if key in data_links and key not in args:
            args[key] = data_links[key]
    for k in list(args):
        if k in _TUPLE_KEYS and isinstance(args[k], list):
            args[k] = tuple(args[k])
    if cls is RandomLFO and isinstance(args.get("shapes"), list):
        args["shapes"] = tuple(args["shapes"])
    if cls in (Spectral2DCNN, SpectralTCN, SpectralDSTCN):
        args.setdefault("seed", seed)
    if cls is LSTMEffectModel:
        args.setdefault("generator", torch.Generator().manual_seed(seed))
    return cls(**_filter_kwargs(cls, args))


# -- learning-rate schedules: optax's formulas in float32, as optax
# evaluates them (`optax.warmup_cosine_decay_schedule`, `linear_schedule`,
# `join_schedules`)


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count):
        frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    return schedule


def _cosine_decay_schedule(init: float, decay_steps: int, alpha: float) -> Callable[[int], np.float32]:
    if decay_steps <= 0:
        raise ValueError(f"the cosine schedule needs decay_steps > warmup_steps, got {decay_steps}")

    def schedule(count):
        c = np.float32(min(float(count), float(decay_steps)))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c / np.float32(decay_steps)))
        return np.float32(init) * (np.float32(1 - alpha) * cosine + np.float32(alpha))

    return schedule


def _join_schedules(schedules, boundaries) -> Callable[[int], np.float32]:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def build_lr(cfg: Optional[Dict[str, Any]]):
    """Constant lr (a float), or a function of the optimizer update count
    (from 0) when `optimizer.lr_schedule` is set:

        lr_schedule:
          name: cosine | linear   # warmup then decay to end_lr
          warmup_steps: 0         # linear ramp 0 -> lr
          decay_steps: N          # REQUIRED; total optimizer updates
          end_lr: 0.0

    `decay_steps` counts OPTIMIZER UPDATES, not batches: a TBPTT task
    updates once per chunk (`updates_per_batch`, ~83 a 2 s batch)."""
    args = (cfg or {}).get("init_args") or {}
    lr = float(args.get("lr", 1e-4))
    sched = (cfg or {}).get("lr_schedule")
    if not sched:
        return lr
    name = str(sched.get("name", "cosine")).lower()
    warmup = int(sched.get("warmup_steps", 0))
    decay = int(sched["decay_steps"])
    end = float(sched.get("end_lr", 0.0))
    if name == "cosine":
        alpha = 0.0 if lr == 0.0 else end / lr
        parts = [
            _linear_schedule(lr if warmup == 0 else 0.0, lr, warmup),
            _cosine_decay_schedule(lr, decay - warmup, alpha),
        ]
    elif name == "linear":
        parts = [
            _linear_schedule(0.0 if warmup else lr, lr, max(warmup, 1)),
            _linear_schedule(lr, end, max(decay - warmup, 1)),
        ]
    else:
        raise KeyError(f"Unknown lr_schedule name: {name}")
    joined = _join_schedules(parts, [warmup])
    return lambda count: float(joined(int(count)))


def build_optimizer(cfg: Optional[Dict[str, Any]]) -> Callable:
    """torch.optim class from the config: a function of the parameters that
    builds it at the config's (peak) lr.  No config gives the tasks' default
    (`adamw`: lr 1e-4, weight decay 1e-4, optax's default); AdamW from a
    config defaults its weight decay to 0.01, as the JAX package's CLI does.
    A schedule (`build_lr`) is attached by the task."""
    if cfg is None:
        return adamw
    path = cfg.get("class_path", "torch.optim.AdamW")
    args = cfg.get("init_args") or {}
    lr = float(args.get("lr", 1e-4))
    betas = args.get("betas", (0.8, 0.99))
    betas = (float(betas[0]), float(betas[1]))
    wd = float(args.get("weight_decay", 0.01))
    name = path.rsplit(".", 1)[-1].lower()
    if name == "adamw":
        return lambda params: torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if name == "adam":
        return lambda params: torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    if name == "sgd":
        momentum = float(args.get("momentum", 0.0))
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum)
    raise KeyError(f"Unknown optimizer: {path}")


def _load_lfo_weights(model, weights_path: str) -> Dict[str, torch.Tensor]:
    """A bare-weights `.npz` as the state_dict of `model` (a Spectral2DCNN, a
    TCN model or an LSTMEffectModel)."""
    if weights_path.endswith(".pt"):
        raise NotImplementedError(
            f"{weights_path}: a .pt file is not read as bare weights. A checkpoint of the "
            "port (`<out>/<run>_ckpts/best.pt` or `last.pt`) converts to the .npz this key "
            "takes with `python scripts/extract_torch_weights.py <ckpt.pt> <out.npz> "
            "[model|effect_model|lfo_model]`; the reference's .pt checkpoints are not read "
            "by the port (models/torch_port.py is not queued, ROADMAP.md queue 1)"
        )
    if not weights_path.endswith(".npz"):
        raise ValueError(f"unsupported weights format: {weights_path}")
    path = _repo_path(weights_path)
    if isinstance(model, LSTMEffectModel):
        return flax_lstm_to_state_dict(path)
    if isinstance(model, (SpectralTCN, SpectralDSTCN)):
        return tcn_flax_to_state_dict(path)
    if isinstance(model, Spectral2DCNN):
        return flax_to_state_dict(path)
    raise ValueError(
        f"{weights_path}: a bare .npz holds one model; a TBPTT task that trains a param model "
        "or its extractor restores from a checkpoint of the port (last.pt / best.pt)"
    )


def build_data_module(
    data_cfg: Dict[str, Any], custom: Dict[str, Any], seed: int, device: str | torch.device = "cuda"
) -> Tuple[Any, Dict[str, Any]]:
    """Instantiate a data module from {class_path, init_args}, with the CPU
    sizes when `device` is the CPU; returns (module, data_links)."""
    data_args = dict(data_cfg.get("init_args") or {})

    if torch.device(device).type == "cpu":
        cpu_bs = int(custom.get("cpu_batch_size", 5))
        cpu_train = int(custom.get("cpu_train_num_examples_per_epoch", 10))
        cpu_val = int(custom.get("cpu_val_num_examples_per_epoch", 5))
        log.info("CPU: batch_size=%d, epoch sizes=%d/%d", cpu_bs, cpu_train, cpu_val)
        data_args["batch_size"] = cpu_bs
        for k, v in (
            ("train_num_examples_per_epoch", cpu_train),
            ("val_num_examples_per_epoch", cpu_val),
        ):
            if k in data_args:
                data_args[k] = v
        if "shared_train_args" in data_args:
            data_args["shared_train_args"]["num_examples_per_epoch"] = cpu_train
        if "shared_val_args" in data_args:
            data_args["shared_val_args"]["num_examples_per_epoch"] = cpu_val

    dm_cls = DATA_MODULE_REGISTRY[data_cfg["class_path"]]
    data_args.setdefault("seed", seed)
    data_module = dm_cls(**_filter_kwargs(dm_cls, data_args))

    shared = data_args.get("shared_args") or {}
    data_links = {
        "n_samples": data_args.get("n_samples", shared.get("n_samples")),
        "sr": data_args.get("sr", shared.get("sr")),
    }
    return data_module, {k: v for k, v in data_links.items() if v is not None}


class RunConfig:
    """Parsed experiment config + instantiated objects, on `device`."""

    def __init__(self, cfg: Dict[str, Any], device: str | torch.device = "cuda"):
        self.raw = cfg
        self.device = resolve_device(device)
        self.seed = int(cfg.get("seed_everything", 42))
        custom = cfg.get("custom") or {}
        self.project_name = custom.get("project_name", "mod_extraction_tpu")
        self.model_name = custom.get("model_name", "model")
        self.dataset_name = custom.get("dataset_name", "dataset")
        self.run_name = f"{self.model_name}__{self.dataset_name}"
        trainer_cfg = cfg.get("trainer") or {}
        self.max_epochs = int(trainer_cfg.get("max_epochs", 1))
        self.ckpt_path = cfg.get("ckpt_path")

        torch.manual_seed(self.seed)
        self.data_module, self.data_links = build_data_module(
            dict(cfg["data"]), custom, self.seed, self.device
        )
        self.optimizer = build_optimizer(cfg.get("optimizer"))
        self.lr = build_lr(cfg.get("optimizer"))  # float or schedule fn
        self.task = self._build_task(dict(cfg["model"]))

    def _build_task(self, model_cfg: Dict[str, Any]):
        path = model_cfg["class_path"]
        args = dict(model_cfg.get("init_args") or {})
        render_cfg = self.data_module.render_cfg
        schedule = self.lr if callable(self.lr) else None

        if path in TASK_PATHS_LFO:
            model = build_model(args.pop("model"), self.data_links, self.seed)
            return LFOExtractionTask(
                model=model,
                render_cfg=render_cfg,
                optimizer=self.optimizer,
                lr_schedule=schedule,
                use_dry=args.get("use_dry", True),
                model_smooth_n_frames=args.get("model_smooth_n_frames", 4),
                should_stretch=args.get("should_stretch", False),
                max_n_corners=args.get("max_n_corners", 16),
                stretch_smooth_n_frames=args.get("stretch_smooth_n_frames", 0),
                sub_batch_size=args.get("sub_batch_size"),
                loss_dict=args.get("loss_dict"),
                device=self.device,
                seed=self.seed,
            )
        if path in TASK_PATHS_TBPTT:
            param_cfg = args.pop("param_model", None)
            # the task sets its n_samples to the cropped clip's, as JAX's does
            param_model = build_model(param_cfg, self.data_links, self.seed) if param_cfg else None
            effect_model = build_model(args.pop("effect_model"), self.data_links, self.seed)
            lfo_model = None
            lfo_cfg = args.pop("lfo_model", None)
            if lfo_cfg is not None:
                lfo_model = build_model(lfo_cfg, self.data_links, self.seed)
                wp = args.get("lfo_model_weights_path")
                if wp and not isinstance(lfo_model, RandomLFO):
                    lfo_model.load_state_dict(_load_lfo_weights(lfo_model, wp))
                # without weights the extractor keeps its seeded random init
            return TBPTTEffectModelingTask(
                effect_model=effect_model,
                render_cfg=render_cfg,
                warmup_n_samples=args.get("warmup_n_samples", 1024),
                step_n_samples=args.get("step_n_samples", 1024),
                lfo_model=lfo_model,
                freeze_lfo_model=args.get("freeze_lfo_model", True),
                param_model=param_model,
                optimizer=self.optimizer,
                lr_schedule=schedule,
                use_dry=args.get("use_dry", True),
                model_smooth_n_frames=args.get("model_smooth_n_frames", 8),
                should_stretch=args.get("should_stretch", True),
                max_n_corners=args.get("max_n_corners", 16),
                stretch_smooth_n_frames=args.get("stretch_smooth_n_frames", 0),
                discard_invalid_lfos=args.get("discard_invalid_lfos", True),
                loss_dict=args.get("loss_dict"),
                device=self.device,
                seed=self.seed,
            )
        raise KeyError(f"Unknown task class_path: {path}")


def _load_config(config: str | Dict[str, Any]) -> Dict[str, Any]:
    return load_yaml_with_includes(config) if isinstance(config, str) else config


def _media_callback_for(run: RunConfig) -> Optional[Callable]:
    """The media hook of `custom.log_media` (spectrograms and LFO overlays
    for the extractor, waveforms and audio for the effect model; written
    to `<out_dir>/<run>_media/ep<epoch>/`), or None.  matplotlib is imported
    only here: without it, `log_media: true` raises."""
    if not (run.raw.get("custom") or {}).get("log_media", False):
        return None
    try:
        from mod_extraction_tpu_torch.utils import plotting
    except ModuleNotFoundError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        raise ImportError(
            "custom.log_media: true needs matplotlib, which is not installed; install it or "
            "set log_media: false"
        ) from e
    if isinstance(run.task, TBPTTEffectModelingTask):
        return plotting.em_media_callback()
    return plotting.lfo_media_callback()


def fit(
    config: str | Dict[str, Any],
    out_dir: str = "out",
    resume: bool = False,
    max_epochs: Optional[int] = None,
    device: str | torch.device = "cuda",
    sync_copies: bool = False,
    profile_steps: tuple = (10, 15),
):
    """Train as the config says; `config` is a path or an already-loaded
    dict.  Returns the trained task.  `sync_copies` and `profile_steps` (the
    window profiled when `custom.profile_dir` is set) as in `Trainer`.
    Under torchrun (or inside a process group) every rank trains on its
    share of each batch (`parallel/dist.py`)."""
    with process_group(device):
        return _fit(config, out_dir, resume, max_epochs, device, sync_copies, profile_steps)


def _fit(config, out_dir, resume, max_epochs, device, sync_copies, profile_steps):
    run = RunConfig(_load_config(config), device)
    custom = run.raw.get("custom") or {}
    # `custom.init_weights_path`: warm-start a fresh run from a bare
    # models/*.npz export; a resumable `last` checkpoint wins
    warm_start = None
    init_wp = custom.get("init_weights_path")
    if init_wp and getattr(run.task, "multi_params", False):
        # as the JAX CLI: a bare export holds one model, and a TBPTT task that
        # also trains a param model or its extractor resumes from checkpoints only
        log.warning("custom.init_weights_path ignored: %s trains several parts", type(run.task).__name__)
    elif init_wp and isinstance(run.task, (LFOExtractionTask, TBPTTEffectModelingTask)):
        # loaded only if no `last` checkpoint is resumed
        warm_start = lambda: _load_lfo_weights(run.task.trained_model, init_wp)  # noqa: E731
    # `custom.steps_per_dispatch` is accepted and has no effect: in the JAX
    # package it groups compiled steps into one dispatch, and a Python loop
    # of steps gains nothing from grouping
    display_lr = run.lr
    if callable(run.lr):
        # the schedule advances once per OPTIMIZER update; the step log
        # counts batches, so rescale for TBPTT's inner updates a batch
        upb = 1
        if isinstance(run.task, TBPTTEffectModelingTask):
            upb = run.task.updates_per_batch
        display_lr = lambda step, _f=run.lr, _u=upb: float(_f(step * _u))  # noqa: E731
    trainer = Trainer(
        run.task,
        run.data_module,
        max_epochs=max_epochs if max_epochs is not None else run.max_epochs,
        out_dir=out_dir,
        run_name=run.run_name,
        resume=resume,
        media_callback=_media_callback_for(run),
        media_every_n_epochs=int(custom.get("media_every_n_epochs", 10)),
        log_every_n_steps=int(custom.get("log_every_n_steps", 50)),
        lr=display_lr,
        profile_dir=custom.get("profile_dir"),
        profile_steps=profile_steps,
        warm_start_params=warm_start,
        sync_copies=sync_copies,
    )
    return trainer.fit()


def _load_eval_state(run: RunConfig, trainer: Trainer, ckpt_path: Optional[str]) -> None:
    """Load `ckpt_path` into the task for validation: a bare-weights `.npz`
    of its model, or a checkpoint of the port (`last`, `best`, or the path
    of a `.pt` state file)."""
    if not getattr(run.task, "has_params", True) or not ckpt_path:
        return  # the RandomLFO baseline has nothing to load
    if ckpt_path.endswith((".npz", ".pt")) and not os.path.isfile(_repo_path(ckpt_path)):
        log.warning("ckpt_path %s not found; validating with random init", ckpt_path)
        return
    if ckpt_path.endswith(".npz"):
        model = run.task.trained_model
        model.load_state_dict(_load_lfo_weights(model, ckpt_path))
    elif trainer.ckpts.restore(ckpt_path, run.task) is None:
        log.warning("checkpoint %s not found; validating with random init", ckpt_path)
    check_replicated(run.task.trained_model.parameters())


def _save_latents(run: RunConfig, trainer: Trainer, out_dir: str) -> None:
    """`custom.save_latents`: the Spectral2DCNN latents of one val batch to
    `<out_dir>/latents/<dataset_name>.npy` (for
    `scripts/latent_space_visualizations.py`, a PCA per effect class)."""
    run.data_module.setup("validate")
    batch = next(run.data_module.val_loader().epoch(0))
    batch = _tree_map(lambda t: t.to(run.device), host_batch_to_torch(batch))
    task = run.task
    task.model.eval()
    with torch.no_grad():
        dry, wet, _, fx = render_batch(batch, task.render_cfg, trainer.corpus)
        _, latent = task._extract(dry, wet, fx, None)
    latents_dir = ensure_dir(os.path.join(out_dir, "latents"))
    np.save(os.path.join(latents_dir, f"{run.dataset_name}.npy"), latent.float().cpu().numpy())


def validate(
    config: str | Dict[str, Any],
    out_dir: str = "out",
    device: str | torch.device = "cuda",
    ckpt_path: Optional[str] = None,
) -> Dict[str, float]:
    """Validation run over the config's val set, with the weights of
    `ckpt_path` (default: the config's `ckpt_path`); prints the eval table
    (the archived `eval/*.txt` format) and returns the metrics.  Under
    torchrun the val batches are sharded and rank 0 prints and writes."""
    with process_group(device):
        run = RunConfig(_load_config(config), device)
        trainer = Trainer(run.task, run.data_module, out_dir=out_dir, run_name=run.run_name + "_eval",
                          media_callback=_media_callback_for(run))
        _load_eval_state(run, trainer, ckpt_path or run.ckpt_path)
        metrics = trainer.validate()
        if trainer.is_chief:
            custom = run.raw.get("custom") or {}
            if custom.get("save_latents", False) and isinstance(run.task, LFOExtractionTask) \
                    and run.task.has_params:
                _save_latents(run, trainer, out_dir)
            print(format_validate_table({f"val/{k}": v for k, v in metrics.items()}))
        return metrics


def validate_many(variants: list, out_dir: str = "out", device: str | torch.device = "cuda") -> list:
    """Validate several (label, cfg) variants of one experiment config with
    one task; returns [(label, metrics), ...].

    The task is built once from the first cfg.  Each variant may swap the
    data block (the per-shape LFO sweeps) and/or `ckpt_path` (the em-sim
    suite's per-effect checkpoints); a variant that changes the model block
    or the RenderConfig raises `AssertionError`.  Weights load only when
    `ckpt_path` changes, each time from the task's initial weights (so a
    variant without one validates the seeded init, as in the JAX package);
    the RandomLFO baseline loads nothing.  The task's generator restarts
    from the seed for each variant, so every variant's metrics are those of
    `validate` on its config alone."""
    with process_group(device):
        return _validate_many(variants, out_dir, device)


def _validate_many(variants: list, out_dir: str, device: str | torch.device) -> list:
    assert variants
    results = []
    run: Optional[RunConfig] = None
    first_model_cfg = None
    initial = None
    last_ckpt: Any = object()  # sentinel != any real path/None
    for label, cfg in variants:
        custom = cfg.get("custom") or {}
        if run is None:
            run = RunConfig(cfg, device)
            dm = run.data_module
            first_model_cfg = cfg.get("model")
            if run.task.has_params:
                initial = {k: v.detach().clone() for k, v in run.task.trained_model.state_dict().items()}
        else:
            # only data/ckpt may vary: the task (model block) is reused, so
            # differing model configs would give tables for the wrong model
            assert cfg.get("model") == first_model_cfg, (
                f"variant {label!r} changes the model block; it needs its "
                "own validate()/validate_many() run"
            )
            dm, _ = build_data_module(dict(cfg["data"]), custom, run.seed, run.device)
            assert dm.render_cfg == run.task.render_cfg, (
                f"variant {label!r} changes the render config; it needs its "
                "own validate() run"
            )
        trainer = Trainer(run.task, dm, out_dir=out_dir, run_name=run.run_name + "_eval")
        ckpt = cfg.get("ckpt_path")
        if ckpt != last_ckpt:
            if initial is not None:
                run.task.trained_model.load_state_dict(initial)
            _load_eval_state(run, trainer, ckpt)
            last_ckpt = ckpt
        run.task.generator.manual_seed(run.seed)
        results.append((label, trainer.validate()))
    return results
