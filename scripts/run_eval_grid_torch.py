"""Run the eval-config grid with the PyTorch port and archive the metric
tables (the counterpart of `scripts/run_eval_grid.py`): the same grid,
variants, labels and block layout, written byte for byte as the JAX script
writes them for the same metrics.

Usage: python scripts/run_eval_grid_torch.py [--per-shape] [--em-sim]
           [--rand-suite] [--unseen-audio] [--device cuda|cpu]
           [out_dir] [config ...]
Writes one `<config_name>.txt` per eval config (default out_dir
`out/eval`); a failing block is archived as `FAILED` with its traceback
instead of aborting the grid.  `--per-shape` adds one labelled table per
pinned LFO shape before the all-shapes table; `--em-sim` runs the
effect-model suite over the sim corpora (`make_sim_effect_data_torch.py`,
`make_sim_chorus_gt_control_torch.py`): per effect the extractor-driven
LSTM-64 table, then the random-LFO baseline's, then the effect's label, and
after them the ground-truth control, LSTM-160 capacity and sim_chorus3
seed-2 blocks; `--rand-suite` the 23 RandomLFO anchor tables;
`--unseen-audio` the 3 effects x 5 domains x {fixed, varying} sweep over
`data/unseen_<domain>/val`.  Runs on the card unless `--device cpu` (the
configs' `custom.cpu_*` sizes).
"""

import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEFAULT_GRID = [
    "eval_lfo.yml",
    "eval_lfo_varying.yml",
    "eval_lfo_flanger.yml",
    "eval_lfo_flanger_varying.yml",
    "eval_lfo_chorus.yml",
    "eval_lfo_chorus_varying.yml",
    "eval_lfo_quasi.yml",
    "eval_lfo_distorted.yml",
    "eval_lfo_combined.yml",
    "eval_lfo_rand.yml",
    "eval_lfo_unseen_audio.yml",
    "eval_em_unseen_effect.yml",
]


def _shape_variants(cfg):
    """Yield (label, cfg) per pinned LFO shape + the all-shapes run."""
    import copy

    ms = (
        cfg.get("data", {})
        .get("init_args", {})
        .get("fx_config", {})
        .get("mod_sig", {})
    )
    shapes = ms.get("shapes")
    if not shapes:
        yield "", cfg
        return
    for shape in shapes:
        c = copy.deepcopy(cfg)
        c["data"]["init_args"]["fx_config"]["mod_sig"]["shapes"] = [shape]
        yield shape, c
    yield "all", cfg


# Block labels of the archived `eval/*.txt` banners, so the tables line up
# with the archive table for table.  The quasi/distorted labels keep the
# archive's literal "exp 2.0" prefix.
PER_SHAPE_LABEL = {
    "eval_lfo.yml": "eval ph idmt_4 {shape} fixed",
    "eval_lfo_varying.yml": "eval ph idmt_4 {shape} varying",
    "eval_lfo_flanger.yml": "eval fl idmt_4 {shape} fixed",
    "eval_lfo_flanger_varying.yml": "eval fl idmt_4 {shape} varying",
    "eval_lfo_chorus.yml": "eval ch idmt_4 {shape} fixed",
    "eval_lfo_chorus_varying.yml": "eval ch idmt_4 {shape} varying",
}
TWO_EFFECT_LABEL = {
    "eval_lfo_quasi.yml": "eval exp 2.0 {eff} quasi {shape}",
    "eval_lfo_distorted.yml": "eval exp 2.0 {eff} {shape}",
}
RAND_PREFIX = "eval rand correct shape freq 25% phase 50%"


def _chorus_variant(cfg):
    """Swap a flanger-regime eval config's delay block for the pinned chorus
    regime of `eval_lfo_chorus.yml` (30 ms max_min_delay, 10 ms
    max_lfo_delay, parameters pinned); the mod_sig condition is kept."""
    import copy

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    ch = load_yaml_with_includes("eval_lfo_chorus.yml")
    ch = ch["data"]["init_args"]["fx_config"]["flanger"]
    c = copy.deepcopy(cfg)
    c["data"]["init_args"]["fx_config"]["flanger"] = copy.deepcopy(ch)
    return c


def _config_groups(name, cfg, per_shape):
    """[[(label, cfg), ...], ...]: one inner list per validate_many call
    (the variants of a group share one RenderConfig; the chorus delay
    regime changes it, so fl and ch are separate groups).

    quasi/distorted: 7 flanger + 7 chorus tables; combined: fl/ch x {4
    symmetric shapes, all}; the seen-audio configs: per shape + all."""
    import copy

    base = os.path.basename(name)
    if not per_shape:
        return [[("", cfg)]]
    if base in TWO_EFFECT_LABEL:
        tmpl = TWO_EFFECT_LABEL[base]
        return [
            [
                (tmpl.format(eff=eff, shape=lb or "cos"), v)
                for lb, v in _shape_variants(c)
            ]
            for eff, c in (("fl", cfg), ("ch", _chorus_variant(cfg)))
        ]
    if base == "eval_lfo_combined.yml":
        groups = []
        for eff, c in (("fl", cfg), ("ch", _chorus_variant(cfg))):
            sym = copy.deepcopy(c)
            sym["data"]["init_args"]["fx_config"]["mod_sig"]["shapes"] = list(
                SYMMETRICAL_SHAPES
            )
            groups.append([
                (f"eval exp 2.0 {eff} combined 4 shapes", sym),
                (f"eval exp 2.0 {eff} combined all", c),
            ])
        return groups
    tmpl = PER_SHAPE_LABEL.get(base)
    return [[
        (tmpl.format(shape=lb or "cos") if tmpl else lb, v)
        for lb, v in _shape_variants(cfg)
    ]]


# The rand-anchor suite (the archive's eval_lfo_rand.txt: 23 tables over 4
# conditions): the RandomLFO baseline scored against each condition's GT
# mod-sig distribution, independent of audio content and checkpoints.
RAND_CONDITIONS = [
    ("", None),  # base: eval_lfo_rand.yml's own mod_sig block
    ("quasi", "eval_lfo_quasi.yml"),
    ("distorted", "eval_lfo_distorted.yml"),
    ("combined", "eval_lfo_combined.yml"),
]

# the "combined symmetrical" table's shape pool: the waveforms with mirror
# symmetry (saw/rsaw are the asymmetric two)
SYMMETRICAL_SHAPES = ["cos", "tri", "rect_cos", "inv_rect_cos"]


def _rand_suite_variants(base_cfg):
    """Yield (label, cfg) for all 23 rand tables.  Every variant shares the
    RandomLFO model block and the audio-only data module (only the mod-sig
    distribution changes), so one validate_many call serves the suite."""
    import copy

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    for cond, src in RAND_CONDITIONS:
        cfg = copy.deepcopy(base_cfg)
        if src is not None:
            ms = load_yaml_with_includes(src)
            ms = ms["data"]["init_args"]["fx_config"]["mod_sig"]
            cfg["data"]["init_args"]["fx_config"]["mod_sig"] = copy.deepcopy(ms)
        if cond == "combined":
            sym = copy.deepcopy(cfg)
            sym["data"]["init_args"]["fx_config"]["mod_sig"]["shapes"] = list(
                SYMMETRICAL_SHAPES
            )
            yield f"{RAND_PREFIX} combined symmetrical", sym
            yield f"{RAND_PREFIX} combined all", cfg
        else:
            for label, c in _shape_variants(cfg):
                yield f"{RAND_PREFIX} {cond} {label}".replace("  ", " "), c


# The unseen-audio sweep (the archive's eval_lfo_unseen_audio.txt: 3
# effects x 5 domains x {fixed, varying}) over the synthetic domains
# `scripts/make_synthetic_corpus.py --style <d>` writes to
# data/unseen_<d>/val, in the archive's block order.
UNSEEN_DOMAINS = ("pads", "vocal", "drums", "bass", "keys")
UNSEEN_EFFECT_CONFIGS = [
    ("ph", "fixed", "eval_lfo.yml"),
    ("ph", "varying", "eval_lfo_varying.yml"),
    ("fl", "fixed", "eval_lfo_flanger.yml"),
    ("ch", "fixed", "eval_lfo_chorus.yml"),
    ("fl", "varying", "eval_lfo_flanger_varying.yml"),
    ("ch", "varying", "eval_lfo_chorus_varying.yml"),
]


def _unseen_audio_groups():
    """Yield (group_label, [(label, cfg), ...]): one group per effect and
    condition (one model and RenderConfig across its domains, so one
    validate_many call); cfg is None for a domain not generated."""
    import copy

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    for eff, cond, cfg_name in UNSEEN_EFFECT_CONFIGS:
        base = load_yaml_with_includes(cfg_name)
        variants = []
        for domain in UNSEEN_DOMAINS:
            d = f"data/unseen_{domain}/val"
            if not os.path.isdir(d):
                variants.append((f"eval {eff} {domain} {cond}", None))
                continue
            c = copy.deepcopy(base)
            c["data"]["init_args"]["train_dir"] = d
            c["data"]["init_args"]["val_dir"] = d
            variants.append((f"eval {eff} {domain} {cond}", c))
        yield f"{eff} {cond}", variants


# (effect, baseline lfo_model config) for the --em-sim suite; LFO bands as
# scripts/make_sim_effect_data_torch.py renders them
EM_SIM_EFFECTS = [
    ("sim_chorus", "configs/models/baseline_sim_chorus.yml"),
    ("sim_chorus2", "configs/models/baseline_sim_chorus.yml"),  # 5-10 ms sweep
    ("sim_chorus3", "configs/models/baseline_sim_chorus.yml"),  # + level modulation
    ("sim_chorus4", "configs/models/baseline_sim_chorus.yml"),  # level modulation dominant
    ("sim_flanger", "configs/models/baseline_sim_flanger.yml"),
    ("sim_flanger2", "configs/models/baseline_sim_flanger.yml"),  # sharper, fully wet comb
    ("sim_phaser", "configs/models/baseline_melda_irregular.yml"),
]


def _em_sim_variants(base_cfg):
    """Yield (label, cfg) pairs: per effect, the extractor-driven LSTM then
    the random-LFO baseline (two tables per label, label after its tables).

    The lstm variants share one task (only data dirs + ckpt change); the
    rand variants each carry a different RandomLFO band, i.e. a different
    task, so each goes through its own validate_many call."""
    import copy
    import re

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    # the LSTM rows take the base config's ckpt naming with the effect
    # swapped, so repointing eval_em_sim.yml at another extractor's model
    # family repoints the whole suite
    base_ckpt = base_cfg.get("ckpt_path", "models/lstm_64__lfo_2dcnn_r3__sim_chorus.npz")
    lstm_stem = re.sub(r"__sim_\w+\.npz$", "", base_ckpt)
    for effect, baseline_model in EM_SIM_EFFECTS:
        for kind in ("lstm", "rand"):
            c = copy.deepcopy(base_cfg)
            da = c["data"]["init_args"]
            for k in ("dry_train_dir", "dry_val_dir"):
                da[k] = f"data/{effect}/val/dry"
            for k in ("wet_train_dir", "wet_val_dir"):
                da[k] = f"data/{effect}/val/wet"
            ma = c["model"]["init_args"]
            if kind == "lstm":
                c["ckpt_path"] = f"{lstm_stem}__{effect}.npz"
            else:
                c["ckpt_path"] = f"models/rand_baseline__{effect}.npz"
                # base_cfg is include-resolved, so the baseline model config
                # is resolved here too
                ma["lfo_model"] = load_yaml_with_includes(baseline_model)
                ma.pop("lfo_model_weights_path", None)
                ma["model_smooth_n_frames"] = 0
                ma["should_stretch"] = False
                ma["discard_invalid_lfos"] = False
            yield f"{effect}__{kind}", c


# The archive's 7 unseen-effect blocks (eval_em_unseen_effect.txt):
# (label, imported LSTM stem, required data dirs, archived LSTM esr,
# archived rand esr)
EM_UNSEEN_BLOCKS = [
    ("egfx phaser", "egfx_ph_2_peak",
     ["data/egfx_clean_44100/test", "data/egfx_phaser_44100/test"],
     0.4247, 0.7760),
    ("egfx flanger", "egfx_fl_2_peak",
     ["data/egfx_clean_44100/test", "data/egfx_flanger_44100/test"],
     0.9409, 0.9493),
    ("egfx chorus", "egfx_ch_2_peak",
     ["data/egfx_clean_44100/test", "data/egfx_chorus_44100/test"],
     0.5938, 0.8226),
    ("melda phaser irregular", "melda_ph_irregular",
     ["data/melda_ph_irregular/test/dry", "data/melda_ph_irregular/test/wet"],
     0.0824, 0.7869),
    ("melda flanger irregular", "melda_fl_irregular",
     ["data/melda_fl_irregular/test/dry", "data/melda_fl_irregular/test/wet"],
     0.1810, 0.4458),
    ("melda phaser quasi", "melda_ph_quasi",
     ["data/melda_ph_quasi/test/dry", "data/melda_ph_quasi/test/wet"],
     0.2176, 0.6107),
    ("melda flanger quasi", "melda_fl_quasi",
     ["data/melda_fl_quasi/test/dry", "data/melda_fl_quasi/test/wet"],
     0.1369, 0.5069),
]


def build_em_unseen_stub(device="cuda"):
    """The unseen-effect suite's accounting when the EGFx / Melda corpora
    are absent: each imported LSTM-64 checkpoint loads
    (`load_lstm_effect_model`) and serves a forward pass on `device` (K3 on
    the card; recorded with its output rms), and each block lists the data
    it still needs beside the archived esr."""
    import numpy as np
    import torch

    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model
    from mod_extraction_tpu_torch.models.lstm import lstm_init_state

    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((2, 1, 8820))).astype(np.float32)
    lat = rng.uniform(0, 1, (2, 1, 8820)).astype(np.float32)

    lines = [
        "Unseen-effect suite: EGFx / Melda audio is not present in this",
        "environment, so the reference's 14 tables cannot be reproduced",
        "here.  What IS verifiable without the audio is archived below:",
        "all 7 reference LSTM-64 checkpoints are imported and serve a",
        "forward pass (full-precision parity with the reference weights is",
        "pinned by tests/test_reference_ckpt_parity.py, atol 2e-6).  The",
        "in-environment analog suite — 4 device-rendered unseen effects,",
        "LSTM vs rand baseline, plus the ground-truth-conditioning",
        "control — is archived in eval_em_sim.txt.",
        "",
    ]
    stem = "models/lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__"
    for label, name, dirs, ref_lstm, ref_rand in EM_UNSEEN_BLOCKS:
        ckpt = f"{stem}{name}.npz"
        if os.path.isfile(ckpt):
            model = load_lstm_effect_model(ckpt, device=device).eval()
            with torch.no_grad():
                y, _ = model(
                    torch.from_numpy(x).to(device), torch.from_numpy(lat).to(device),
                    lstm_init_state(2, model.n_hidden, device),
                )
            status = (
                f"ckpt imported + forward OK (out rms {float(torch.sqrt(torch.mean(y**2))):.4f})"
            )
        else:
            status = f"ckpt MISSING ({ckpt})"
        missing = [d for d in dirs if not os.path.isdir(d)]
        lines.append(
            f"{label}: {status}; needs {', '.join(missing) if missing else 'nothing'}; "
            f"reference archive esr {ref_lstm:.4f} (lstm) / {ref_rand:.4f} (rand)"
        )
    lines.append("")
    lines.append(
        "To reproduce: place the corpora per README 'Reproducing the paper"
    )
    lines.append(
        "experiments', then run scripts/run_eval_grid.py eval eval_em_unseen_effect.yml"
    )
    return ["\n".join(lines) + "\n"]


# (label, gtctrl train config, gt ckpt, gt corpus, rand ckpt): chorus
# (11-19 ms), chorus2 (5-10 ms) and chorus4 (level modulation dominant)
GT_CONTROL_REGIMES = [
    (
        "sim_chorus",
        "train_em_sim_chorus_gtctrl.yml",
        "models/lstm_64__gt_mod_sig__sim_chorus_gt.npz",
        "data/sim_chorus_gt/val",
        "models/rand_baseline__sim_chorus.npz",
    ),
    (
        "sim_chorus2",
        "train_em_sim_chorus2_gtctrl.yml",
        "models/lstm_64__gt_mod_sig__sim_chorus2_gt.npz",
        "data/sim_chorus2_gt/val",
        "models/rand_baseline__sim_chorus2.npz",
    ),
    (
        "sim_chorus4",
        "train_em_sim_chorus4_gtctrl.yml",
        "models/lstm_64__gt_mod_sig__sim_chorus4_gt.npz",
        "data/sim_chorus4_gt/val",
        "models/rand_baseline__sim_chorus4.npz",
    ),
]


def build_gt_control_blocks(validate_many, table):
    """The ground-truth-conditioning control blocks: the LSTM-64
    conditioned on the true mod signal over the preprocessed GT corpus,
    paired with the shipped rand baseline on the same corpus (GT ~= rand
    means a capacity floor, GT << rand a conditioning fault).  SKIPPED with
    a pointer while a regime's checkpoint or corpus is absent
    (scripts/make_sim_chorus_gt_control_torch.py + its gtctrl config)."""
    import copy

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    blocks = []
    for label, cfg_name, ckpt, corpus, rand_ckpt in GT_CONTROL_REGIMES:
        missing = [
            p for p in (ckpt, corpus, rand_ckpt) if not os.path.exists(p)
        ]
        if missing:
            blocks.append(
                f"SKIPPED ({label} gt control not trained): "
                + "; ".join(missing) + f" — see configs/{cfg_name}\n"
            )
            continue
        base = load_yaml_with_includes(cfg_name)
        gt = copy.deepcopy(base)
        gt["ckpt_path"] = ckpt
        rand = copy.deepcopy(base)
        rand["ckpt_path"] = rand_ckpt
        rand["model"]["init_args"]["lfo_model"] = load_yaml_with_includes(
            "configs/models/baseline_sim_chorus.yml"
        )
        try:
            # different model blocks (GT path vs RandomLFO) -> different
            # tasks -> one validate_many call each
            gt_metrics = validate_many([("gt", gt)])[0][1]
            rand_metrics = validate_many([("rand", rand)])[0][1]
            blocks.append(table(gt_metrics))
            blocks.append(f"{table(rand_metrics)}\n{label} gt control\n")
        except Exception:
            blocks.append(
                f"FAILED ({label} gt control):\n{traceback.format_exc()}"
            )
    return blocks


# (label, conditioned train cfg, conditioned ckpt, rand train cfg, rand
# ckpt) for the capacity bracket below
H160_PAIRS = [
    (
        "sim_chorus h160 capacity bracket",
        "train_em_sim_chorus_h160.yml",
        "models/lstm_160__lfo_2dcnn_r6__sim_chorus.npz",
        "train_baseline_em_sim_chorus_h160.yml",
        "models/rand_baseline_160__sim_chorus.npz",
    ),
]


def build_h160_capacity_blocks(validate_many, table):
    """The LSTM-160 capacity bracket in the sim_chorus regime: the
    extractor-conditioned LSTM-160 beside its band-matched rand baseline
    (an N-ms fractional delay line needs about 44.1 N samples of carried
    state, beyond 64 hidden units).  K3 runs on the H 160 cluster forward
    on the card.  SKIPPED while a checkpoint is absent."""
    import copy

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    blocks = []
    for label, lstm_cfg_name, lstm_ckpt, rand_cfg_name, rand_ckpt in H160_PAIRS:
        missing = [p for p in (lstm_ckpt, rand_ckpt) if not os.path.exists(p)]
        if missing:
            blocks.append(
                f"SKIPPED ({label} not trained): " + "; ".join(missing)
                + f" — see configs/{lstm_cfg_name}\n"
            )
            continue
        try:
            lstm = copy.deepcopy(load_yaml_with_includes(lstm_cfg_name))
            lstm["ckpt_path"] = lstm_ckpt
            rand = copy.deepcopy(load_yaml_with_includes(rand_cfg_name))
            rand["ckpt_path"] = rand_ckpt
            # different model blocks (extractor path vs RandomLFO) ->
            # different tasks -> one validate_many call each
            lstm_metrics = validate_many([("h160", lstm)])[0][1]
            rand_metrics = validate_many([("h160 rand", rand)])[0][1]
            blocks.append(table(lstm_metrics))
            blocks.append(f"{table(rand_metrics)}\n{label}\n")
        except Exception:
            blocks.append(f"FAILED ({label}):\n{traceback.format_exc()}")
    return blocks


def build_chorus3_s2_blocks(cfg, validate_many, table):
    """The seed-2 replication of the sim_chorus3 separation: the seed-45
    re-run of the same recipe under the main sim_chorus3 block's protocol
    (eval_em_sim.yml base, 256 val examples, seed 47), so the two seeds
    compare directly.  SKIPPED while a checkpoint is absent."""
    import copy

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    lstm_ckpt = "models/lstm_64__lfo_2dcnn_r6__sim_chorus3_s2.npz"
    rand_ckpt = "models/rand_baseline__sim_chorus3_s2.npz"
    missing = [p for p in (lstm_ckpt, rand_ckpt) if not os.path.exists(p)]
    if missing:
        return [
            "SKIPPED (sim_chorus3 seed-2 replication not trained): "
            + "; ".join(missing)
            + " — see configs/train_em_sim_chorus3_s2.yml\n"
        ]
    blocks = []
    lstm = copy.deepcopy(cfg)
    da = lstm["data"]["init_args"]
    for k in ("dry_train_dir", "dry_val_dir"):
        da[k] = "data/sim_chorus3/val/dry"
    for k in ("wet_train_dir", "wet_val_dir"):
        da[k] = "data/sim_chorus3/val/wet"
    rand = copy.deepcopy(lstm)
    lstm["ckpt_path"] = lstm_ckpt
    rand["ckpt_path"] = rand_ckpt
    ma = rand["model"]["init_args"]
    ma["lfo_model"] = load_yaml_with_includes(
        "configs/models/baseline_sim_chorus.yml"
    )
    ma.pop("lfo_model_weights_path", None)
    ma["model_smooth_n_frames"] = 0
    ma["should_stretch"] = False
    ma["discard_invalid_lfos"] = False
    try:
        lstm_metrics = validate_many([("c3s2", lstm)])[0][1]
        rand_metrics = validate_many([("c3s2 rand", rand)])[0][1]
        blocks.append(table(lstm_metrics))
        blocks.append(
            f"{table(rand_metrics)}\nsim_chorus3 seed-2 replication\n"
        )
    except Exception:
        blocks.append(
            f"FAILED (sim_chorus3 s2):\n{traceback.format_exc()}"
        )
    return blocks


def build_em_sim_blocks(cfg, validate_many, table):
    """The em-sim archive blocks (lstm table, rand table, effect label) with
    per-effect availability checks and error isolation: one missing corpus
    or checkpoint skips only its own block."""
    blocks = []
    by_effect = {}
    for lb, c in _em_sim_variants(cfg):
        eff, kind = lb.rsplit("__", 1)
        by_effect.setdefault(eff, {})[kind] = (lb, c)
    avail, skipped = [], {}
    for effect, _ in EM_SIM_EFFECTS:
        missing = []
        if not os.path.isdir(f"data/{effect}/val/dry"):
            missing.append(
                f"data/{effect} (scripts/make_sim_effect_data.py {effect})"
            )
        for kind in ("lstm", "rand"):
            p = by_effect[effect][kind][1]["ckpt_path"]
            if not os.path.isfile(p):
                missing.append(p)
        (skipped.setdefault(effect, missing) if missing
         else avail.append(effect))
    try:
        # the lstm variants share one task -> one grouped call
        lstm = dict(
            validate_many([by_effect[e]["lstm"] for e in avail])
        ) if avail else {}
    except Exception:
        # per-effect lstm runs, so one bad variant cannot take down the rest
        lstm = {}
        for e in avail:
            try:
                lstm.update(validate_many([by_effect[e]["lstm"]]))
            except Exception:
                skipped[e] = [f"lstm eval failed:\n{traceback.format_exc()}"]
    for effect, _ in EM_SIM_EFFECTS:
        if effect in skipped:
            blocks.append(
                f"SKIPPED (missing): {effect} — "
                + "; ".join(skipped[effect]) + "\n"
            )
            continue
        try:
            rand = validate_many([by_effect[effect]["rand"]])[0][1]
        except Exception:
            blocks.append(
                f"FAILED ({effect} rand):\n{traceback.format_exc()}"
            )
            continue
        blocks.append(table(lstm[f"{effect}__lstm"]))
        blocks.append(f"{table(rand)}\n{effect}\n")
    return blocks


FLAGS = ("--per-shape", "--em-sim", "--rand-suite", "--unseen-audio")


def split_argv(argv):
    """(device, flags, positionals): `--device <value>` (default cuda), the
    mode flags given, and the rest (`[out_dir] [config ...]`)."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value")
        device = argv[i + 1]
        del argv[i : i + 2]
    return device, {f for f in FLAGS if f in argv}, [a for a in argv if a not in FLAGS]


def main(argv, validate_many=None):
    """Run the grid `argv` asks for; returns the paths written.
    `validate_many` (default: the port's `cli.validate_many` on the device
    asked for) takes [(label, cfg), ...] and returns [(label, metrics), ...]."""
    import functools

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.evaluation.tables import (
        format_eval_block,
        format_validate_table,
    )
    from mod_extraction_tpu_torch.paths import ensure_dir

    device, flags, args = split_argv(argv)
    if validate_many is None:
        validate_many = functools.partial(cli.validate_many, device=device)

    def table(metrics):
        return format_validate_table({f"val/{k}": v for k, v in metrics.items()})

    def block(metrics, label):
        """Banner-labelled block; a bare table when the run has no label."""
        m = {f"val/{k}": v for k, v in metrics.items()}
        return format_eval_block(m, label) if label else format_validate_table(m)

    per_shape = "--per-shape" in flags
    em_sim = "--em-sim" in flags
    rand_suite = "--rand-suite" in flags
    out_dir = ensure_dir(args[0] if args else "out/eval")
    written = []
    if "--unseen-audio" in flags:
        # the domain sweep has its own grouping
        target = os.path.join(out_dir, "eval_lfo_unseen_audio.txt")
        print(f"=== unseen-audio sweep -> {target}")
        blocks = []
        for group, variants in _unseen_audio_groups():
            live = [(lb, c) for lb, c in variants if c is not None]
            try:
                results = dict(validate_many(live)) if live else {}
            except Exception:
                blocks.append(f"FAILED ({group}):\n{traceback.format_exc()}")
                continue
            for label, c in variants:
                if c is None:
                    domain = label.split()[2]  # "eval <eff> <domain> <cond>"
                    blocks.append(
                        f"SKIPPED (missing corpus): {label} — generate with "
                        "scripts/make_synthetic_corpus.py "
                        f"data/unseen_{domain} 0 10 12 "
                        f"--style {domain}\n"
                    )
                else:
                    blocks.append(block(results[label], label))
        with open(target, "w") as f:
            f.write("\n".join(blocks) + "\n")
        return [target]
    if rand_suite:
        grid = args[1:] or ["eval_lfo_rand.yml"]
    else:
        grid = args[1:] or (["eval_em_sim.yml"] if em_sim else DEFAULT_GRID)
    for name in grid:
        target = os.path.join(
            out_dir, os.path.splitext(os.path.basename(name))[0] + ".txt"
        )
        print(f"=== {name} -> {target}")
        written.append(target)
        blocks = []
        if (
            os.path.basename(name) == "eval_em_unseen_effect.yml"
            and not os.path.isdir("data/egfx_clean_44100/test")
        ):
            # EGFx/Melda audio absent: archive the computable facts
            # (imported-checkpoint forward smokes + per-block requirements)
            blocks = build_em_unseen_stub(device)
            with open(target, "w") as f:
                f.write("\n".join(blocks) + "\n")
            continue
        try:
            cfg = cli.load_yaml_with_includes(name)
            if em_sim:
                blocks.extend(build_em_sim_blocks(cfg, validate_many, table))
                blocks.extend(build_gt_control_blocks(validate_many, table))
                blocks.extend(
                    build_h160_capacity_blocks(validate_many, table)
                )
                blocks.extend(
                    build_chorus3_s2_blocks(cfg, validate_many, table)
                )
            else:
                if rand_suite:
                    groups = [list(_rand_suite_variants(cfg))]
                else:
                    groups = _config_groups(name, cfg, per_shape)
                # one validate_many per group (groups differ in
                # RenderConfig); a failing group records its error and
                # lets the other effect's tables still archive
                for gi, group in enumerate(groups):
                    try:
                        for label, metrics in validate_many(group):
                            blocks.append(block(metrics, label))
                    except Exception:
                        if len(groups) == 1:
                            raise
                        blocks.append(
                            f"FAILED (group {gi}: {group[0][0]!r}...):\n"
                            f"{traceback.format_exc()}"
                        )
        except (AssertionError, FileNotFoundError) as e:
            if "data/" in str(e):
                # external dataset not present: record that plainly
                # instead of a traceback
                blocks.append(
                    f"SKIPPED (missing dataset): {e}\n"
                    "See README.md 'Reproducing the paper experiments'.\n"
                )
            else:
                blocks.append(f"FAILED:\n{traceback.format_exc()}")
        except Exception:
            blocks.append(f"FAILED:\n{traceback.format_exc()}")
        with open(target, "w") as f:
            f.write("\n".join(blocks) + "\n")
    return written


if __name__ == "__main__":
    import logging

    logging.basicConfig()
    logging.getLogger().setLevel(os.environ.get("LOGLEVEL", "INFO"))
    main(sys.argv[1:])
