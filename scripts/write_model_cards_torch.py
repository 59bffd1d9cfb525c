"""Emit a `models/<name>.yml` card next to every shipped `models/<name>.npz`,
with the PyTorch port (the counterpart of `scripts/write_model_cards.py`).

A card records provenance (trained here vs imported reference weights),
the training config (path + include-resolved copy, through the port's
`cli.load_yaml_with_includes`), the parent extractor for stage-2 models,
the corpus and its regeneration command, and the final epoch's metrics from
the run's `out/<run>_metrics.jsonl` (the port's `MetricLogger` writes the
JAX Trainer's records) when it is still on disk; otherwise the metrics the
committed card already holds.  The registry below is this script's own copy
of the JAX script's; both write the same cards.

Usage: python scripts/write_model_cards_torch.py [models_dir]
Host only (no card).  Re-runnable; exits 1 when a `.npz` has no registered
card.
"""

import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

R2_EXTRACTOR = "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r2.npz"
R3_EXTRACTOR = "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r3.npz"
R4_EXTRACTOR = "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r4.npz"

# stem -> card fields.  `metrics_run` names the out/<run>_metrics.jsonl
# written by the Trainer for that training (may no longer exist — cards
# then record what ROUND_NOTES.md archives).
REGISTRY = {
    "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r5": dict(
        kind="trained",
        train_config="configs/train_lfo_interwoven_all_live_r5.yml",
        metrics_run="lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r5",
        # the run's out/ metrics did not survive the VM reset; the export
        # guard recorded the best checkpoint's monitored value at ship time
        # (scripts/extractor_r5_r6_chain.sh, commit 057e6fd)
        best_val_loss=0.02659,
        epochs_total=920,
        corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
        notes=(
            "Flagship LFO extractor: SGDR-style cosine-restart anneal "
            "(200 epochs, 1e-4 -> 1e-6) of the plateaued r4 lineage "
            "(920 epochs total).  Drives every eval_lfo_*.txt table; "
            "the stage-2 sim models remain conditioned on the r4/r3 "
            "snapshots they were trained against."
        ),
    ),
    "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r4": dict(
        kind="trained",
        train_config="configs/train_lfo_interwoven_all_live.yml",
        metrics_run="lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live",
        epochs_total=720,
        corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
        notes=(
            "Flagship LFO extractor: Spectral2DCNN, the interwoven "
            "live-render run continued to 720 epochs (r3 = its 570-epoch "
            "snapshot).  Drives every eval_lfo_*.txt table; the stage-2 "
            "sim models remain conditioned on the r3 snapshot they were "
            "trained against."
        ),
    ),
    "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r3": dict(
        kind="trained",
        train_config="configs/train_lfo_interwoven_all_live.yml",
        pin_metrics=True,  # snapshot of a continued run; out/ no longer has it
        corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
        notes=(
            "Flagship LFO extractor: Spectral2DCNN, the r2 470-epoch "
            "interwoven run continued to 570 epochs after the phaser "
            "renderer was pinned to exact JUCE semantics (round 2): the "
            "sweep/GT phase relationship flipped, so the phaser portion "
            "was relearned on the corrected data.  Conditions the "
            "stage-2 sim models; superseded for eval tables by _r4."
        ),
    ),
    "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r2": dict(
        kind="trained",
        train_config="configs/train_lfo_interwoven_all_live.yml",
        corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
        notes=(
            "Round-1 flagship extractor (~470 epochs, live interwoven "
            "rendering) — trained on the pre-round-2 phaser convention "
            "(sweep in phase with GT); superseded by the _r3 checkpoint."
        ),
    ),
    "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_live_r1": dict(
        kind="trained",
        train_config="configs/train_lfo_interwoven_all_live.yml",
        corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
        notes="Earlier (round-1, ~229-epoch) snapshot of the interwoven "
        "extractor; superseded by the _r2 checkpoint.",
    ),
    "lfo_2dcnn_io_sa_25_25_no_ch_ln__ph_fl_ch_all_2__idmt_4": dict(
        kind="trained",
        train_config="configs/train_lfo_phaser.yml",
        corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
        notes=(
            "Phaser-only extractor, 30 TPU-trained epochs (val/l1 0.0188); "
            "fills the reference grid slot of "
            "lfo_2dcnn_io_sa_25_25_no_ch_ln__ph_fl_ch_all_2__idmt_4__"
            "epoch_197_step_15840 as the eval_em_unseen_effect extractor."
        ),
    ),
    "lstm_64__lfo_2dcnn_r3__sim_chorus": dict(
        kind="trained",
        train_config="configs/train_em_sim_chorus.yml",
        metrics_run="lstm_64__lfo_2dcnn_r3__sim_chorus",
        parent_extractor=R3_EXTRACTOR,
        corpus="data/sim_chorus (scripts/make_sim_effect_data.py, "
        "quasiperiodic regime)",
        notes="Stage-2 LSTM-64 effect model, TBPTT, 120 epochs on the "
        "quasiperiodic chorus corpus, conditioned on the frozen r3 "
        "extractor's LFO estimate; superseded by the _r4-conditioned "
        "adaptation.",
    ),
    "lstm_64__lfo_2dcnn_r3__sim_flanger": dict(
        kind="trained",
        train_config="configs/train_em_sim_flanger.yml",
        pin_metrics=True,  # npz = the ft2 stage's best; out/ holds the
        # later (regressed, discarded) ESR-weighted ft3 run's metrics
        parent_extractor=R3_EXTRACTOR,
        corpus="data/sim_flanger (scripts/make_sim_effect_data.py)",
        notes="Stage-2 LSTM-64 effect model, TBPTT, 120 epochs + two "
        "low-LR fine-tune stages (ft/ft2), conditioned on the frozen r3 "
        "extractor's LFO estimate; superseded by the _r4-conditioned "
        "adaptation.",
    ),
    "lstm_64__lfo_2dcnn_r3__sim_phaser": dict(
        kind="trained",
        train_config="configs/train_em_sim_phaser.yml",
        metrics_run="lstm_64__lfo_2dcnn_r3__sim_phaser",
        parent_extractor=R3_EXTRACTOR,
        corpus="data/sim_phaser (scripts/make_sim_effect_data.py)",
        notes="Stage-2 LSTM-64 effect model, TBPTT, 120 epochs "
        "(eval_em_sim esr 0.096 vs rand baseline 0.786); superseded by "
        "the _r4-conditioned adaptation.",
    ),
    "lstm_64__lfo_2dcnn_r4__sim_chorus": dict(
        kind="trained",
        train_config="configs/train_em_sim_chorus_r4.yml",
        metrics_run="lstm_64__lfo_2dcnn_r4__sim_chorus",
        parent_extractor=R4_EXTRACTOR,
        corpus="data/sim_chorus (scripts/make_sim_effect_data.py, "
        "quasiperiodic regime)",
        notes="Stage-2 LSTM-64 effect model: the r3-conditioned chorus "
        "model adapted to r4-extractor conditioning (low-LR warm-started "
        "TBPTT).  The chorus regime sits at an LSTM-64 capacity floor "
        "(~26-40 ms delay), so LSTM == rand-baseline ESR here, as in "
        "three prior corpus regimes.",
    ),
    "lstm_64__lfo_2dcnn_r4__sim_flanger": dict(
        kind="trained",
        train_config="configs/train_em_sim_flanger_r4.yml",
        metrics_run="lstm_64__lfo_2dcnn_r4__sim_flanger",
        parent_extractor=R4_EXTRACTOR,
        corpus="data/sim_flanger (scripts/make_sim_effect_data.py)",
        notes="Stage-2 LSTM-64 effect model: the r3-conditioned flanger "
        "model (120 epochs + ft/ft2) adapted to r4-extractor "
        "conditioning (low-LR warm-started TBPTT).",
    ),
    "lstm_64__lfo_2dcnn_r4__sim_phaser": dict(
        kind="trained",
        train_config="configs/train_em_sim_phaser_r4.yml",
        metrics_run="lstm_64__lfo_2dcnn_r4__sim_phaser",
        parent_extractor=R4_EXTRACTOR,
        corpus="data/sim_phaser (scripts/make_sim_effect_data.py)",
        notes="Stage-2 LSTM-64 effect model: the r3-conditioned phaser "
        "model (120 epochs) adapted to r4-extractor conditioning "
        "(low-LR warm-started TBPTT).",
    ),
    "lstm_64__lfo_2dcnn_r4__sim_flanger2": dict(
        kind="trained",
        train_config="configs/train_em_sim_flanger2.yml",
        metrics_run="lstm_64__lfo_2dcnn_r4__sim_flanger2",
        parent_extractor=R4_EXTRACTOR,
        corpus="data/sim_flanger2 (scripts/make_sim_effect_data.py, "
        "phase-critical resonant regime: feedback 0.45, fully wet)",
        notes="Stage-2 LSTM-64 effect model on the resonant flanger "
        "regime, warm-started from the sim_flanger model; protocol "
        "matched 1:1 with rand_baseline__sim_flanger2 (120 epochs, "
        "warmup-cosine 1e-4 -> 1e-6).",
    ),
    "lstm_64__lfo_2dcnn_r1__sim_chorus": dict(
        kind="trained",
        train_config="configs/train_em_sim_chorus.yml",
        parent_extractor="models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_live_r1.npz",
        corpus="data/sim_chorus (scripts/make_sim_effect_data.py)",
        notes="Round-1 stage-2 chorus model driven by the r1 extractor; "
        "superseded by the _r2 version.",
    ),
    "rand_baseline__sim_chorus": dict(
        kind="trained",
        train_config="configs/train_baseline_em_sim.yml",
        metrics_run="rand_baseline__sim_chorus",
        corpus="data/sim_chorus (scripts/make_sim_effect_data.py, "
        "quasiperiodic regime)",
        notes="RandomLFO-conditioned LSTM-64 baseline (100 epochs on the "
        "quasiperiodic chorus corpus) — the reference's second table per "
        "effect in eval_em_unseen_effect.txt.",
    ),
    "rand_baseline__sim_flanger": dict(
        kind="trained",
        train_config="configs/train_baseline_em_sim_flanger.yml",
        corpus="data/sim_flanger (scripts/make_sim_effect_data.py)",
        notes="RandomLFO-conditioned LSTM-64 baseline (40 epochs).",
    ),
    "rand_baseline__sim_flanger2": dict(
        kind="trained",
        train_config="configs/train_baseline_em_sim_flanger2.yml",
        metrics_run="rand_baseline__sim_flanger2",
        corpus="data/sim_flanger2 (scripts/make_sim_effect_data.py, "
        "phase-critical resonant regime)",
        notes="RandomLFO-conditioned LSTM-64 baseline, warm-started from "
        "rand_baseline__sim_flanger; protocol matched 1:1 with the "
        "extractor-conditioned sim_flanger2 model (120 epochs, "
        "warmup-cosine 1e-4 -> 1e-6).",
    ),
    "rand_baseline__sim_phaser": dict(
        kind="trained",
        train_config="configs/train_baseline_em_sim_phaser.yml",
        corpus="data/sim_phaser (scripts/make_sim_effect_data.py)",
        notes="RandomLFO-conditioned LSTM-64 baseline (40 epochs).",
    ),
}

# Lineage-generated stems, pre-registered so the unattended chains
# (scripts/extractor_r5_r6_chain.sh + em_sim_final_chain.sh) can run the
# card writer no matter which extractor the guards ship.
REGISTRY["lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6"] = dict(
    kind="trained",
    train_config="configs/train_lfo_interwoven_all_live_r6.yml",
    metrics_run="lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6",
    epochs_total=1070,
    corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
    notes=(
        "Flagship LFO extractor: second, lower-peak cosine restart "
        "(150 epochs, 5e-5 -> 1e-6) on top of the r5 anneal "
        "(1070 epochs total).  Shipped only if it beat the r5 best "
        "(scripts/extractor_r5_r6_chain.sh guard)."
    ),
)
REGISTRY["lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7"] = dict(
    kind="trained",
    train_config="configs/train_lfo_interwoven_all_live_r7.yml",
    metrics_run="lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7",
    epochs_total=1220,
    corpus="data/idmt_4 (scripts/make_synthetic_corpus.py)",
    notes=(
        "Flagship LFO extractor: exponent-augmentation anneal of the r6 "
        "best (exp ~ U(0.4, 2.5) with 50% mass at 1.0; 150 epochs, "
        "5e-5 -> 1e-6; 1220 epochs total).  Shipped only if it passes "
        "the EVAL-GRID gate (fl-distorted-all <= 0.0670 with the "
        "in-domain headline within 5%) — scripts/extractor_r7_chain.sh; "
        "its val/loss is not comparable to r6 (augmented val split)."
    ),
)
REGISTRY["lstm_64__gt_mod_sig__sim_chorus_gt"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus_gtctrl.yml",
    metrics_run="lstm_64__gt_mod_sig__sim_chorus_gt",
    parent_extractor="none (ground-truth mod-sig conditioning)",
    corpus="data/sim_chorus_gt (scripts/make_sim_chorus_gt_control.py)",
    notes=(
        "The sim_chorus GROUND-TRUTH conditioning control (VERDICT r2 "
        "#3): same LSTM-64/TBPTT recipe, conditioned on the true mod "
        "signal over a preproc-triplet corpus in the shipped sim_chorus "
        "regime.  Settles capacity-floor vs conditioning-path for the "
        "chorus no-win; archived in eval_em_sim.txt 'gt control' block."
    ),
)
for _rn in ("r5", "r6", "r7"):
    # r7 (round 5) extends the migration to the chorus-family corpora
    _effects = ("flanger", "phaser", "chorus", "flanger2") + (
        ("chorus2", "chorus3", "chorus4") if _rn == "r7" else ()
    )
    for _effect in _effects:
        REGISTRY[f"lstm_64__lfo_2dcnn_{_rn}__sim_{_effect}"] = dict(
            kind="trained",
            train_config=f"configs/train_em_sim_{_effect}_{_rn}.yml",
            metrics_run=f"lstm_64__lfo_2dcnn_{_rn}__sim_{_effect}",
            parent_extractor=(
                "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__"
                f"interwoven_idmt_all_live_{_rn}.npz"
            ),
            corpus=f"data/sim_{_effect} (scripts/make_sim_effect_data.py)",
            notes=(
                f"Stage-2 LSTM-64 effect model: the r4-conditioned "
                f"sim_{_effect} model adapted to {_rn}-extractor "
                "conditioning (low-LR warm-started TBPTT; config "
                "generated by scripts/gen_em_sim_migration.py)."
            ),
        )

# round-4 sim_chorus2 conditioning bracket (scripts/sim_chorus2_chain.sh)
REGISTRY["lstm_64__lfo_2dcnn_r6__sim_chorus2"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus2.yml",
    metrics_run="lstm_64__lfo_2dcnn_r6__sim_chorus2",
    parent_extractor=(
        "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__"
        "interwoven_idmt_all_live_r6.npz"
    ),
    corpus="data/sim_chorus2 (scripts/make_sim_effect_data.py, "
    "short-delay 5-10 ms regime)",
    notes=(
        "Stage-2 LSTM-64 on the round-4 short-delay sim chorus (fresh "
        "100-epoch run).  RESULT: no conditioning separation (esr "
        "0.4237 vs rand 0.4200 vs GT 0.4195) — 5-10 ms is still beyond "
        "LSTM-64 delay-line capacity; see ROUND_NOTES round 4 and the "
        "sim_chorus3 / h160 arms."
    ),
)
REGISTRY["rand_baseline__sim_chorus2"] = dict(
    kind="trained",
    train_config="configs/train_baseline_em_sim_chorus2.yml",
    metrics_run="rand_baseline__sim_chorus2",
    corpus="data/sim_chorus2 (scripts/make_sim_effect_data.py)",
    notes="RandomLFO-conditioned LSTM-64 baseline (100 epochs) for the "
    "short-delay chorus regime.",
)
REGISTRY["lstm_64__gt_mod_sig__sim_chorus2_gt"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus2_gtctrl.yml",
    metrics_run="lstm_64__gt_mod_sig__sim_chorus2_gt",
    parent_extractor="none (ground-truth mod-sig conditioning)",
    corpus="data/sim_chorus2_gt (scripts/make_sim_chorus_gt_control.py "
    "--regime chorus2)",
    notes=(
        "GROUND-TRUTH conditioning ceiling for sim_chorus2: brackets the "
        "extractor-conditioned run from above as the rand baseline does "
        "from below; archived in eval_em_sim.txt 'sim_chorus2 gt "
        "control' block."
    ),
)

# round-4 LSTM-160 capacity bracket (VERDICT r3 #5 second arm): the
# chorus conditioning win inside sufficient model capacity, in the
# SHIPPED 11-19 ms sim_chorus regime that saturates LSTM-64
REGISTRY["lstm_160__lfo_2dcnn_r6__sim_chorus"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus_h160.yml",
    metrics_run="lstm_160__lfo_2dcnn_r6__sim_chorus",
    parent_extractor=(
        "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__"
        "interwoven_idmt_all_live_r6.npz"
    ),
    corpus="data/sim_chorus (scripts/make_sim_effect_data.py)",
    notes=(
        "Stage-2 LSTM-160 on the shipped sim chorus: tests whether the "
        "documented LSTM-64 capacity floor (GT == rand == extractor) "
        "lifts with 2.5x hidden state; archived in eval_em_sim.txt "
        "'sim_chorus h160 capacity bracket'."
    ),
)
REGISTRY["rand_baseline_160__sim_chorus"] = dict(
    kind="trained",
    train_config="configs/train_baseline_em_sim_chorus_h160.yml",
    metrics_run="rand_baseline_160__sim_chorus",
    corpus="data/sim_chorus (scripts/make_sim_effect_data.py)",
    notes="RandomLFO-conditioned LSTM-160 companion baseline for the "
    "capacity bracket.",
)

# round-4 sim_chorus3: chorus + LFO-correlated level modulation — the
# chorus-family regime whose learnable component is inside LSTM-64
# capacity (make_sim_effect_data.py::sim_chorus3 rationale)
REGISTRY["lstm_64__lfo_2dcnn_r6__sim_chorus3"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus3.yml",
    metrics_run="lstm_64__lfo_2dcnn_r6__sim_chorus3",
    parent_extractor=(
        "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__"
        "interwoven_idmt_all_live_r6.npz"
    ),
    corpus="data/sim_chorus3 (scripts/make_sim_effect_data.py, chorus + "
    "level-mod)",
    notes=(
        "Stage-2 LSTM-64 on the BBD-style chorus (delay + companding-"
        "like level modulation on one LFO): the conditioning-win arm of "
        "the chorus question; archived in eval_em_sim.txt."
    ),
)
REGISTRY["rand_baseline__sim_chorus3"] = dict(
    kind="trained",
    train_config="configs/train_baseline_em_sim_chorus3.yml",
    metrics_run="rand_baseline__sim_chorus3",
    corpus="data/sim_chorus3 (scripts/make_sim_effect_data.py)",
    notes="RandomLFO-conditioned LSTM-64 baseline for sim_chorus3.",
)

# round-5 sim_chorus4: the level-mod-DOMINANT chorus regime the round-4
# five-bracket analysis prescribes (delay mix 0.35 + tremolo 0.9 on one
# LFO — make_sim_effect_data.py::sim_chorus4 rationale)
REGISTRY["lstm_64__lfo_2dcnn_r6__sim_chorus4"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus4.yml",
    metrics_run="lstm_64__lfo_2dcnn_r6__sim_chorus4",
    parent_extractor=(
        "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__"
        "interwoven_idmt_all_live_r6.npz"
    ),
    corpus="data/sim_chorus4 (scripts/make_sim_effect_data.py, delay "
    "mix 0.35 + level-mod 0.9)",
    notes=(
        "Stage-2 LSTM-64 on the level-mod-dominant chorus: the "
        "expressible component carries most of the wet power, so the "
        "conditioned/rand esr ratio is no longer capped by the "
        "structural delay floor; archived in eval_em_sim.txt."
    ),
)
REGISTRY["rand_baseline__sim_chorus4"] = dict(
    kind="trained",
    train_config="configs/train_baseline_em_sim_chorus4.yml",
    metrics_run="rand_baseline__sim_chorus4",
    corpus="data/sim_chorus4 (scripts/make_sim_effect_data.py)",
    notes="RandomLFO-conditioned LSTM-64 baseline for sim_chorus4.",
)
REGISTRY["lstm_64__gt_mod_sig__sim_chorus4_gt"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus4_gtctrl.yml",
    metrics_run="lstm_64__gt_mod_sig__sim_chorus4_gt",
    corpus="data/sim_chorus4_gt (scripts/make_sim_chorus_gt_control.py "
    "--regime chorus4)",
    notes=(
        "Ground-truth-conditioned ceiling of the sim_chorus4 bracket; "
        "must sit clearly below rand in the level-mod-dominant regime."
    ),
)
# round-5 seed replication of the sim_chorus3 separation (same corpus,
# seed 45): the separation is load-bearing only if both seeds agree
REGISTRY["lstm_64__lfo_2dcnn_r6__sim_chorus3_s2"] = dict(
    kind="trained",
    train_config="configs/train_em_sim_chorus3_s2.yml",
    metrics_run="lstm_64__lfo_2dcnn_r6__sim_chorus3_s2",
    parent_extractor=(
        "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__"
        "interwoven_idmt_all_live_r6.npz"
    ),
    corpus="data/sim_chorus3 (scripts/make_sim_effect_data.py)",
    notes="Seed-2 replication of the chorus3 conditioned arm.",
)
REGISTRY["rand_baseline__sim_chorus3_s2"] = dict(
    kind="trained",
    train_config="configs/train_baseline_em_sim_chorus3_s2.yml",
    metrics_run="rand_baseline__sim_chorus3_s2",
    corpus="data/sim_chorus3 (scripts/make_sim_effect_data.py)",
    notes="Seed-2 replication of the chorus3 rand-baseline arm.",
)
# round-5 bf16-knob training validation: the exact r6 recipe with
# stft_impl=dft_bf16 + act_io_dtype=compute during training
REGISTRY["lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6b16"] = dict(
    kind="trained",
    train_config="configs/train_lfo_interwoven_all_live_r6b16.yml",
    metrics_run="lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6b16",
    corpus="data/idmt_4 (live interwoven render)",
    notes=(
        "Knob-validation twin of the r6 extractor (same seed/warm "
        "start/schedule, bf16 frontend + activation-stream knobs on "
        "during training); decides whether the bench knobs are "
        "training-clean (VERDICT r4 next #3)."
    ),
)

REGISTRY["lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6b16d"] = dict(
    kind="trained",
    train_config="configs/train_lfo_interwoven_all_live_r6b16d.yml",
    metrics_run="lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6b16d",
    corpus="data/idmt_4 (live interwoven render)",
    notes=(
        "Knob-ABLATION twin of the r6 extractor (dft_bf16 frontend "
        "only, activation stream f32): attributes the bundled +1.8% "
        "converged-quality cost between the two bf16 knobs (+0.9% "
        "each; ROUND_NOTES round 5)."
    ),
)

# imported reference weights: stem -> reference .pt filename
REFERENCE_IMPORTS = {
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ch_2_peak": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ch_2_peak__epoch_40_step_108896.pt",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_fl_2_peak": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_fl_2_peak__epoch_20_step_55776.pt",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak__epoch_35_step_95616.pt",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_fl_irregular": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_fl_irregular__epoch_202_step_673960.pt",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_fl_quasi": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_fl_quasi__epoch_207_step_690560.pt",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_ph_irregular": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_ph_irregular__epoch_199_step_664000.pt",
    "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_ph_quasi": "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__melda_ph_quasi__epoch_241_step_803440.pt",
}


def final_epoch_metrics(run: str):
    """Last epoch-phase record from out/<run>_metrics.jsonl, if present."""
    path = os.path.join("out", f"{run}_metrics.jsonl")
    if not os.path.exists(path):
        return None
    last = None
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("phase") == "epoch":
                last = rec
    return last


def existing_card_metrics(stem: str, models_dir: str = "models"):
    """(epochs_trained, final_val_metrics) from the committed card, if any.

    Training-run metrics live in `out/`, which does not survive VM
    resets; once a card has recorded them, a regeneration without the
    run on disk must preserve them instead of silently dropping (or —
    worse — re-deriving them from a *restarted* run that reuses the
    same run name with a reset epoch counter)."""
    import yaml

    path = os.path.join(models_dir, f"{stem}.yml")
    if not os.path.exists(path):
        return None, None
    try:
        with open(path) as f:
            old = yaml.safe_load(f)
    except Exception:
        return None, None
    if not isinstance(old, dict):
        return None, None
    return old.get("epochs_trained"), old.get("final_val_metrics")


def build_card(stem: str):
    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    if stem in REFERENCE_IMPORTS:
        card = {
            "name": stem,
            "weights": f"models/{stem}.npz",
            "kind": "imported_reference",
            "source": f"reference models/{REFERENCE_IMPORTS[stem]}",
            "imported_with": "scripts/import_reference_weights.py (kind=lstm)",
            "notes": (
                "Reference-trained LSTM-64 weights converted to this "
                "framework's .npz format; used for numerical parity tests "
                "(tests/test_reference_ckpt_parity.py) and the "
                "eval_em_unseen_effect config grid."
            ),
        }
        return card
    info = REGISTRY.get(stem)
    if info is None:
        return None
    card = {
        "name": stem,
        "weights": f"models/{stem}.npz",
        "kind": info["kind"],
        "train_config": info["train_config"],
        "corpus": info["corpus"],
        "notes": info["notes"],
    }
    if "parent_extractor" in info:
        card["parent_extractor"] = info["parent_extractor"]
    rec = None
    if not info.get("pin_metrics"):
        rec = final_epoch_metrics(info.get("metrics_run", ""))
    if rec is not None:
        card["epochs_trained"] = int(rec.get("epoch", -1)) + 1
        card["final_val_metrics"] = {
            k.split("/", 1)[1]: round(float(v), 6)
            for k, v in rec.items()
            if k.startswith("val/")
        }
    else:
        epochs, metrics = existing_card_metrics(stem)
        if epochs is not None:
            card["epochs_trained"] = epochs
        if metrics is not None:
            card["final_val_metrics"] = metrics
    if "epochs_total" in info:
        card["epochs_total"] = info["epochs_total"]
    if "best_val_loss" in info:
        # the exported npz is always the best-by-val/loss checkpoint;
        # record its monitored value when pinned in the registry
        card["best_val_loss"] = info["best_val_loss"]
    try:
        card["resolved_config"] = load_yaml_with_includes(info["train_config"])
    except Exception as e:  # config may reference absent local data
        card["resolved_config_error"] = str(e)
    return card


def main(argv=None) -> int:
    """Write a card for every `<models_dir>/*.npz` (argv: [models_dir],
    default models); 1 when a stem has no registered card, else 0."""
    import yaml

    argv = sys.argv[1:] if argv is None else argv
    models_dir = argv[0] if len(argv) > 0 else "models"
    missing = []
    for npz in sorted(glob.glob(os.path.join(models_dir, "*.npz"))):
        stem = os.path.splitext(os.path.basename(npz))[0]
        card = build_card(stem)
        if card is None:
            missing.append(stem)
            continue
        out_path = os.path.join(models_dir, f"{stem}.yml")
        with open(out_path, "w") as f:
            f.write(
                "# Model card (reference models/*.yml convention): "
                "provenance + config\n# for the sibling .npz. "
                "Regenerate with scripts/write_model_cards.py.\n"
            )
            yaml.safe_dump(card, f, sort_keys=False, default_flow_style=False)
        print(f"wrote {out_path}")
    if missing:
        print(f"NO CARD REGISTERED for: {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
