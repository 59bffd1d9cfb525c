#!/bin/bash
# Chunked training with the PyTorch port (the counterpart of
# scripts/train_resumable.sh): run `mod_extraction_tpu_torch.cli.fit` a few
# epochs at a time in fresh processes, resuming from the `last` checkpoint
# each round.  Equivalent to one long run; each chunk is a process of its
# own, so a long lineage survives a lost process at the cost of one chunk.
#
# Usage: scripts/train_resumable_torch.sh <config> [total_epochs] [epochs_per_proc] [start_epoch]
# `start_epoch` skips the no-op chunks when continuing an existing run.
# Environment:
#   DEVICE            cuda (default) or cpu (the config's custom.cpu_* sizes)
#   OUT_DIR           where runs write metrics and checkpoints (default out)
#   PYTHON            the interpreter (default python)
#   SKIP_PARITY_GATE  1 skips the preflight
#   MODX_LAUNCH_LOG   a file each chunk appends its kernel launch counts to
set -e
CFG=${1:?usage: train_resumable_torch.sh <config> [total_epochs] [epochs_per_proc] [start_epoch]}
TOTAL=${2:-400}
CHUNK=${3:-8}
START=${4:-0}
DEVICE=${DEVICE:-cuda}
OUT_DIR=${OUT_DIR:-out}
PYTHON=${PYTHON:-python}
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
# Preflight: with a card, run the CUDA kernels' checks against their plain
# versions once before committing hours of training, so that a kernel or
# toolkit regression fails here instead of corrupting the run.  A hang
# (timeout, rc 124) warns and carries on; any other failure aborts.
if [ "${SKIP_PARITY_GATE:-0}" != "1" ] && [ "$DEVICE" != "cpu" ]; then
  HAS_CARD=$("$PYTHON" -c "import torch; print(int(torch.cuda.is_available()))")
  if [ "$HAS_CARD" = "1" ]; then
    echo "[train_resumable_torch] preflight: the cuda checks of tests/test_torch_cuda_kernels.py"
    set +e
    timeout 900 "$PYTHON" -m pytest -q --noconftest -p no:cacheprovider -m cuda \
      "$ROOT/tests/test_torch_cuda_kernels.py"
    GATE_RC=$?
    set -e
    if [ "$GATE_RC" = "124" ]; then
      echo "[train_resumable_torch] WARNING: the kernel checks timed out — continuing;" \
           "run them again when the card is idle"
    elif [ "$GATE_RC" != "0" ]; then
      echo "[train_resumable_torch] kernel checks FAILED (rc=$GATE_RC) — aborting"
      exit "$GATE_RC"
    fi
  fi
fi
for ((e = START + CHUNK; e <= TOTAL; e += CHUNK)); do
  "$PYTHON" - "$CFG" "$OUT_DIR" "$e" "$DEVICE" <<'PY'
import sys

from mod_extraction_tpu_torch.cli import fit
from mod_extraction_tpu_torch.ops.launches import log_launch_counts

cfg, out_dir, epochs, device = sys.argv[1:]
fit(cfg, out_dir=out_dir, resume=True, max_epochs=int(epochs), device=device)
log_launch_counts()
PY
done
