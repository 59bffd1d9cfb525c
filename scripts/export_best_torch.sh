#!/bin/bash
# Export a PyTorch-port run's best checkpoint (falling back to `last` when
# the run never improved on a prior lineage best) to a bare models/*.npz in
# the shipped flax layout (the counterpart of scripts/export_best.sh).
# Usage: export_best_torch.sh <run_name> <out_npz> [attr=model]
# Reads $OUT_DIR/<run_name>_ckpts/{best,last}.pt (OUT_DIR default out,
# relative to the repo root); host only.  PYTHON names the interpreter
# (default python).
set -e
cd "$(dirname "$0")/.."
RUN=$1; OUT=$2; ATTR=${3:-model}
CKPTS=${OUT_DIR:-out}/${RUN}_ckpts
SRC=$CKPTS/last.pt
[ -f "$CKPTS/best.pt" ] && SRC=$CKPTS/best.pt
echo "exporting $RUN from $SRC"
"${PYTHON:-python}" scripts/extract_torch_weights.py "$SRC" "$OUT" "$ATTR"
