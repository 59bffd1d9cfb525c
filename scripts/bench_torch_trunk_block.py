"""Check and time K7 (the trunk's block between two convs,
`ops/trunk_kernels.py`) on the GPU at the paper extractor's six blocks:
against its plain version at batch 4 and L0 at batch 99, bit for bit
across two launches, then its forward and forward + backward at batch 99
beside its byte bound and the eager chain.  Prints ptxas's registers and
spills of `csrc/trunk_block.cu` first.  The checks and the timing are
`chip_smoke.py`'s trunk-block phase; this script runs them alone.

    python3 scripts/bench_torch_trunk_block.py

Needs a CUDA device; imports torch and the port only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from mod_extraction_tpu_torch.ops import cuda_build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}")
    for line in cuda_build.ptxas_report("trunk_block.cu"):
        print(f"[ptxas] {line}")
    res = cs.run_trunk_block()
    print(json.dumps({k: v for k, v in res.items() if k != "blocks"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
