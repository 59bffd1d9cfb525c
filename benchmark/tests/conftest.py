"""The benchmark harness's own tests: `python -m pytest benchmark/tests -q`
from the repo root (about two minutes on the CPU; none needs a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
