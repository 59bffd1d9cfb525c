"""What every cell's run shares: the run's context, the manifest and the
files it names, timing on the card, the comparison's checks, and the
result line."""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# module top-level names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mod_extraction_tpu")


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Run:
    """One run of one cell: the arguments, the manifest's entries and the
    files they name, and what the driver observed for the readers."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    device: str = "cuda"
    t0: float = field(default_factory=time.perf_counter)
    obs: Dict[str, object] = field(default_factory=dict)

    @property
    def host_seed(self) -> int:
        """The seed as numpy and torch take it (non-negative)."""
        return self.seed % (1 << 63)

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports `metric`."""
        cells = metric.get("workloads")
        return cells is None or self.workload in cells

    def read_layers(self) -> Dict[str, float]:
        """Each per-layer metric this cell reports, from its reader
        (`benchmark/metrics/<name>.py`); a reader that finds nothing to read
        returns None and its metric is left out."""
        out = {}
        for m in self.per_layer:
            if self.reports(m):
                value = load_reader(m["name"]).read(self)
                if value is not None:
                    out[m["name"]] = float(value)
        return out


def load_reader(name: str):
    """The module `benchmark/metrics/<name>.py`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None) -> Run:
    """The run's context from the manifest; raises KeyError for a cell the
    manifest does not hold."""
    man = load_manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    run = Run(workload, seed, seconds, trace, cell, config, traffic, limits,
              man["end_to_end"], man["per_layer"], device)
    if t0 is not None:
        run.t0 = t0
    return run


# ----------------------------------------------------------------- timing


def cuda_seconds(fn: Callable[[], object], reps: int = 5, warmup: int = 1) -> float:
    """Median of `reps` single calls of `fn` between CUDA events, after
    `warmup` calls (seconds)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return float(statistics.median(times))


def card_info() -> dict:
    """The card's name as torch reports it, and its power limit as
    nvidia-smi reads it (None where it cannot)."""
    import subprocess

    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = None
    return {"kind": torch.cuda.get_device_name(0), "power_limit": out}


# ------------------------------------------------------------- the checks


def relative_gap(value: float, reference: float, floor: float = 1e-12) -> float:
    """|value - reference| / |reference|; inf where a side is not finite."""
    if not (math.isfinite(value) and math.isfinite(reference)):
        return math.inf
    return abs(value - reference) / max(abs(reference), floor)


def leaf_norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> tuple:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf: (gap, the leaf)."""
    if not leaves:
        return math.inf, "none"
    med = statistics.median(ref[k] for k in leaves)
    worst, name = -1.0, leaves[0]
    for k in leaves:
        if not (math.isfinite(prog[k]) and math.isfinite(ref[k])):
            return math.inf, k
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, name = g, k
    return worst, name


def judge(values: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each compared number beside its limit, in the limits file's order;
    a number missing from `values` reads inf."""
    return {k: {"value": float(values.get(k, math.inf)), "limit": float(v["limit"])}
            for k, v in limits.items()}


def all_within(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules() -> List[str]:
    """Top-level names of `sys.modules` that no run may hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
