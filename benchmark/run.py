"""The benchmark of the PyTorch and CUDA port (`mod_extraction_tpu_torch`)
on NVIDIA GPUs: one run of one cell of `BENCHMARK.json`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`benchmark/configs/<config>.json`) and a
traffic mix (`benchmark/traffic/<mix>.json`, whose `kind` picks the driver
in `benchmark/harness/`); each per-layer metric is read by
`benchmark/metrics/<metric>.py`, and the comparison's limits are in
`benchmark/limits/<cell>.json`.  The run prints, as the last line of its
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit; the same numbers are the
last lines of its standard error.

It exits non-zero and prints no result without enough CUDA cards, or when
the process holds `jax`, `jaxlib`, `flax` or `mod_extraction_tpu` once the
window has closed.  Caches of compiled kernels stay in fixed directories
inside the checkout."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
KINDS = {"train_lfo": "train", "train_tbptt": "train", "stream": "stream"}


def set_environment() -> None:
    """Compile caches at fixed paths inside the checkout; keep libraries
    from loading JAX or flax on their own."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run, out: dict, card: dict) -> dict:
    """The contract's last line."""
    from benchmark.harness.common import all_within, judge

    checks = judge(out["values"], run.limits)
    correct = all_within(checks) and out["failed"] == 0
    if run.trace:
        wanted = {m["name"]: m for m in run.per_layer if run.reports(m)}
        values = out["per_layer"]
    else:
        wanted = {m["name"]: m for m in run.end_to_end if run.reports(m)}
        values = out["end_to_end"]
    metrics = {k: {"value": values[k], "unit": wanted[k]["unit"]} for k in wanted if k in values}
    device = {"platform": "gpu", "kind": card["kind"], "count": 1,
              "memory_peak_bytes": int(out["memory_peak_bytes"]), "power_limit": card["power_limit"]}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": device}
    if run.trace:
        tr = out["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": [[n, s] for n, s in tr.device_ops],
                             "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    set_environment()
    from benchmark.harness.common import forbidden_modules, log, make_run

    run = make_run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    import torch

    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    from benchmark.harness.common import card_info

    card = card_info()
    torch.cuda.set_device(0)
    import importlib

    driver = importlib.import_module(f"benchmark.harness.{KINDS[run.traffic['kind']]}")
    out = driver.run(run)
    found = forbidden_modules()
    if found:
        log(f"the process holds {found} after the window: no result")
        return 3
    line = result_line(run, out, card)
    log(f"card: {card['kind']}, power limit {card['power_limit']}; peaks bf16 989 TFLOP/s, "
        "float32 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet, 700 W)")
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
