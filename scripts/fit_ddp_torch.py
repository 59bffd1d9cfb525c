"""Data-parallel `cli.fit` of a shipped training config across the cards of
one host, beside the same fit on one card.

    python3 scripts/fit_ddp_torch.py [--config CONFIG] [--nproc N] [--batches B]

Writes the riff corpus of `data/synthetic.py::write_synthetic_corpus` (and,
for a dry/wet config, its wet side through K1 on the card) to a temporary
directory and points the config's data directories at it, with B train
batches and one val batch an epoch and a log line a step; batch size,
widths, optimizer, schedule and weights stay as shipped.  Then it runs the
training entry point as a user does,

    torchrun --nnodes 1 --nproc_per_node N --master_addr localhost \
        --master_port <a free port> scripts/train_torch.py <config>

once with N ranks and once with one (a world of one rank), for one epoch
each, and prints for both the losses a step, the median step ms of the steps
after the first (from each step's logged `audio_sec_per_sec`), the largest
difference of the losses and of the final weights (`last.pt`), the files
rank 0 wrote, and the card's name and power limit.  The global batch is the
config's `batch_size` in both runs, so N must divide it (99 for the r7
extractor config: 3 ranks; 32 for the TBPTT configs: 2 or 4).

Exits non-zero if a run fails, a loss is not finite or the two runs log
other steps.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/train_lfo_interwoven_all_live_r7.yml")
    p.add_argument("--nproc", type=int, default=3, help="ranks, one card each (default 3)")
    p.add_argument("--batches", type=int, default=6, help="train batches an epoch (default 6)")
    return p.parse_args(argv)


def run(cfg_path: Path, out: Path, nproc: int) -> dict:
    """`scripts/train_torch.py` under torchrun with `nproc` ranks, from `out`
    (the Trainer writes under `out/out`); returns its records and weights."""
    import torch

    out.mkdir(parents=True)
    with socket.socket() as sock:  # a free port on this host for the rendezvous
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", str(nproc),
           "--master_addr", "localhost", "--master_port", str(port),
           str(ROOT / "scripts" / "train_torch.py"), str(cfg_path)]
    proc = subprocess.run(cmd, cwd=str(out), capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n")
        raise SystemExit(f"{' '.join(cmd)} failed with {proc.returncode}")
    (metrics,) = (out / "out").glob("*_metrics.jsonl")
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    (last,) = (out / "out").glob("*_ckpts/last.pt")
    state = torch.load(last, map_location="cpu", weights_only=False)["task"]["model"]
    return dict(records=records, weights={k: v.float().numpy() for k, v in state.items()},
                files=sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()))


def main(argv=None) -> int:
    import numpy as np
    import torch
    import yaml

    from mod_extraction_tpu_torch.cli import load_yaml_with_includes
    from mod_extraction_tpu_torch.data.synthetic import fit_config, write_synthetic_corpus, write_wet_corpus
    from mod_extraction_tpu_torch.ops import cuda_build
    from mod_extraction_tpu_torch.utils.timing import card_line

    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.nproc < 2:
        raise SystemExit("--nproc: at least 2 ranks (the run is held against one rank)")
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.nproc:
        print(f"FAIL: {args.nproc} cards needed, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    print(f"cards: {torch.cuda.device_count()} x {card_line()}")
    for source in ("fx.cu", "lstm.cu"):  # built once here; every rank loads the library
        cuda_build.build(source)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_corpus(str(tmp / "corpus"))
        wet = None
        data = load_yaml_with_includes(str(ROOT / args.config))["data"]["init_args"]
        if "shared_train_args" not in data:
            wet = tmp / "wet"  # dry/wet pairs
            write_wet_corpus(tmp / "corpus", wet)
        cfg = fit_config(str(ROOT / args.config), tmp / "corpus", wet, args.batches)
        cfg["trainer"] = dict(cfg.get("trainer") or {}, max_epochs=1)
        cfg_path = tmp / "config.yml"
        cfg_path.write_text(yaml.safe_dump(cfg))
        runs = {}
        for n in (args.nproc, 1):
            runs[n] = run(cfg_path, tmp / f"world{n}", n)
    batch, clip = data["batch_size"], data.get("shared_args", data)
    audio_per_batch = batch * clip["n_samples"] / clip["sr"]
    losses, steps_ms = {}, {}
    for n, r in runs.items():
        steps = [x for x in r["records"] if x["phase"] == "train_step"]
        epoch = [x for x in r["records"] if x["phase"] == "epoch"]
        losses[n] = [x["loss"] for x in steps] + [e["val/loss"] for e in epoch]
        steps_ms[n] = [audio_per_batch / x["audio_sec_per_sec"] * 1e3 for x in steps[1:]]
        print(f"[world {n}] {args.config}, global batch {batch} ({batch // n} a rank), {len(steps)} steps: "
              f"losses {losses[n]}; step ms {[round(x, 3) for x in steps_ms[n]]}, median "
              f"{float(np.median(steps_ms[n])):.3f}; files {r['files']}")
        if not all(math.isfinite(v) for v in losses[n]) or not epoch:
            print(f"FAIL: world {n}: losses {losses[n]}", file=sys.stderr)
            return 1
    a, b = runs[args.nproc], runs[1]
    if [x["step"] for x in a["records"] if "step" in x] != [x["step"] for x in b["records"] if "step" in x]:
        print("FAIL: the two runs logged other steps", file=sys.stderr)
        return 1
    d_loss = max(abs(x - y) for x, y in zip(losses[args.nproc], losses[1]))
    d_w = max(float(np.abs(a["weights"][k] - b["weights"][k]).max()) for k in b["weights"])
    med = {n: float(np.median(v)) for n, v in steps_ms.items()}
    print(f"[world {args.nproc} vs 1] max |d loss| {d_loss:.3e}, final weights max |d| {d_w:.3e}; median step "
          f"ms {med[args.nproc]:.3f} vs {med[1]:.3f} ({med[1] / med[args.nproc]:.3f}x)")
    print(json.dumps({"config": args.config, "nproc": args.nproc, "batch": batch, "card": card_line(),
                      "step_ms": med, "max_abs_loss_diff": d_loss, "max_abs_weight_diff": d_w}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
