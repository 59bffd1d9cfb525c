"""Readings of the control and of planted faults, which the comparison that
decides `correct` has to fail; the numbers its limits are set between.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--variant control|half_batch]

For each seed this makes the cell's inputs as a run does, puts the
reference computed one precision below the configuration's ("control")
or the reference with every other row of each batch left out
("half_batch", train cells) in the program's place, and prints the
numbers the run would compare, one JSON line a seed.  It runs no timed
window; "program" (train cells) takes the program's checked steps as a run
does, for the readings of sound runs, a dozen seeds in one process.
`benchmark/tests/` runs it at a small size.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import generator  # noqa: E402
from benchmark.harness.common import ROOT as _ROOT, Run, make_run  # noqa: E402
from benchmark.harness.train import N_CHECKED, compare, extractor_shapes, seeded_init  # noqa: E402
from benchmark.reference import steps  # noqa: E402


def _half(batch: dict) -> dict:
    return {k: (_half(v) if isinstance(v, dict) else v[::2]) for k, v in batch.items()}


def train_reading(run: Run, variant: str) -> dict:
    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    corpus = generator.make_corpus(run.host_seed, tr["corpus_seconds"], cfg["sr"], tr["peak"],
                                   cfg["n_samples"], device)
    pool = generator.make_pool(run.host_seed, tr, cfg["n_samples"], cfg["sr"], corpus.numel())
    batches = [generator.pool_batch(pool, i) for i in range(N_CHECKED)]
    corpus_np = corpus.cpu().numpy()
    other_batches = [_half(b) for b in batches] if variant == "half_batch" else batches
    precision = "control" if variant == "control" else "config"
    if tr["kind"] == "train_lfo":
        init = {k: v.cpu() for k, v in seeded_init(extractor_shapes(cfg["extractor"]), run.host_seed, device).items()}
        draws = generator.mask_draws(run.host_seed, tr["pool_batches"])[:N_CHECKED].numpy()
        ref = steps.stage1(init, batches, corpus_np, draws, cfg, tr, device)
        other = steps.stage1(init, other_batches, corpus_np, draws, cfg, tr, device, precision)
    else:
        paths = (str(_ROOT / cfg["extractor_weights"]), str(_ROOT / cfg["effect_model_weights"]))
        ref = steps.stage2(*paths, batches, corpus_np, cfg, tr, device)
        other = steps.stage2(*paths, other_batches, corpus_np, cfg, tr, device, precision)
        from benchmark.reference.lstm import EffectModel, npz_params

        init = {k: v.detach().cpu() for k, v in EffectModel(npz_params(paths[1]), "cpu").leaves().items()}
    prog = {"losses": other["losses"], "grad1": other["grad1"], "after": other["params"], "init": init}
    return compare(prog, ref)


def program_reading(run: Run) -> dict:
    """The program's checked steps, as a run takes them, against the
    reference: the readings of sound runs, with no window."""
    from benchmark.harness import train

    corpus, pool_np, cell = train.prepare(run)
    prog = train.checked_steps(cell)
    host, call = train.reference_inputs(run, cell, prog, pool_np, corpus)
    del cell, corpus, prog
    train.release(torch.device(run.device))
    return train.reference_values(host, call)


def stream_reading(run: Run, variant: str) -> dict:
    from benchmark.harness import stream

    device = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    n, sr = tr["buffer"], cfg["sr"]
    n_calls = int(round(run.seconds * sr / n))
    x = generator.stream_input(run.host_seed, n * n_calls, tr["channels"], sr, tr["peak"], device)
    weights = str(_ROOT / cfg["effect_model_weights"])
    if variant == "program":
        proc, x, n_calls = stream.build(run)
        state, y = proc.init_state(), np.empty_like(x)
        for k in range(n_calls):
            y[:, k * n:(k + 1) * n], state = proc.process_np(state, x[:, k * n:(k + 1) * n], **tr["knobs"])
        h, c = (state[k].cpu().numpy() for k in ("h", "c"))
        del proc, state
        return stream.compare(weights, x, y, h, c, n, sr, tr["knobs"], device)
    y, h, c = stream.reference_stream(weights, x, n, sr, tr["knobs"], device, precision=variant)
    return stream.compare(weights, x, y, h, c, n, sr, tr["knobs"], device)


def reading(workload: str, seed: int, variant: str, seconds: float = 30.0, device: str = "cuda",
            adjust=None) -> dict:
    run = make_run(workload, seed, seconds, False, device=device)
    if adjust is not None:  # tests shrink the sizes
        adjust(run)
    if run.traffic["kind"] == "stream":
        return stream_reading(run, variant)
    if variant == "program":
        return program_reading(run)
    return train_reading(run, variant)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variant", default="control", choices=("control", "half_batch", "program"))
    p.add_argument("--seconds", type=float, default=30.0, help="stream cells: the window's audio")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        values = reading(args.workload, seed, args.variant, args.seconds)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "values": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
