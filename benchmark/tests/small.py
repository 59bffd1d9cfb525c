"""A cell shrunk to a size the CPU runs in seconds: 4096-sample clips
(8192 for TBPTT, whose 0.19 s clips give the r6 extractor valid LFOs where
0.09 s clips gave none), two rows a mix group, four pool batches,
256-sample TBPTT chunks; the trunk
convs in float32 where `float32` is asked, so that sound runs read at
rounding level on the CPU."""

from benchmark.harness.common import make_run


def shrink(run, float32: bool = False):
    tr = run.traffic
    run.config["n_samples"] = 8192 if tr["kind"] == "train_tbptt" else 4096
    if "mix" in tr:
        for g in tr["mix"]:
            g["rows"] = 2
        tr["batch_size"] = sum(g["rows"] for g in tr["mix"])
        tr["pool_batches"] = 4
        tr["corpus_seconds"] = 1.0
    else:
        tr["warmup_calls"] = 4
    if "stage2" in run.config:
        run.config["stage2"]["warmup_n_samples"] = 256
        run.config["stage2"]["step_n_samples"] = 256
    if float32:
        run.config["precision"]["trunk_convs"] = "float32"
    return run


def small_run(workload: str, seed: int = 1234567890123, seconds: float = 0.5, float32: bool = False):
    return shrink(make_run(workload, seed, seconds, False, device="cpu"), float32)
