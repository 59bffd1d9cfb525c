"""Data parallelism over `torch.distributed` (the port's counterpart of
`mod_extraction_tpu/parallel/mesh.py`).

The JAX package shards every batch over a 1-D mesh of all visible devices,
keeps the parameters replicated and lets XLA insert the gradient all-reduce.
Here each process is one rank on one card, as `torchrun --nproc_per_node N`
starts them:

* every rank draws the same global batch (the loaders are config-seeded) and
  keeps its contiguous block of rows (`shard_batch`), or under a task's
  `sub_batch_size` its share of every sub-batch (`sub_batch_shares`);
* the parameters start equal on every rank (seeded init or the same
  checkpoint, checked by `check_replicated`) and stay equal: after each
  backward the gradients are averaged over the ranks (`all_reduce_grads`),
  and every rank takes the same optimizer step;
* the tasks average their metrics over the ranks (`reduce_metrics`), and
  weighted means take the global weight sum (`losses/losses.py::BatchWeights`).

Without a process group every helper is the identity, so the one-process
path runs exactly as before.  `run_ranks` starts ranks in spawned processes
on one host (the tests, `parallel/dryrun.py`, `chip_smoke.py`).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class World(NamedTuple):
    rank: int
    size: int
    local_rank: int


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> World:
    """This process's rank, the world size and the local rank (its card on
    this host); (0, 1, 0) without a process group."""
    if not is_distributed():
        return World(0, 1, 0)
    rank = dist.get_rank()
    return World(rank, dist.get_world_size(), int(os.environ.get("LOCAL_RANK", rank)))


def init_distributed(
    device: str | torch.device = "cuda", backend: Optional[str] = None, init_method: str = "env://"
) -> World:
    """Joins the process group that torchrun's `RANK`, `WORLD_SIZE` and
    `LOCAL_RANK` describe (its `MASTER_ADDR`/`MASTER_PORT` through
    `init_method="env://"`).  On the card the rank uses `cuda:LOCAL_RANK`
    and NCCL; on the CPU gloo; `backend` overrides the choice (gloo over
    CUDA tensors runs several ranks on one card, which NCCL refuses).

    Without torchrun's variables: a world of one and no process group.  A
    group that already exists is returned as it is."""
    if is_distributed():
        return world()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return World(0, 1, 0)
    from mod_extraction_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, rank=rank, world_size=size,
    )
    return World(rank, size, local)


@contextlib.contextmanager
def process_group(device: str | torch.device = "cuda"):
    """`init_distributed(device)` for the body of a `with`; a group made
    here is destroyed on the way out, also when the body raises (an
    entry point under torchrun: `cli.fit`, `cli.validate`)."""
    made = not is_distributed()
    w = init_distributed(device)
    try:
        yield w
    finally:
        if made and is_distributed():
            dist.destroy_process_group()


def barrier() -> None:
    """Waits for every rank (nothing without a process group)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def sub_batch_shares(batch_size: int, sub_batch_size: int, rank: int, world_size: int) -> list:
    """The global rows [lo, hi) that `rank` holds of each sub-batch of a
    sub-batched task, in order (a share may be empty).  Sub-batch i, rows
    [i * sub, (i + 1) * sub), is cut at floor(q * sub / W) for q = 0..W, and
    rank r takes its share q = (r + i) mod W.  The rotation spreads the
    larger and the empty shares over the ranks: every rank holds B / W rows
    in all, at least one.  The JAX package shards each sub-batch of its
    scan over the mesh; the rows a rank holds do not change the step, only
    which rank computes them."""
    if batch_size % world_size != 0:
        raise ValueError(f"global batch dim {batch_size} not divisible by process_count {world_size}")
    if batch_size % sub_batch_size != 0:
        raise ValueError(f"global batch dim {batch_size} not divisible by sub_batch_size {sub_batch_size}")
    shares = []
    for i in range(batch_size // sub_batch_size):
        q, base = (rank + i) % world_size, i * sub_batch_size
        shares.append((base + q * sub_batch_size // world_size, base + (q + 1) * sub_batch_size // world_size))
    return shares


def shard_batch(batch, rank: int, world_size: int, sub_batch_size: Optional[int] = None):
    """This rank's rows of the global batch (a nested dict of arrays or
    tensors, batch axis first): the contiguous block
    [rank * B / W, (rank + 1) * B / W), as `mesh.py::shard_batch` feeds a
    process; with `sub_batch_size`, its shares of the sub-batches
    (`sub_batch_shares`), one after another.  Every rank holds the full
    global batch.  World 1 returns the batch itself."""
    if world_size == 1:
        return batch

    def take(x):
        n = x.shape[0]
        if sub_batch_size is not None:
            rows = [np.arange(lo, hi) for lo, hi in sub_batch_shares(n, sub_batch_size, rank, world_size)]
            idx = np.concatenate(rows)
            return x[torch.as_tensor(idx)] if isinstance(x, torch.Tensor) else x[idx]
        if n % world_size != 0:
            raise ValueError(f"global batch dim {n} not divisible by process_count {world_size}")
        per = n // world_size
        return x[rank * per : (rank + 1) * per]

    return _tree_map(take, batch)


def put_replicated(payload, device: str | torch.device):
    """A nested dict of host arrays (or one array) copied whole to `device`
    on every rank, as `mesh.py::put_replicated` replicates it over the mesh:
    every rank holds the same data (corpora are built from config-seeded
    generators)."""
    return _tree_map(lambda x: torch.as_tensor(x).to(device), payload)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor; `t` without a group)."""
    if not is_distributed():
        return t
    with torch.profiler.record_function("dist.all_reduce"):
        t = t.clone()
        dist.all_reduce(t)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks (`t` without a group)."""
    if not is_distributed():
        return t
    return all_reduce_sum(t) / dist.get_world_size()


def all_reduce_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks as autograd sees it: its backward sums the
    ranks' cotangents, so a loss that every rank computes from the global sum
    sends each rank the whole gradient of its own rows."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def rank_sum() -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """What a task hands its losses for the global batch's sums
    (`WeightedLossDict(..., sum_over_ranks=)`): `all_reduce_sum_autograd`
    under a process group, None without one."""
    return all_reduce_sum_autograd if is_distributed() else None


def reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar metric averaged over the ranks, in one all-reduce: the
    mean over equal shards of a mean is the global mean, and the weighted
    losses are already scaled to it (`BatchWeights`)."""
    if not is_distributed():
        return metrics
    keys = list(metrics)
    mean = all_reduce_mean(torch.stack([metrics[k].to(torch.float32).reshape(()) for k in keys]))
    return dict(zip(keys, mean.unbind(0)))


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Averages the gradients over the ranks in place: one all-reduce of
    the flattened gradients (the same on every rank afterwards)."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    with torch.profiler.record_function("dist.all_reduce"):
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


def check_replicated(params: Iterable[torch.Tensor]) -> None:
    """Raises unless every rank holds rank 0's `params` bit for bit (one
    broadcast of the flattened values)."""
    if not is_distributed():
        return
    params = [p.detach() for p in params]
    if not params:
        return
    flat = torch._utils._flatten_dense_tensors(params)
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    if not torch.equal(ref, flat):
        bad = int((ref != flat).sum())
        raise RuntimeError(f"rank {dist.get_rank()}: {bad} of {flat.numel()} parameters differ from rank 0's")


# ---------------------------------------------------------------------------
# ranks in spawned processes
# ---------------------------------------------------------------------------


def _rank_main(index, fn, size, local_ranks, init_file, device, backend, args, results):
    os.environ.update(RANK=str(index), WORLD_SIZE=str(size), LOCAL_RANK=str(local_ranks[index]))
    torch.set_num_threads(1)
    init_distributed(device, backend=backend, init_method=f"file://{init_file}")
    try:
        results.put((index, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    args: Sequence[Any] = (),
    *,
    device: str = "cuda",
    backend: Optional[str] = None,
    local_ranks: Optional[Sequence[int]] = None,
    timeout: float = 120.0,
) -> list:
    """Runs `fn(*args)` in `world_size` spawned processes
    (`torch.multiprocessing.start_processes`), each a rank of one process
    group (a `file://` rendezvous in a temporary directory), and returns
    their results by rank.  `fn` and the results cross processes by pickle
    (`fn` by its import path).  `device` is each rank's device: the card
    by default, raising here without one (`utils/device.py`), or "cpu".
    `local_ranks` picks each rank's card (default: its rank).

    If a rank raises or dies, the others are ended and this raises
    `RuntimeError`; past `timeout` seconds every rank is killed and this
    raises `TimeoutError`.  No rank is left blocked in a collective."""
    from mod_extraction_tpu_torch.utils.device import resolve_device

    resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    local_ranks = list(local_ranks) if local_ranks is not None else list(range(world_size))
    out: Dict[int, Any] = {}

    def drain(wait: float) -> None:
        with contextlib.suppress(queue.Empty):
            while len(out) < world_size:
                rank, value = results.get(timeout=wait)
                out[rank] = value

    with tempfile.TemporaryDirectory() as tmp:
        procs = torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, local_ranks, os.path.join(tmp, "rendezvous"), device, backend, tuple(args),
                  results))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            # a rank's result must leave the pipe before the rank can exit
            while not procs.join(timeout=0.5):
                drain(0.0)
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} did not finish "
                                       f"within {timeout} s")
        except (torch.multiprocessing.ProcessRaisedException, torch.multiprocessing.ProcessExitedException) as e:
            failed = str(e)
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=5.0)
        if failed is not None:
            raise RuntimeError(_rank_errors(procs.error_files) or failed)
        drain(5.0)
        results.close()
    return [out[r] for r in range(world_size)]


def _rank_errors(error_files: Sequence[str]) -> str:
    """The tracebacks the failed ranks left (`start_processes` writes one
    file a failed rank), the first written first: the rank that failed
    first is the cause, the others mostly lost their peer."""
    errors = []
    for rank, path in enumerate(error_files):
        if os.path.exists(path):
            with open(path, "rb") as fh:
                errors.append((os.path.getmtime(path), f"rank {rank} failed:\n{pickle.load(fh)}"))
            os.unlink(path)
    return "\n".join(text for _, text in sorted(errors))


def to_numpy(tree):
    """A nested dict of tensors as numpy arrays (to return from a rank;
    bf16 as float32)."""

    def conv(t):
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _tree_map(conv, tree)
