"""Training/validation loop (the port's copy of
`mod_extraction_tpu/train/loop.py`).

The epoch loop runs over the host loader; batches reach the card through
pinned host memory and a side CUDA stream, one or two ahead of the step
that reads them.  Metrics are averaged over the epoch, `last` and
best-by-val-loss checkpoints are kept, and every log line goes to a JSONL
file, the console and (when the `tensorboard` package is there) TensorBoard,
with the step's `audio_sec_per_sec` and `lr`.

Under data parallelism (`parallel/dist.py`, a process group of one rank a
card) every rank iterates the same seeded epoch and keeps its block of each
batch's rows (of a train batch under the task's `sub_batch_size`, its share
of each sub-batch), the device corpus goes whole to every rank's card, and the
tasks return the global batch's metrics.  Only rank 0 writes metrics,
checkpoints, profiles and media; every rank restores the same checkpoint,
and the ranks meet at a barrier after each epoch's checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mod_extraction_tpu_torch.parallel.dist import (
    barrier,
    check_replicated,
    put_replicated,
    shard_batch,
    world,
)
from mod_extraction_tpu_torch.paths import ensure_dir
from mod_extraction_tpu_torch.train.checkpoints import CheckpointManager
from mod_extraction_tpu_torch.utils import spans

log = logging.getLogger(__name__)


def _mean_metrics(acc: list[Dict[str, Any]]) -> Dict[str, float]:
    """Mean over per-step metric dicts of device scalars: summed on the
    device, so the epoch costs one host read per key."""
    if not acc:
        return {}
    sums = acc[0]
    for m in acc[1:]:
        sums = {k: sums[k] + m[k] for k in sums}
    return {k: float(v) / len(acc) for k, v in sums.items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def host_batch_to_torch(batch: Dict, pin: bool = False) -> Dict:
    """A numpy batch dict -> CPU tensors of the same dtypes (int16 audio
    stays int16: `render_batch` dequantizes it on the card); pinned when
    `pin`, so that the copy to the card can be asynchronous."""

    def conv(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.pin_memory() if pin else t

    return _tree_map(conv, batch)


class MetricLogger:
    """Console + JSONL + TensorBoard metric sink.

    TensorBoard events go through the tensorboard package's own
    `EventFileWriter`; without the package the sink keeps to JSONL and the
    console with one warning (the JSONL file is the record either way)."""

    def __init__(self, out_dir: str, run_name: str, tensorboard: bool = True) -> None:
        self.out_dir = out_dir
        self.path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self._tb = None
        self._tb_dir = os.path.join(out_dir, f"{run_name}_tb")
        self._tb_wanted = tensorboard

    def _tb_writer(self):
        if self._tb is None and self._tb_wanted:
            try:
                from tensorboard.summary.writer.event_file_writer import EventFileWriter

                self._tb = EventFileWriter(ensure_dir(self._tb_dir))
            except Exception as e:  # the package is optional
                self._tb_wanted = False
                log.warning("tensorboard unavailable (%s); JSONL only", e)
        return self._tb

    def _log_tb(self, payload: Dict[str, Any]) -> None:
        tb = self._tb_writer()
        if tb is None:
            return
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary

        step = int(payload.get("step", payload.get("epoch", 0)))
        values = [
            Summary.Value(tag=k, simple_value=float(v))
            for k, v in payload.items()
            if k not in ("phase", "step", "epoch") and isinstance(v, (int, float))
        ]
        if values:
            tb.add_event(Event(wall_time=time.time(), step=step, summary=Summary(value=values)))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def log(self, payload: Dict[str, Any]) -> None:
        ensure_dir(self.out_dir)
        with open(self.path, "a") as f:
            f.write(json.dumps(payload) + "\n")
        self._log_tb(payload)
        parts = "  ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}" for k, v in payload.items()
        )
        log.info(parts)
        print(parts, flush=True)


class Trainer:
    """Fits a task (`train/lfo_task.py`, `train/tbptt_task.py`) on the
    batches of a data module, on the task's device.

    `sync_copies=True` copies each batch on the compute stream and waits for
    it, the reference the asynchronous copies are held against.
    `warm_start_params` (a state_dict of the task's trained model, or a
    zero-argument callable returning one) loads when no `last` checkpoint
    is resumed.  `profile_dir` turns on torch.profiler over the loop
    iterations that start after `profile_steps[0]` and before
    `profile_steps[1]` steps (default 10..15): each iteration is a step, its
    log line and the wait for the next batch.  The window goes to
    `profile_dir` as a Chrome trace and as `<run_name>_profile.json` (with
    the summary of its spans, `utils/spans.py`), and its wall time,
    device-busy time and idle share to the metric log; the time spent
    closing it is left out of the logged step times.

    `media_callback(trainer, batch, epoch)` (`utils/plotting.py`) gets val
    batch 0 on rank 0 in every `media_every_n_epochs`-th epoch (epoch 0
    included); under data parallelism that batch is rank 0's rows, the
    first of the global batch."""

    def __init__(
        self,
        task,
        data_module,
        max_epochs: int = 400,
        out_dir: str = "out",
        run_name: str = "run",
        media_callback: Optional[Callable] = None,
        media_every_n_epochs: int = 10,
        log_every_n_steps: int = 50,
        resume: bool = False,
        lr=None,  # float, or a function of the global step (display only)
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 15),
        check_finite: bool = True,
        warm_start_params: Optional[Any] = None,
        sync_copies: bool = False,
    ) -> None:
        self.task = task
        self.dm = data_module
        self.device = task.device
        self.world = world()
        self.is_chief = self.world.rank == 0  # the rank that writes
        self.max_epochs = max_epochs
        self.run_name = run_name
        self.out_dir = out_dir
        self.metrics = MetricLogger(out_dir, run_name)
        self.ckpts = CheckpointManager(os.path.join(out_dir, run_name + "_ckpts"))
        self.media_callback = media_callback
        self.media_every_n_epochs = max(1, int(media_every_n_epochs))
        self.log_every_n_steps = log_every_n_steps
        self.resume = resume
        self.lr = lr
        self.profile_dir = profile_dir if self.is_chief else None
        self.profile_steps = tuple(profile_steps)
        self._profiler = None
        self._profile_t0 = 0.0
        # NaN/Inf guard at log points and at the epoch boundary
        self.check_finite = check_finite
        self.warm_start_params = warm_start_params
        self.sync_copies = sync_copies
        self.corpus = None  # the device corpus (set by _attach_corpus)

    def _attach_corpus(self) -> None:
        """The device corpus (data/corpus.py), copied to the device once and
        passed to every step."""
        payload = getattr(self.dm, "corpus_payload", lambda: None)()
        if payload is not None:
            self.corpus = put_replicated(payload, self.device)

    def _host_batches(self, loader, epoch: int, pin: bool, depth: int = 2, sub_batch_size=None):
        """The loader's epoch as CPU tensor batches (this rank's rows;
        `shard_batch`'s `sub_batch_size`), made (and pinned) on a side
        thread up to `depth` batches ahead."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        err: list = []
        stop = threading.Event()  # set when the consumer abandons the epoch

        def _put(item) -> bool:
            """Bounded put that gives up once the consumer is gone, so an
            abandoned epoch (NaN guard, KeyboardInterrupt) does not leave
            this thread blocked."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            rank, size, _ = self.world
            try:
                for b in loader.epoch(epoch):
                    local = shard_batch(b, rank, size, sub_batch_size)
                    if stop.is_set() or not _put(host_batch_to_torch(local, pin)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                _put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                with spans.span("trainer.loader_wait"):
                    b = q.get()
                if b is None:
                    if err:
                        raise err[0]
                    return
                yield b
        finally:
            stop.set()
            while not q.empty():  # unblock a pending put promptly
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def _device_batches(self, loader, epoch: int, depth: int = 2, sub_batch_size=None):
        """The loader's epoch with each batch on the device (`sub_batch_size`:
        see `_host_batches`).

        On the card, each batch is copied from pinned memory on a side
        stream, `depth` batches ahead of the step that reads it: an event
        recorded after the copy is waited on by the compute stream before
        the step, and `record_stream` keeps the allocator from reusing a
        batch's memory before the compute stream is done with it.  The host's
        wait for the loader and the copies are spans (`utils/spans.py`:
        `trainer.loader_wait`, `trainer.batch_copy`)."""
        use_stream = self.device.type == "cuda" and not self.sync_copies
        host = self._host_batches(loader, epoch, pin=use_stream, sub_batch_size=sub_batch_size)
        if not use_stream:
            for b in host:
                with spans.span("trainer.batch_copy"):
                    b = _tree_map(lambda t: t.to(self.device), b)
                yield b
            return
        compute = torch.cuda.current_stream(self.device)
        copy_stream = torch.cuda.Stream(self.device)

        def issue(b):
            with torch.cuda.stream(copy_stream), spans.span("trainer.batch_copy"):
                d = _tree_map(lambda t: t.to(self.device, non_blocking=True), b)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return d, done

        ahead: deque = deque()
        for b in host:
            ahead.append(issue(b))
            if len(ahead) < depth:
                continue
            yield self._ready(ahead.popleft(), compute)
        while ahead:
            yield self._ready(ahead.popleft(), compute)

    @staticmethod
    def _ready(copied, compute):
        d, done = copied
        compute.wait_event(done)
        _tree_map(lambda t: t.record_stream(compute), d)
        return d

    def _restore_or_warm_start(self) -> tuple:
        """(start_epoch, global_step): from `last` when resuming and it
        exists, else from a warm start or from scratch."""
        step = self.ckpts.restore("last", self.task) if self.resume else None
        if step is not None:
            start_epoch = self.ckpts.meta("last").get("epoch", -1) + 1
            log.info("Resumed from epoch %d, step %d", start_epoch, step)
            return start_epoch, step
        if self.warm_start_params is not None:
            ws = self.warm_start_params
            self.task.trained_model.load_state_dict(ws() if callable(ws) else ws)
            log.info("Warm-started params (fresh optimizer state)")
        return 0, 0

    def _log(self, payload: Dict[str, Any]) -> None:
        if self.is_chief:
            self.metrics.log(payload)

    def _maybe_profile(self, global_step: int) -> float:
        """Opens the profiler before the first iteration of the window and
        closes it before the first one past it; returns the seconds spent
        closing it (summary and trace), which are not a step's time."""
        first, end = self.profile_steps
        if self.profile_dir and self._profiler is None and first <= global_step < end:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()
            self._profile_t0 = time.perf_counter()
        elif self._profiler is not None and global_step >= end:
            t0 = time.perf_counter()
            self._stop_profile()
            return time.perf_counter() - t0
        return 0.0

    def _stop_profile(self) -> None:
        if self._profiler is None:
            return
        from mod_extraction_tpu_torch.utils.timing import device_busy

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - self._profile_t0) * 1e3
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        busy_ms, events = device_busy(prof)
        by_span = spans.summary()  # the window's spans, host and device ms
        spans.clear()
        summary = {
            "phase": "profile",
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "loader_wait_ms": by_span.get("trainer.loader_wait", {}).get("host_ms", 0.0),
            "batch_copy_ms": by_span.get("trainer.batch_copy", {}).get("host_ms", 0.0),
        }
        self._log(summary)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        summary["top_device_ms"] = [[e.key, e.self_device_time_total / 1e3, e.count] for e in top]
        summary["spans"] = by_span
        out = ensure_dir(self.profile_dir)
        with open(os.path.join(out, f"{self.run_name}_profile.json"), "w") as f:
            json.dump(summary, f, indent=1)
        path = os.path.join(out, f"{self.run_name}_trace.json")
        prof.export_chrome_trace(path)
        log.info("profile written to %s", path)
        self.profile_dir = None

    def fit(self):
        if not getattr(self.task, "has_params", True):
            raise ValueError("this task has no parameters to train (the RandomLFO baseline)")
        self.dm.setup("fit")
        self._attach_corpus()
        start_epoch, global_step = self._restore_or_warm_start()
        check_replicated(self.task.trained_model.parameters())

        train_loader = self.dm.train_loader()
        val_loader = self.dm.val_loader()
        sr = self.dm.render_cfg.sr
        n_samples = self.dm.render_cfg.n_samples
        audio_sec_per_batch = self.dm.batch_size * n_samples / sr
        sub = getattr(self.task, "sub_batch_size", None)  # the rows a rank takes of a train batch

        for epoch in range(start_epoch, self.max_epochs):
            train_acc = []
            t_epoch = time.time()
            t_step = time.time()

            for batch in self._device_batches(train_loader, epoch, sub_batch_size=sub):
                t_step += self._maybe_profile(global_step)
                # the step's metrics stay on the device until a log point
                # or the epoch mean reads them
                metrics = self.task.train_step(batch, self.corpus)
                train_acc.append(metrics)
                global_step += 1
                if global_step % self.log_every_n_steps == 0:
                    last = {k: float(v) for k, v in train_acc[-1].items()}
                    if self.check_finite:
                        # a NaN anywhere in the window poisons its mean: one
                        # device reduction checks every step since the last
                        # log point
                        window = train_acc[-self.log_every_n_steps :]
                        losses = [m["loss"] for m in window if "loss" in m]
                        window_mean = float(torch.stack(losses).mean()) if losses else 0.0
                        if not np.isfinite(window_mean):
                            raise FloatingPointError(
                                f"non-finite loss within the last {len(window)} steps "
                                f"(at step {global_step}): latest={last}"
                            )
                    dt = time.time() - t_step
                    payload = {
                        "phase": "train_step",
                        "step": global_step,
                        "audio_sec_per_sec": self.log_every_n_steps * audio_sec_per_batch / dt,
                        **last,
                    }
                    if self.lr is not None:
                        payload["lr"] = self.lr(global_step) if callable(self.lr) else self.lr
                    self._log(payload)
                    t_step = time.time()
            self._stop_profile()  # an epoch shorter than the trace window

            val_metrics = self.validate(val_loader, epoch)
            payload = {
                "phase": "epoch",
                "epoch": epoch,
                "step": global_step,
                "epoch_time_s": time.time() - t_epoch,
            }
            payload.update({f"train/{k}": v for k, v in _mean_metrics(train_acc).items()})
            payload.update({f"val/{k}": v for k, v in val_metrics.items()})
            self._log(payload)

            if self.check_finite:
                # never checkpoint NaN params (the in-epoch check only fires
                # at log points)
                bad = {k: v for k, v in payload.items() if isinstance(v, float) and not np.isfinite(v)}
                if bad:
                    raise FloatingPointError(f"non-finite epoch metrics at epoch {epoch}: {bad}")
            if self.is_chief:
                self.ckpts.save_last(self.task, epoch, global_step)
                if "loss" in val_metrics:
                    self.ckpts.maybe_save_best(self.task, val_metrics["loss"], epoch, global_step)
            barrier()  # no rank runs ahead of (or resumes before) the checkpoint
        self.metrics.close()
        return self.task

    def validate(self, val_loader=None, epoch: int = 0) -> Dict[str, float]:
        if val_loader is None:
            self.dm.setup("validate")
            self._attach_corpus()
            val_loader = self.dm.val_loader()
        acc = []
        for i, b in enumerate(self._device_batches(val_loader, epoch)):
            acc.append(self.task.val_step(b, self.corpus))
            if (i == 0 and self.media_callback is not None and self.is_chief
                    and epoch % self.media_every_n_epochs == 0):
                self.media_callback(self, b, epoch)
        return _mean_metrics(acc)
