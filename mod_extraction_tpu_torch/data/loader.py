"""Batch collation + threaded prefetch (the port's copy of
`mod_extraction_tpu/data/loader.py`).

Dataset work here is I/O-bound (wav chunk reads; the DSP runs on the
card), so a small thread pool with a prefetch queue is enough.  Batches are
fixed-shape numpy dicts; the Trainer moves them to the card
(`train/loop.py::Trainer._device_batches`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np

from mod_extraction_tpu_torch.data.constants import FX_FLOAT_KEYS, FX_INT_KEYS


def collate(
    items: List[Dict[str, Any]], transfer_dtype: str = "float32"
) -> Dict[str, Any]:
    """Stack example dicts into a fixed-shape batch dict.

    transfer_dtype="int16" quantizes the audio wire format — halves
    host->device traffic and is exact for PCM16-sourced wavs;
    render_batch dequantizes on the card."""

    def audio(key):
        a = np.stack([it[key] for it in items]).astype(np.float32)
        if transfer_dtype == "int16":
            return np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
        return a

    batch = {
        "mod_sig": np.stack([it["mod_sig"] for it in items]).astype(np.float32),
    }
    # device-resident corpus mode (data/corpus.py): offsets, no audio
    for side in ("dry", "wet"):
        if f"{side}_idx" in items[0]:
            batch[f"{side}_idx"] = np.asarray(
                [it[f"{side}_idx"] for it in items], np.int32
            )
            batch[f"{side}_gain"] = np.asarray(
                [it[f"{side}_gain"] for it in items], np.float32
            )
        elif side in items[0]:  # "wet" is absent for render-on-device sets
            batch[side] = audio(side)
    fx: Dict[str, np.ndarray] = {}
    for k in FX_FLOAT_KEYS:
        fx[k] = np.asarray([it["fx"].get(k, 0.0) for it in items], np.float32)
    for k in FX_INT_KEYS:
        fx[k] = np.asarray([it["fx"].get(k, 0) for it in items], np.int32)
    batch["fx"] = fx
    return batch


class _Failed:
    """A batch that raised on a loader thread."""

    def __init__(self, error: BaseException) -> None:
        self.error = error


class Loader:
    """Epoch iterator over a dataset with drop_last batching.

    `shuffle` permutes example indices within the epoch (draw-style
    datasets are index-seeded, so this reorders reproducibly)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        transfer_dtype: str = "float32",
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.transfer_dtype = transfer_dtype

    def n_batches(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch_idx, 7])
            ).shuffle(order)
        n_batches = self.n_batches()

        def make_batch(b: int) -> Dict[str, Any]:
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset.getitem(epoch_idx, int(i)) for i in idxs]
            return collate(items, self.transfer_dtype)

        if self.num_workers <= 1 or n_batches <= 1:
            for b in range(n_batches):
                yield make_batch(b)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()  # set when the consumer abandons the epoch

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone, so an
            abandoned epoch does not leave the producer blocked on a full
            queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # bounded submission: at most workers+prefetch batches are in
            # flight, so host RAM stays O(prefetch) instead of O(epoch)
            # (the put waits while the queue is full, giving downstream
            # backpressure)
            from collections import deque

            pending: deque = deque()
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    try:
                        b_next = 0
                        while (b_next < n_batches or pending) and not stop.is_set():
                            while b_next < n_batches and len(pending) < (
                                self.num_workers + self.prefetch
                            ):
                                pending.append(pool.submit(make_batch, b_next))
                                b_next += 1
                            if not put(pending.popleft().result()):
                                break
                    finally:
                        # an abandoned or failed epoch: the batches not yet
                        # started are dropped, not made
                        for f in pending:
                            f.cancel()
            except BaseException as e:
                # the consumer re-raises it (the JAX package's loader
                # leaves its consumer waiting for a batch that never comes)
                put(_Failed(e))

        thread = threading.Thread(target=producer, name="Loader.producer", daemon=True)
        thread.start()
        try:
            for _ in range(n_batches):
                item = q.get()
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
