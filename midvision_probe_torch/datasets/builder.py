"""Loader builder (counterpart of the JAX package's ``datasets/builder.py``).

Single process, no sharding: the loader yields stacked NHWC numpy batches
in the same order as the JAX package's loader for the same seed; the engine
moves them to the device. A small thread prefetcher overlaps item
generation with device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np

from midvision_probe_torch.config import instantiate


_PREFETCH = 2  # batches generated ahead of the consumer


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (``sampler.set_epoch``)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        stop = threading.Event()

        def _put(q: queue.Queue, item) -> bool:
            # bounded put that gives up once the consumer abandoned the
            # iterator, so the producer never blocks forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            try:
                for b in range(len(self)):
                    lo, hi = b * self.batch_size, (b + 1) * self.batch_size
                    items = [self.dataset[int(i)] for i in idx[lo:hi]]
                    if not _put(q, _stack(items)):
                        return
                _put(q, None)
            except BaseException as e:  # propagate into the consumer
                _put(q, e)

        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)


def _stack(items: list[dict]) -> dict:
    out: dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


def build_loader(dataset_cfg, split: str, batch_size: int, seed: int = 0) -> Loader:
    """Instantiate the dataset from config and wrap it: training splits
    shuffle and drop the last partial batch, like the JAX package's."""
    dataset = instantiate(dataset_cfg, split=split)
    is_train = "train" in split
    return Loader(
        dataset,
        batch_size=batch_size,
        shuffle=is_train,
        drop_last=is_train,
        seed=seed,
    )
