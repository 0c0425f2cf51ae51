"""Loader builder (counterpart of the JAX package's ``datasets/builder.py``).

The loader yields stacked NHWC numpy batches in the same order as the JAX
package's loader for the same seed; the engine moves them to the device. A
small thread prefetcher overlaps item generation with device compute.
``shuffle_batch_order`` (the feature cache's loader) keeps each batch's
composition fixed, permutes the order of the batches per epoch and tags
each batch with its ``_batch_id``.

``num_shards``/``shard_index`` give each rank of a process group its slice
of the (shuffled) dataset, the ``DistributedSampler`` equivalent: every
``num_shards``-th index from ``shard_index``, after wrapping the index list
to a multiple of ``num_shards`` so that every shard has the same length
(ranks that disagree on the number of batches would hang a collective).
When the dataset does not divide, every batch carries ``_valid``, false on
the wrapped repeats, which training keeps (the reference's duplicates) and
evaluation drops.
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
                 drop_last: bool = False, seed: int = 0, shuffle_batch_order: bool = False,
                 num_shards: int | None = 1, shard_index: int | None = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shuffle_batch_order = shuffle_batch_order
        num_shards = 1 if num_shards is None else num_shards
        if shard_index is None:
            if num_shards > 1:
                # idx[None::k] would give every rank shard 0: all ranks
                # would train on the same data without an error
                raise ValueError("shard_index is required when num_shards > 1")
            shard_index = 0
        self.num_shards, self.shard_index = num_shards, shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (``sampler.set_epoch``)."""
        self.epoch = epoch

    def _padded(self) -> bool:
        """Whether shards carry wrapped repeats (the same on every rank, so
        every rank's batches have the same keys)."""
        return self.num_shards > 1 and len(self.dataset) % self.num_shards != 0

    def _indices(self) -> tuple[np.ndarray, np.ndarray]:
        """This shard's dataset indices and their validity (false on the
        wrapped repeats that even the shards out)."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        valid = np.ones(n, bool)
        if self._padded():
            total = (n // self.num_shards + 1) * self.num_shards
            idx, valid = np.resize(idx, total), np.resize(valid, total)
            valid[n:] = False
        return (idx[self.shard_index::self.num_shards],
                valid[self.shard_index::self.num_shards])

    def __len__(self) -> int:
        n = len(self._indices()[0])
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_order(self) -> np.ndarray:
        """The batches' order this epoch: as built, or (with
        ``shuffle_batch_order``) the JAX loader's epoch-seeded permutation."""
        order = np.arange(len(self))
        if self.shuffle_batch_order:
            np.random.RandomState(self.seed + 7919 * (self.epoch + 1)).shuffle(order)
        return order

    def __iter__(self) -> Iterator[dict]:
        idx, valid = self._indices()
        padded = self._padded()
        order = self._batch_order()
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
                for b in order:
                    lo, hi = b * self.batch_size, (b + 1) * self.batch_size
                    batch = _stack([self.dataset[int(i)] for i in idx[lo:hi]])
                    if padded:
                        batch["_valid"] = valid[lo:hi].copy()
                    if self.shuffle_batch_order:
                        batch["_batch_id"] = int(b)
                    if not _put(q, batch):
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


def build_loader(dataset_cfg, split: str, batch_size: int, seed: int = 0,
                 pair_dataset: bool = False, shuffle: bool | None = None,
                 shuffle_batch_order: bool = False, num_shards: int | None = 1,
                 shard_index: int | None = 0) -> Loader:
    """Instantiate the dataset from config and wrap it: training splits
    shuffle (unless ``shuffle`` says otherwise) and drop the last partial
    batch, like the JAX package's. ``pair_dataset`` asks the dataset for
    two-view pair items; ``num_shards``/``shard_index`` select a rank's
    shard."""
    kwargs = {"split": split}
    if pair_dataset:
        kwargs["pair_dataset"] = True
    dataset = instantiate(dataset_cfg, **kwargs)
    is_train = "train" in split
    return Loader(
        dataset,
        batch_size=batch_size,
        shuffle=is_train if shuffle is None else shuffle,
        drop_last=is_train,
        seed=seed,
        shuffle_batch_order=shuffle_batch_order,
        num_shards=num_shards,
        shard_index=shard_index,
    )
