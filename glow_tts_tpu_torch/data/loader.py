"""Batching (port of ``glow_tts_tpu/data/loader.py``; numpy and the
standard library only).

* Length-aware batches: the indices are permuted from a seed, sorted by mel
  length inside windows of ``sort_factor`` batches, cut into batches and
  the batches shuffled, so a batch's lengths are close and its padding
  small.  The same dataset and seed give the same batches in the same order
  as the JAX package's loader.
* Producer threads collate the next batches while the consumer works; the
  consumer re-emits them in sampler order whatever the number of threads.
  The batches are numpy arrays: the copy to a device is the consumer's
  (the trainer's), on its own thread and stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np


class BatchSampler:
    """``num_shards``/``shard_index`` give per-process loading: every
    process applies the same seeded permutation and keeps a disjoint stride
    of it, so the processes together cover each epoch exactly once."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 sort_factor: int = 8, seed: int = 0,
                 drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sort_factor = sort_factor
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def __iter__(self) -> Iterator[Sequence[int]]:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.num_shards > 1:
            order = order[self.shard_index::self.num_shards]
            n = len(order)
        if self.shuffle and hasattr(self.dataset, 'mel_length'):
            window = self.batch_size * self.sort_factor
            chunks = []
            for start in range(0, n, window):
                chunk = order[start:start + window]
                lengths = np.array(
                    [self.dataset.mel_length(i) for i in chunk])
                chunks.append(chunk[np.argsort(lengths, kind='stable')])
            order = np.concatenate(chunks) if chunks else order
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and \
                len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        if self.shuffle:
            rng.shuffle(batches)
        self.epoch += 1
        yield from batches

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.num_shards > 1:
            n = len(range(self.shard_index, n, self.num_shards))
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)


class DataLoader:
    """Iterates collated numpy batches; with ``prefetch`` > 0, ``workers``
    producer threads collate up to ``prefetch`` batches ahead."""

    def __init__(self, dataset, collater: Callable, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1,
                 workers: int = 1):
        self.dataset = dataset
        self.collater = collater
        self.sampler = BatchSampler(dataset, batch_size, shuffle,
                                    seed=seed, drop_last=drop_last,
                                    shard_index=shard_index,
                                    num_shards=num_shards)
        self.prefetch = prefetch
        # threads, not processes: the work is pickle IO and numpy padding,
        # which release the interpreter lock
        self.workers = max(int(workers), 1)

    def __len__(self) -> int:
        return len(self.sampler)

    def _make_batch(self, indices) -> Dict[str, np.ndarray]:
        return self.collater([self.dataset[int(i)] for i in indices])

    def _produce(self, q: queue.Queue, iterator, lock, counter, stop):
        try:
            while not stop.is_set():
                with lock:
                    indices = next(iterator, None)
                    order = counter[0]
                    counter[0] += 1
                if indices is None:
                    break
                # tagged with its place in the sampler's order, in which
                # the consumer re-emits it
                q.put((order, self._make_batch(indices)))
        except Exception as error:            # raised in the consumer
            q.put(error)
        finally:
            q.put(None)                        # one sentinel per worker

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            for indices in self.sampler:
                yield self._make_batch(indices)
            return
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch,
                                                 self.workers))
        iterator = iter(self.sampler)
        lock, stop = threading.Lock(), threading.Event()
        counter = [0]
        threads = [threading.Thread(target=self._produce,
                                    args=(q, iterator, lock, counter, stop),
                                    daemon=True)
                   for _ in range(self.workers)]
        for t in threads:
            t.start()
        finished = 0
        pending: Dict[int, Any] = {}
        next_order = 0
        try:
            while finished < len(threads):
                item = q.get()
                if item is None:
                    finished += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                order, batch = item
                pending[order] = batch
                while next_order in pending:
                    yield pending.pop(next_order)
                    next_order += 1
        finally:
            # a consumer that stops early (or an error) ends the producers:
            # each sees ``stop`` after its current batch, and draining the
            # queue frees one blocked on a full queue
            stop.set()
            while finished < len(threads):
                finished += q.get() is None
            for t in threads:
                t.join()
