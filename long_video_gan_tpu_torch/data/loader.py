"""Host-side data loading: shuffled, sharded, prefetching infinite iterator.

The port's own copy of `long_video_gan_tpu/data/loader.py`: a threadpool
decodes and assembles sample dicts ahead of time, batches collate into numpy
arrays, and each of `num_shards` processes reads only its index shard.

Beside the JAX package's loader, the shards of one epoch hold equally many
batches (the epoch is cut to whole global batches), and a sample's random
stream is keyed on its place in the global stream, not in the shard's: so
`num_shards` processes at `batch_size` each read, sample for sample, the
global batches that one process reads at `num_shards * batch_size`. Global
row q of a batch is row q // num_shards of shard q % num_shards.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


def _collate(samples: list[dict]) -> dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class _Failed:
    """What the producer thread queues when it dies: its exception."""

    def __init__(self, error: BaseException):
        self.error = error


class InfiniteLoader:
    """Infinite shuffled batch iterator with background prefetch.

    Epoch semantics mirror DistributedSampler: every epoch reshuffles the full
    index list with (seed, epoch), cut to whole global batches of
    `num_shards * batch_size`; host `shard_id` of `num_shards` takes every
    num_shards-th index; drop_last always (batches are exact).
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 num_workers: int = 4, prefetch: int = 4):
        assert batch_size >= 1 and num_shards >= 1 and 0 <= shard_id < num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _index_stream(self):
        epoch = 0
        n = len(self.dataset)
        assert n > 0, "empty dataset"
        global_batch = self.batch_size * self.num_shards
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(n)
            usable = (n // global_batch) * global_batch
            if usable == 0:
                # Dataset smaller than one global batch: sample with
                # replacement so the stream still produces batches (otherwise
                # the producer would spin through empty epochs forever while
                # the consumer blocks).
                order, usable = rng.choice(order, size=global_batch, replace=True), global_batch
            shard = order[:usable][self.shard_id::self.num_shards]
            for i in range(0, len(shard), self.batch_size):
                yield epoch, shard[i:i + self.batch_size]
            epoch += 1

    def _produce(self):
        try:
            self._produce_batches()
        except BaseException as e:
            # Hand the error to the consumer, which would otherwise wait forever.
            self._queue.put(_Failed(e))

    def _produce_batches(self):
        sample_rng_counter = 0
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for epoch, indices in self._index_stream():
                if self._stop.is_set():
                    return
                base = sample_rng_counter
                sample_rng_counter += len(indices)

                def fetch(args):
                    offset, idx = args
                    place = (base + offset) * self.num_shards + self.shard_id
                    rng = np.random.default_rng((self.seed, 1, place))
                    return self.dataset.sample(int(idx), rng)

                samples = list(pool.map(fetch, enumerate(indices)))
                batch = _collate(samples)
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self._queue.get()
        if isinstance(batch, _Failed):
            self._queue.put(batch)
            raise RuntimeError("the data loader's producer thread failed") from batch.error
        return batch

    def close(self):
        self._stop.set()
        # Drain so the producer can exit its put().
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


def get_infinite_data_iter(dataset, batch_size: int, seed: Optional[int] = None,
                           shard_id: int = 0, num_shards: int = 1,
                           num_workers: int = 4, prefetch: int = 4) -> InfiniteLoader:
    seed = np.random.SeedSequence().entropy % (2 ** 31) if seed is None else seed
    return InfiniteLoader(dataset, batch_size, seed=int(seed), shard_id=shard_id,
                          num_shards=num_shards, num_workers=num_workers, prefetch=prefetch)
