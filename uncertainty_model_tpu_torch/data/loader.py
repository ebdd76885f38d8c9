"""Host data pipeline: threaded decode and a bounded prefetch queue (the
port of the JAX package's ``data/loader.py``).

Replaces the reference's torch ``DataLoader(num_workers=8)``
(main.py:102-105): one producer thread builds each batch on a pool of
``num_workers`` threads (decode with ``data/native.py``, whose ``zlib``
and library calls release the interpreter lock, then each pair's
transforms, a pair a task), and keeps up to ``prefetch`` batches ahead of
the consumer, so host decode overlaps device compute.  Where the
dataset's transform is a ``Compose`` that starts with ``ResizeImage``,
the batch's files are decoded and resized in one pass
(``decode_resize_batch``, the same floats) and the rest of the stack runs
on the arrays, as the JAX package's native backend does.
Per-sample RNG streams come from (seed, epoch, index), so augmentation
does not depend on the threads' scheduling, and the batches equal the JAX
package's native backend's.

``shard_index``/``num_shards`` split the index space per process, the
analogue of the reference's ``DistributedSampler``
(parallel_main.py:138-142).  Batches are ``{"left", "right"}`` NHWC float32
numpy arrays, as ``Trainer.train_step`` and ``evaluate_model`` take them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .native import decode_png, decode_resize_batch
from .transforms import Compose, ResizeImage

_BACKENDS = ("auto", "native")


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        drop_last: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
        backend: str = "auto",  # 'auto' | 'native': one decode path
    ) -> None:
        if backend not in _BACKENDS:
            raise ValueError(
                f"backend {backend!r}: the port decodes with its own PNG "
                f"decoder (data/native.py) and has no PIL path; use one of "
                f"{_BACKENDS}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0
        self.backend = backend
        self._fused_size = self._fused_decode_size()

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle order (DistributedSampler.set_epoch analogue)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self._shard_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_sizes(self) -> list[int]:
        """The sizes of the batches that iterating gives, in order."""
        full, rest = divmod(len(self._shard_indices()), self.batch_size)
        return [self.batch_size] * full + (
            [rest] if rest and not self.drop_last else [])

    def _shard_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(n)
        return order[self.shard_index :: self.num_shards]

    def _fused_decode_size(self):
        """The (H, W) of the transform's first stage where decode and
        resize can be fused, else None."""
        transform = getattr(self.dataset, "transform", None)
        if (isinstance(transform, Compose) and transform.transforms
                and isinstance(transform.transforms[0], ResizeImage)):
            return transform.transforms[0].size
        return None

    def _fetch_one(self, idx: int, rng: np.random.Generator) -> dict:
        """One pair, decoded and transformed with its own generator."""
        pair = {"left": decode_png(self.dataset.lefts[int(idx)]),
                "right": decode_png(self.dataset.rights[int(idx)])}
        transform = getattr(self.dataset, "transform", None)
        if transform is not None:
            return transform(pair, rng)
        return {k: np.asarray(v, np.float32) / 255.0 for k, v in pair.items()}

    def _batch(self, pool, batch_ids) -> dict:
        """One batch on ``pool``, each pair with the generator of (seed,
        epoch, index): where the transform starts with ``ResizeImage``, its
        files decoded and resized by ``decode_resize_batch`` and the rest of
        the stack applied to the arrays."""
        rngs = [np.random.default_rng((self.seed, self.epoch, int(i)))
                for i in batch_ids]
        if self._fused_size is None:
            pairs = list(pool.map(self._fetch_one, batch_ids, rngs))
        else:
            n = len(batch_ids)
            paths = ([self.dataset.lefts[int(i)] for i in batch_ids]
                     + [self.dataset.rights[int(i)] for i in batch_ids])
            decoded = decode_resize_batch(paths, *self._fused_size, pool=pool)
            rest = Compose(self.dataset.transform.transforms[1:])
            pairs = list(pool.map(
                lambda j, rng: rest({"left": decoded[j],
                                     "right": decoded[n + j]}, rng),
                range(n), rngs))
        return {"left": np.stack([p["left"] for p in pairs]),
                "right": np.stack([p["right"] for p in pairs])}

    def __iter__(self) -> Iterator[dict]:
        indices = self._shard_indices()
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce(pool):
            for batch_ids in batches:
                if stop.is_set():
                    return
                out_q.put(self._batch(pool, batch_ids))
            out_q.put(None)

        def produce_safe():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    produce(pool)
            except Exception as e:  # surfaces in the consumer
                out_q.put(e)

        thread = threading.Thread(target=produce_safe, daemon=True)
        thread.start()

        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
