"""Task scheduling and host-to-device prefetch (a copy of
``hero_tpu/data/loader.py`` with the device placement in torch).

- :class:`MetaLoader`: the weighted multi-task schedule, one task an
  optimizer step, drawn from a seeded ``random.Random``, so every process
  draws the same sequence (the JAX package's, draw for draw).
- :class:`PrefetchLoader`: a background thread builds the next numpy
  batch, copies it into pinned memory and starts its copy to the card
  (``non_blocking``), so batch assembly and the transfer overlap the
  running step.  A failure in the thread is raised on the consumer's.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


class BatchSampler:
    """Infinite shuffled index batches over a dataset, rank-sharded
    (``hero_tpu/data/loader.py:24-88``)."""

    def __init__(self, n_items: int, batch_size: int, seed: int = 0,
                 rank: int = 0, world_size: int = 1,
                 drop_last: bool = True):
        self.n = n_items
        self.bs = batch_size
        self.seed = seed
        self.rank = rank
        self.world = world_size
        self.drop_last = drop_last

    def epoch_batches(self, epoch: int) -> List[List[int]]:
        rng = random.Random(self.seed * 1_000_003 + epoch)
        full = list(range(self.n))
        rng.shuffle(full)
        idx = full[self.rank::self.world]
        if not idx and self.n:
            # this rank's shard is empty (n_items < world_size): take one
            # item of the shuffled list so every rank still trains
            idx = [full[self.rank % self.n]]
        if 0 < len(idx) < self.bs:
            # fewer items than one batch: top up with other ranks' items
            # of the same epoch (rotated by rank) before repeating, so no
            # batch is copies of one example
            own = set(idx)
            extra = [i for i in full if i not in own]
            if extra:
                rot = self.rank % len(extra)
                extra = extra[rot:] + extra[:rot]
            idx = (idx + extra)[:self.bs]
            if len(idx) < self.bs:  # dataset smaller than one batch
                idx = (idx * -(-self.bs // len(idx)))[:self.bs]
        batches = [idx[i:i + self.bs]
                   for i in range(0, len(idx) - self.bs + 1, self.bs)]
        tail = idx[len(batches) * self.bs:]
        if tail and not self.drop_last:
            batches.append((tail + idx)[:self.bs])
        return batches

    def __iter__(self) -> Iterator[Tuple[int, List[int]]]:
        if self.n == 0:
            raise ValueError("BatchSampler over an empty dataset")
        epoch = 0
        while True:
            for b in self.epoch_batches(epoch):
                yield epoch, b
            epoch += 1


class MetaLoader:
    """Weighted random task choice per optimizer step, identical in every
    process.  ``loaders``: {task name: (iterator, ratio)}; a task is drawn
    once every ``accum_steps`` micro-batches."""

    def __init__(self, loaders: Dict[str, Tuple[Iterator, int]],
                 accum_steps: int = 1, seed: int = 0):
        assert loaders
        self.name2iter = {}
        self.sampling_pools: List[str] = []
        for name, (it, ratio) in loaders.items():
            self.name2iter[name] = it
            self.sampling_pools.extend([name] * ratio)
        self.accum_steps = accum_steps
        self.rng = random.Random(seed)
        self.step = 0
        self._task = self.sampling_pools[0]

    def fast_forward(self, n_micro_batches: int) -> None:
        """Resume: replay the first ``n_micro_batches`` task draws and skip
        the batches they took in every task iterator without building
        them.  Call before iterating."""
        assert self.step == 0, "fast_forward must precede iteration"
        counts: Dict[str, int] = {}
        for s in range(n_micro_batches):
            if s % self.accum_steps == 0:
                self._task = self.rng.choice(self.sampling_pools)
            counts[self._task] = counts.get(self._task, 0) + 1
        self.step = n_micro_batches
        for name, c in counts.items():
            it = self.name2iter[name]
            if hasattr(it, "skip"):
                it.skip(c)
            else:
                for _ in range(c):
                    next(it)

    def __iter__(self):
        while True:
            if self.step % self.accum_steps == 0:
                self._task = self.rng.choice(self.sampling_pools)
            self.step += 1
            yield self._task, next(self.name2iter[self._task])


PREFETCH_DEPTH = 2        # batches the prefetch thread builds ahead


def to_device(batch: Dict[str, Any], device,
              host_keys=()) -> Dict[str, Any]:
    """The numpy arrays of ``batch`` as tensors on ``device``: for a CUDA
    device each goes through pinned memory and a ``non_blocking`` copy.
    Keys in ``host_keys`` and values that are not arrays stay as they
    are."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k in host_keys or not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class PrefetchLoader:
    """Iterate (tag, numpy batch) pairs with each batch built and placed on
    ``device`` by a background thread (:func:`to_device`, ``host_keys``
    left on the host), up to ``PREFETCH_DEPTH`` batches ahead."""

    def __init__(self, it: Iterator, device="cuda", host_keys=()):
        self.it = it
        self.device = device
        self.host_keys = host_keys

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        stop = object()
        err: List[BaseException] = []
        done = threading.Event()          # the consumer has stopped

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            # an exception in the wrapped iterator must crash the
            # consumer, not end its iteration as if the data ran out
            try:
                for tag, batch in self.it:
                    if not put((tag, to_device(batch, self.device,
                                               self.host_keys))):
                        return
            except BaseException as e:  # re-raised on the main thread
                err.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise RuntimeError(
                            "prefetch worker failed mid-iteration"
                        ) from err[0]
                    return
                yield item
        finally:
            # a consumer that stops early (a train loop at its last step)
            # lets the thread finish its batch and end
            done.set()


class DatasetIterator:
    """Infinite, epoch-aware batch iterator over a task dataset, with a
    cheap ``skip`` (index batches advance without building items)."""

    def __init__(self, dataset, batch_builder: Callable, batch_size: int,
                 seed: int = 0, rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_builder = batch_builder
        self._sampler_it = iter(BatchSampler(len(dataset), batch_size,
                                             seed=seed, rank=rank,
                                             world_size=world_size))

    def skip(self, n: int) -> None:
        for _ in range(n):
            next(self._sampler_it)

    def __iter__(self):
        return self

    def __next__(self):
        epoch, indices = next(self._sampler_it)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        return self.batch_builder(self.dataset, indices)


def dataset_iterator(dataset, batch_builder: Callable, batch_size: int,
                     seed: int = 0, rank: int = 0, world_size: int = 1):
    """Infinite (epoch-aware) batch iterator over a task dataset."""
    return DatasetIterator(dataset, batch_builder, batch_size, seed=seed,
                           rank=rank, world_size=world_size)
