"""DataLoader and DeviceLoader — counterpart of ``tpu_dist/data/loader.py``.

``DataLoader`` builds each batch as the JAX package's does: a dataset with
``gather(indices)`` materializes the whole batch with one fancy index, uint8
images become float32 in [0, 1], and the dataset's batched NHWC transform
runs with a numpy generator seeded ``(seed, rank, epoch, batch_index)``, so
every rank draws its own stream and a run is reproducible.  The batch is
then transposed to NCHW and collated into CPU tensors: the same bytes as the
JAX package's batch, in torch's layout.  ``num_workers=N`` builds batches on
N threads with an order-preserving window (numpy releases the interpreter
lock in the heavy slicing), as in the JAX package; abandoning the iterator
releases them.

``DataLoader(to_float=False)`` yields the gathered batch raw instead: uint8
NHWC, with no /255, no transform and no transpose, for ``DeviceAugment``.

``DeviceLoader`` stages the loader's batches onto this rank's device on a
background fill thread, ``prefetch`` batches ahead: on the card each tensor
is copied into pinned host memory and then onto the device with a
``non_blocking`` copy (torch's ``pin_memory``/``non_blocking`` idiom), so
batch assembly and the copy overlap the training step.  With ``augment=``
(a ``DeviceAugment``) the staged images are augmented there, on the
loader's device, with the key ``fold_in(fold_in(key(augment_seed), epoch),
batch_index)``, the JAX package's; the draws are made for the global batch
and the rank keeps its own rows, so every rank's images are the rows the
JAX package's mesh gives that device.  With
``local_shards=True`` (training) each rank's loader yields its own shard
(``DistributedSampler``); with ``local_shards=False`` (evaluation) every
rank's loader yields the identical global batch and the rank keeps its
contiguous slice of it, ``ceil(b / world)`` rows a rank — the rows the JAX
package's mesh gives that device."""

from __future__ import annotations

import collections
import math
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..ops._build import resolve_device
from .sampler import (BatchSampler, DistributedSampler, RandomSampler,
                      Sampler, SequentialSampler)

__all__ = ["DataLoader", "DeviceLoader", "default_collate"]


def _put_unless_stopped(q: "queue.Queue", stop: "threading.Event",
                        item) -> bool:
    """Blocking put that gives up once the consumer walked away; True iff
    the item was delivered."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def default_collate(samples: Sequence):
    """Stack a list of samples: tuples/lists collate element-wise, arrays
    and scalars stack into CPU tensors (torch's ``default_collate``)."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([s[i] for s in samples])
                     for i in range(len(first)))
    return torch.from_numpy(np.asarray(samples))


class _LoaderIter:
    """One epoch of batches; ``close()`` releases the worker threads."""

    def __init__(self, loader: "DataLoader"):
        self._loader = loader
        self._batches: List[List[int]] = list(loader._batch_sampler)
        self._epoch = loader._epoch
        self._pos = 0
        self._executor: Optional[ThreadPoolExecutor] = None
        self._inflight: collections.deque = collections.deque()
        self._submitted = 0
        if loader.num_workers > 0 and self._batches:
            self._executor = ThreadPoolExecutor(
                max_workers=loader.num_workers,
                thread_name_prefix="tpu_dist_torch-loader")
            self._window = loader.num_workers + loader.prefetch_factor

    def __iter__(self):
        return self

    def _fill(self):
        while (self._submitted < len(self._batches)
               and len(self._inflight) < self._window):
            bi = self._submitted
            self._inflight.append(self._executor.submit(
                self._loader._make_batch, bi, self._batches[bi], self._epoch))
            self._submitted += 1

    def __next__(self):
        if self._executor is not None:
            self._fill()
            if not self._inflight:
                self.close()
                raise StopIteration
            fut = self._inflight.popleft()
            try:
                return fut.result()
            except BaseException:
                self.close()
                raise
        if self._pos >= len(self._batches):
            raise StopIteration
        bi = self._pos
        self._pos += 1
        return self._loader._make_batch(bi, self._batches[bi], self._epoch)

    def close(self):
        """Stop the worker pool (safe to call repeatedly and mid-epoch)."""
        ex, self._executor = self._executor, None
        self._inflight.clear()
        if ex is not None:
            ex.shutdown(wait=False, cancel_futures=True)

    def __del__(self):
        self.close()


class DataLoader:
    """Batches a dataset through a sampler; see the module docstring.
    ``pin_memory`` is accepted for torch's signature: ``DeviceLoader`` pins
    what it copies to the card."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 sampler: Optional[Sampler] = None, drop_last: bool = False,
                 num_workers: int = 0, pin_memory: bool = False,
                 seed: int = 0, prefetch_factor: int = 2,
                 collate_fn=default_collate, to_float: bool = True):
        if sampler is not None and shuffle:
            raise ValueError("sampler and shuffle are mutually exclusive")
        if not to_float and getattr(dataset, "gather", None) is None:
            raise ValueError(
                "to_float=False needs a dataset with a vectorized gather() "
                "(ArrayImageDataset and the like); per-item datasets apply "
                "their transform inside __getitem__ and would yield float "
                "batches anyway")
        self.to_float = to_float
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = int(num_workers)
        self.pin_memory = pin_memory
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self.collate_fn = collate_fn
        self.sampler = sampler if sampler is not None else (
            RandomSampler(dataset, seed=seed) if shuffle
            else SequentialSampler(dataset))
        self._batch_sampler = BatchSampler(self.sampler, batch_size, drop_last)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling and augmentation for ``epoch``."""
        self._epoch = epoch
        self.sampler.set_epoch(epoch)

    def _rank_tag(self) -> int:
        rank = getattr(self.sampler, "rank", None)
        if rank is not None:
            return int(rank)
        from .. import dist
        return dist.get_rank() if dist.is_initialized() else 0

    def _make_batch(self, batch_index: int, indices: List[int], epoch: int):
        ds = self.dataset
        gather = getattr(ds, "gather", None)
        if gather is None:
            return self.collate_fn([ds[i] for i in indices])
        x, y = gather(np.asarray(indices, np.int64))
        if not self.to_float:  # raw bytes, NHWC: the DeviceAugment path
            return (torch.from_numpy(np.ascontiguousarray(x)),
                    torch.from_numpy(np.asarray(y)))
        if x.dtype == np.uint8:  # torch ToTensor scaling, still NHWC
            x = x.astype(np.float32) / 255.0
        transform = getattr(ds, "transform", None)
        if transform is not None:
            rng = np.random.default_rng(
                (self.seed, self._rank_tag(), epoch, batch_index))
            x = transform(x, rng)
        if x.ndim == 4:  # NHWC -> NCHW, once, here
            x = x.transpose(0, 3, 1, 2)
        return (torch.from_numpy(np.ascontiguousarray(x)),
                torch.from_numpy(np.asarray(y)))

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self) -> _LoaderIter:
        return _LoaderIter(self)


class DeviceLoader:
    """Stages a ``DataLoader``'s batches onto this rank's device ahead of
    use; see the module docstring.  ``device``: the group's device, else
    ``cuda`` (raises without one) unless named."""

    def __init__(self, loader: DataLoader, group=None, prefetch: int = 2,
                 local_shards: bool = True, augment=None,
                 augment_seed: int = 0, device=None):
        from .. import dist
        if group is None and dist.is_initialized():
            group = dist.get_default_group()
        self.loader = loader
        self.group = group
        self.world = group.size() if group is not None else 1
        self.rank = group.rank if group is not None else 0
        self.device = resolve_device(
            device if device is not None
            else group.device if group is not None else None)
        self.prefetch = max(1, int(prefetch))
        self.local_shards = local_shards
        self.augment = augment
        self.augment_seed = int(augment_seed)
        self._epoch = 0
        if (self.world > 1 and local_shards and not isinstance(
                getattr(loader, "sampler", None), DistributedSampler)):
            warnings.warn(
                "DeviceLoader(local_shards=True) at world > 1 takes each "
                "rank's batches as its own shard, but the DataLoader has no "
                "DistributedSampler: every rank would train on the same "
                "rows. Shard with DistributedSampler, or pass "
                "local_shards=False for identical global batches (the "
                "evaluation pattern).", stacklevel=2)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the loader's shuffle and the augmentation for ``epoch``."""
        self._epoch = int(epoch)
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def _rows(self, n: int) -> tuple:
        """``(offset, total)``: where this rank's ``n`` staged rows sit in
        the global batch (``ceil(n / world)`` rows a rank of the identical
        global batch with ``local_shards=False``)."""
        if self.local_shards:
            return self.rank * n, self.world * n
        per = math.ceil(n / self.world)
        return min(self.rank * per, n), n

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        if not self.local_shards and self.world > 1:
            per = math.ceil(t.shape[0] / self.world)
            t = t[self.rank * per:(self.rank + 1) * per]
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _stage_batch(self, batch, key):
        """Stage ``batch`` and, with ``augment``, augment its images on the
        device with ``key``: the draws of the global batch, this rank's
        rows."""
        staged = tuple(self._stage(t) for t in batch)
        if self.augment is None:
            return staged
        rows = self._rows(batch[0].shape[0])
        return (self.augment(staged[0], key, rows=rows),) + staged[1:]

    def __iter__(self) -> Iterator:
        from .. import random
        base = None
        if self.augment is not None:
            # host keys: DeviceAugment draws on the host
            base = random.fold_in(random.key(self.augment_seed), self._epoch)
        it = iter(self.loader)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def fill():
            # assemble and stage ahead of the consumer; a full queue blocks
            # here, re-checking `stop` so an abandoned iterator releases us
            try:
                for i, batch in enumerate(it):
                    key = None if base is None else random.fold_in(base, i)
                    staged = self._stage_batch(batch, key)
                    if not _put_unless_stopped(q, stop, (None, staged)):
                        return
                _put_unless_stopped(q, stop, (None, end))
            except BaseException as e:  # re-raised on the consumer's side
                _put_unless_stopped(q, stop, (e, None))
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

        thread = threading.Thread(target=fill, daemon=True,
                                  name="tpu_dist_torch-device-loader")
        thread.start()
        try:
            while True:
                exc, item = q.get()
                if exc is not None:
                    raise exc
                if item is end:
                    break
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer parked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
