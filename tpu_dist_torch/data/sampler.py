"""Index samplers — counterpart of ``tpu_dist/data/sampler.py``.

The same index lists as the JAX package for every dataset size, world,
rank, epoch, shuffle and ``drop_last`` (the tests hold them equal), which
are torch's partition rules:

- the dataset is padded by repeating leading indices until the total is
  divisible by ``num_replicas`` (or truncated with ``drop_last=True``);
- rank ``r`` takes the strided slice ``indices[r::num_replicas]``;
- ``set_epoch(e)`` reseeds the permutation, so every rank agrees on the
  epoch-``e`` shuffle.

The shuffle is numpy's permutation seeded ``(seed, epoch)``, as in the JAX
package (not torch's ``randperm``).  One process drives one card here, so
``DistributedSampler``'s defaults are the default group's world size and
rank.  ``WeightedRandomSampler`` and ``SubsetRandomSampler`` draw from
numpy seeded ``(seed, epoch)`` in the JAX package's order."""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DistributedSampler", "WeightedRandomSampler",
           "SubsetRandomSampler"]


class Sampler:
    """Abstract iterable over dataset indices."""

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:
        """Advance the epoch counter (reshuffles stochastic samplers)."""


class SequentialSampler(Sampler):
    """Yields ``0..len(dataset)-1`` in order."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        return iter(range(len(self.dataset)))

    def __len__(self):
        return len(self.dataset)


class RandomSampler(Sampler):
    """Epoch-seeded permutation of the dataset (deterministic per epoch)."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        return iter(rng.permutation(len(self.dataset)).tolist())

    def __len__(self):
        return len(self.dataset)


class WeightedRandomSampler(Sampler):
    """``num_samples`` indices drawn with probability proportional to
    ``weights`` (torch's ``WeightedRandomSampler``: the weights need not
    sum to 1; ``replacement=False`` draws distinct indices), reshuffled by
    ``set_epoch``."""

    def __init__(self, weights, num_samples: int, replacement: bool = True,
                 seed: int = 0):
        self.weights = np.asarray(weights, dtype=np.float64)
        if self.weights.ndim != 1 or len(self.weights) == 0:
            raise ValueError("weights must be a non-empty 1-D sequence")
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        if self.weights.sum() == 0:
            raise ValueError("weights must not all be zero")
        if num_samples <= 0:
            raise ValueError(f"num_samples must be positive, got "
                             f"{num_samples}")
        nonzero = int((self.weights > 0).sum())
        if not replacement and num_samples > nonzero:
            raise ValueError(f"cannot draw {num_samples} distinct indices "
                             f"from {nonzero} positive weights without "
                             f"replacement")
        self.num_samples = num_samples
        self.replacement = replacement
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        p = self.weights / self.weights.sum()
        idx = rng.choice(len(self.weights), size=self.num_samples,
                         replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """An epoch-seeded permutation of a fixed index list (torch's
    ``SubsetRandomSampler``)."""

    def __init__(self, indices, seed: int = 0):
        self.indices = np.asarray(indices, dtype=np.int64)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        return iter(self.indices[rng.permutation(len(self.indices))].tolist())

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    """Chunks a sampler's index stream into lists of ``batch_size``."""

    def __init__(self, sampler: Sampler, batch_size: int, drop_last: bool):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)


class DistributedSampler(Sampler):
    """Shards a dataset across ``num_replicas`` ranks (default: the default
    group's world size and this process's rank; 1 and 0 without one)."""

    def __init__(self, dataset, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        if num_replicas is None or rank is None:
            from .. import dist
            up = dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if up else 1
            if rank is None:
                rank = dist.get_rank() if up else 0
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.set_world(rank, num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def set_world(self, rank: int, num_replicas: int) -> None:
        """Re-shard for another world.  The permutation is seeded by
        ``(seed, epoch)`` alone, so a re-sharded sampler yields what a new
        one at ``(rank, num_replicas)`` and the same epoch would."""
        num_replicas, rank = int(num_replicas), int(rank)
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank must be in [0, {num_replicas}), got rank={rank}")
        self.num_replicas = num_replicas
        self.rank = rank
        n = len(self.dataset)
        if self.drop_last and n % num_replicas != 0:
            self.num_samples = math.ceil((n - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(n / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        if self.drop_last:
            indices = indices[:self.total_size]
        else:
            padding = self.total_size - len(indices)
            if padding > 0:
                reps = math.ceil(padding / len(indices))
                indices += (indices * reps)[:padding]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples
