"""Datasets, samplers and the data loader (counterpart of
``paddle_tpu/io/__init__.py``), the part a supervised training loop reads.

Batches are collated on the host as CPU tensors
(:func:`default_collate_fn`); :class:`DevicePrefetcher` moves them to the
card. Samplers draw from numpy exactly as the reference's do
(``np.random.permutation`` for ``RandomSampler``, ``RandomState(epoch)``
for ``DistributedBatchSampler``, ``RandomState(epoch_seed)`` for
``BucketedBatchSampler``), so a seed gives the same batches in both
packages. ``DataLoader`` iterates on the caller's thread:
``num_workers > 0``, process workers and the reference's native C++
collate and prefetch core are ROADMAP Queue 1 item 10. A loader whose
batch sampler is resumable (``BucketedBatchSampler``) passes
``state_dict``/``set_state_dict``/``advance``/``set_epoch`` through, and
:func:`resolve_resumable` finds that sampler under a prefetcher or a
loader.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "Subset", "Sampler",
    "SequenceSampler", "RandomSampler", "BatchSampler",
    "DistributedBatchSampler", "DataLoader", "default_collate_fn",
]


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item 10): the port's "
        "DataLoader iterates on the caller's thread")


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Sample ``i`` is ``tuple(t[i] for t in tensors)`` (numpy arrays or
    tensors, sharing their leading dim)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation from numpy's global generator (``np.random``), as the
    reference draws it; ``replacement=True`` draws ``randint``."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
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
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Indices sharded across ``num_replicas`` data-parallel ranks (the
    shuffle is ``RandomState(epoch)``). The port runs one process, so the
    defaults are one replica, rank 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.nranks = 1 if num_replicas is None else int(num_replicas)
        self.local_rank = 0 if rank is None else int(rank)
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank : self.total_size : self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors, field by field (tuples
    and lists by position, dicts by key; strings stay lists)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.cpu() for b in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(t)) for t in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return torch.from_numpy(np.asarray(batch))


class DataLoader:
    """Batches of ``dataset`` from ``batch_sampler`` (else a
    ``BatchSampler`` of ``batch_size``/``shuffle``/``drop_last``),
    collated by ``collate_fn`` (default :func:`default_collate_fn`), built
    on the iterating thread."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=False):
        if num_workers > 0:
            raise _not_ported(f"DataLoader(num_workers={num_workers})")
        if use_process_workers:
            raise _not_ported("DataLoader(use_process_workers=True)")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable:
            yield from self._iter_iterable()
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __call__(self):
        return iter(self)

    # -- resumable stream passthrough (crash recovery) -------------------
    def _resumable_sampler(self):
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "state_dict"):
            raise TypeError(
                "this DataLoader's batch sampler is not resumable; use "
                "io.BucketedBatchSampler (or any batch_sampler exposing "
                "state_dict/set_state_dict/advance) to checkpoint the "
                "data stream position")
        return bs

    def state_dict(self):
        """Resume point of the batch sampler (epoch, consumed-batch cursor,
        shuffle seed): what ``CheckpointManager.save(sampler=loader)``
        persists."""
        return self._resumable_sampler().state_dict()

    def set_state_dict(self, sd):
        self._resumable_sampler().set_state_dict(sd)

    load_state_dict = set_state_dict

    def advance(self, n=1):
        """Report ``n`` consumed batches to the batch sampler (the resume
        cursor counts trained batches, never read-ahead)."""
        self._resumable_sampler().advance(n)

    def set_epoch(self, epoch):
        bs = self.batch_sampler
        if bs is not None and hasattr(bs, "set_epoch"):
            bs.set_epoch(epoch)


# imported last: bucketing subclasses BatchSampler above
from .bucketing import BucketedBatchSampler, PadToBucket  # noqa: E402
from .prefetch import DevicePrefetcher  # noqa: E402

__all__ += ["BucketedBatchSampler", "PadToBucket", "DevicePrefetcher",
            "resolve_resumable"]


def resolve_resumable(stream):
    """Unwrap pipeline layers (DevicePrefetcher → its source, DataLoader →
    its batch sampler) down to the object owning the resumable stream
    state, or ``None`` when nothing in the stack supports it."""
    obj = stream
    for _ in range(8):  # bound on pathological nesting
        if isinstance(obj, DevicePrefetcher):
            obj = obj.source
        elif isinstance(obj, DataLoader):
            obj = obj.batch_sampler
        else:
            break
    if (obj is not None and hasattr(obj, "state_dict")
            and hasattr(obj, "set_state_dict") and hasattr(obj, "advance")):
        return obj
    return None
