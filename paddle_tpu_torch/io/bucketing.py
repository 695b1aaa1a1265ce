"""Shape-bucketed batching (counterpart of ``paddle_tpu/io/bucketing.py``):
the resumable batch sampler and the pad-to-bucket collate.

``BucketedBatchSampler`` groups samples by length into a small set of
buckets, and ``PadToBucket`` pads every batch up to its bucket boundary
(with a validity mask), so an epoch of varying lengths meets O(buckets)
input signatures of the fused step (one CUDA graph each). The sampler is
also the resumable stream the supervised loop checkpoints: an (epoch,
cursor, epoch seed) triple advanced once per trained batch. Its shuffles
are ``np.random.RandomState(epoch_seed)`` draws in the reference's order,
so a seed gives the same batches in both packages. ``PadToBucket`` gives
CPU tensors (``as_tensor=False``: numpy arrays).
"""

from __future__ import annotations

import bisect

import numpy as np

import torch

from . import BatchSampler

__all__ = ["BucketedBatchSampler", "PadToBucket"]


def _sample_length(sample):
    """Default length of one sample: leading dim of its FIRST array field
    (the conventional ids-first layout). Scalars/strings have no length."""
    if isinstance(sample, (torch.Tensor, np.ndarray)):
        return int(sample.shape[0]) if sample.ndim else None
    if isinstance(sample, (list, tuple)):
        for field in sample:
            n = _sample_length(field)
            if n is not None:
                return n
        return None
    if isinstance(sample, dict):
        for field in sample.values():
            n = _sample_length(field)
            if n is not None:
                return n
        return None
    return None


class BucketedBatchSampler(BatchSampler):
    """Group sample indices by length into pad-up buckets; every yielded
    batch draws from ONE bucket, so the padded batch shapes an epoch
    produces number at most ``len(boundaries) + 1``.

    Arguments:
        dataset: map-style dataset (indexable).
        batch_size: samples per batch.
        boundaries: strictly increasing bucket upper bounds, e.g.
            ``[64, 128, 256]`` — a sample of length L lands in the first
            bucket with boundary >= L. Longer samples go to an overflow
            bucket (batched together but unbucketed in shape: each distinct
            overflow length still costs a capture, which
            ``jit.cache_stats()`` makes visible).
        lengths: optional per-sample lengths (any sequence). When omitted
            the dataset is scanned once with ``length_fn`` — pass
            precomputed lengths for datasets where ``__getitem__`` is
            expensive.
        length_fn: sample -> length; defaults to the leading dim of the
            sample's first array field.
        shuffle: shuffle samples inside each bucket AND the order of the
            yielded batches each epoch.
        drop_last: drop each bucket's trailing partial batch.
        seed: base seed for shuffling (epoch ``e`` streams from
            ``seed + e``). When omitted each epoch draws a fresh random
            seed — different order every epoch, as before — but the draw
            is *recorded* (``state_dict()``'s ``epoch_seed``) so a crash
            mid-epoch still replays the exact in-flight permutation.

    Resumable stream contract (crash recovery): the sampler carries an
    (epoch, cursor, seed) triple. The *consumer* reports consumption with
    ``advance(n)`` — one call per trained batch — so read-ahead layers
    (DataLoader workers, DevicePrefetcher staging) never inflate the
    cursor with batches that were produced but not yet trained.
    ``state_dict()/set_state_dict()`` round-trip the triple (persisted by
    ``CheckpointManager.save(sampler=...)``), and the next ``__iter__``
    skips the first ``cursor`` batches of the epoch — a restart replays
    the exact remaining batch sequence. ``set_epoch(e)`` resets the cursor
    when ``e`` differs from the current epoch (so a resume that re-enters
    the same epoch keeps its place, and the next epoch starts clean).
    """

    def __init__(self, dataset=None, batch_size=1, boundaries=None,
                 lengths=None, length_fn=None, shuffle=False, drop_last=False,
                 seed=None):
        if boundaries is None:
            raise ValueError("BucketedBatchSampler requires bucket "
                             "boundaries, e.g. boundaries=[64, 128, 256]")
        self.boundaries = tuple(sorted(int(b) for b in boundaries))
        if len(set(self.boundaries)) != len(self.boundaries):
            raise ValueError(f"duplicate boundary in {boundaries}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self._cursor = 0  # batches CONSUMED this epoch (advance())
        # the seed actually governing the CURRENT epoch's shuffle. Seeded:
        # seed + epoch (old behavior). Unseeded: a fresh draw per epoch
        # (old behavior) that is RECORDED here and in state_dict(), so a
        # crash mid-epoch can still replay the exact in-flight permutation
        self._epoch_seed = self._draw_epoch_seed()
        self._seed_restored = False  # pins a set_state_dict-restored seed
        # against the unseeded fresh-pass redraw (a resume at cursor 0
        # must still replay the RECORDED permutation)
        if lengths is None:
            fn = length_fn or _sample_length
            lengths = []
            for i in range(len(dataset)):
                n = fn(dataset[i])
                if n is None:
                    raise ValueError(
                        f"could not infer a length for sample {i}; pass "
                        "lengths= or length_fn=")
                lengths.append(n)
        self.lengths = [int(x) for x in lengths]
        # bucket id per sample; len(boundaries) = overflow
        self._bucket_of = [bisect.bisect_left(self.boundaries, n)
                           for n in self.lengths]

    def _draw_epoch_seed(self):
        if self.seed is not None:
            return int(self.seed) + self._epoch
        return int(np.random.randint(0, 2**31 - 1))

    def set_epoch(self, epoch):
        epoch = int(epoch)
        if epoch != self._epoch:
            # a NEW epoch starts from its first batch with a fresh stream;
            # a resume re-entering the restored epoch keeps its place
            self._cursor = 0
            self._epoch = epoch
            self._epoch_seed = self._draw_epoch_seed()
            self._seed_restored = False

    # -- resumable stream (crash recovery) -------------------------------
    def advance(self, n=1):
        """Report that ``n`` more batches of the stream were *consumed*
        (trained on, or — on the divergence-rollback path — deliberately
        skipped). Called by the training driver, not the loader, so
        prefetch read-ahead never skews the resume cursor.

        Rolling past the end of an epoch carries the remainder into the
        next epoch deterministically: the epoch increments, the cursor
        keeps the overshoot, and the epoch seed is re-drawn exactly as a
        real epoch transition would draw it (``seed + epoch`` when
        seeded) — so a rollback skip that lands near an epoch edge
        resumes the same batch sequence a step-by-step consumer would
        have seen."""
        self._cursor += int(n)
        n_batches = len(self)
        while n_batches and self._cursor >= n_batches:
            self._cursor -= n_batches
            self._epoch += 1
            self._epoch_seed = self._draw_epoch_seed()
            # the drawn seed is BINDING for the new epoch's first pass: a
            # checkpoint written at this boundary records it, so the live
            # process's next __iter__ must use it too (an unseeded
            # redraw there would make interrupted and uninterrupted runs
            # train different permutations)
            self._seed_restored = True

    def state_dict(self):
        """Resume point of the batch stream: ``(epoch, cursor, seed)``
        plus a stream fingerprint (sample count / batch size / boundaries)
        so a restore into a differently-configured pipeline fails loudly
        instead of silently replaying the wrong batches."""
        return {"epoch": self._epoch, "cursor": self._cursor,
                "epoch_seed": self._epoch_seed,
                "shuffle": bool(self.shuffle),
                "num_samples": len(self.lengths),
                "batch_size": int(self.batch_size),
                "boundaries": list(self.boundaries)}

    def set_state_dict(self, sd):
        fingerprint = {"num_samples": len(self.lengths),
                       "batch_size": int(self.batch_size),
                       "boundaries": list(self.boundaries),
                       "shuffle": bool(self.shuffle)}
        for key, have in fingerprint.items():
            if key not in sd:
                continue
            got = (list(sd[key]) if key == "boundaries"
                   else type(have)(sd[key]))
            if got != have:
                raise ValueError(
                    f"sampler state mismatch on {key!r}: checkpoint has "
                    f"{got!r}, this sampler has {have!r} — resuming "
                    "would replay a different batch sequence")
        self._epoch = int(sd["epoch"])
        self._cursor = int(sd["cursor"])
        if sd.get("epoch_seed") is not None:
            self._epoch_seed = int(sd["epoch_seed"])
            self._seed_restored = True

    load_state_dict = set_state_dict

    def bucket_histogram(self):
        """{boundary_or_'overflow': sample_count} — pipeline telemetry
        (how well the boundaries fit the data)."""
        hist = {}
        for b in self._bucket_of:
            key = (self.boundaries[b] if b < len(self.boundaries)
                   else "overflow")
            hist[key] = hist.get(key, 0) + 1
        return hist

    def _epoch_batches(self):
        """The full batch sequence of the current epoch — a pure function
        of the recorded epoch seed, so a restarted process rebuilds the
        exact same sequence before applying the resume cursor."""
        buckets: dict[int, list[int]] = {}
        order = range(len(self.lengths))
        rng = None
        if self.shuffle:
            rng = np.random.RandomState(self._epoch_seed)
            order = rng.permutation(len(self.lengths))
        for i in order:
            buckets.setdefault(self._bucket_of[i], []).append(int(i))
        batches = []
        for b in sorted(buckets):
            idxs = buckets[b]
            for lo in range(0, len(idxs), self.batch_size):
                batch = idxs[lo:lo + self.batch_size]
                if len(batch) < self.batch_size and self.drop_last:
                    continue
                batches.append(batch)
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        return batches

    def __iter__(self):
        # the cursor (batches already consumed this epoch, per advance())
        # is 0 unless a checkpoint resume restored a mid-epoch position —
        # consumers that never call advance() see full epochs, unchanged.
        # A fully-consumed epoch rolls over automatically, so resume-armed
        # loops that never call set_epoch still make progress (and a
        # checkpoint taken exactly at an epoch boundary resumes into the
        # NEXT epoch instead of yielding an empty pass).
        batches = self._epoch_batches()
        if batches and self._cursor >= len(batches):
            # carry the overshoot, don't truncate it: a restored cursor
            # past the epoch end (e.g. a rollback skip persisted at an
            # epoch edge) must land mid-next-epoch, not at its start
            while self._cursor >= len(batches):
                self._cursor -= len(batches)
                self._epoch += 1
                self._epoch_seed = self._draw_epoch_seed()
                self._seed_restored = False
            batches = self._epoch_batches()
        elif (self._cursor == 0 and self.seed is None
              and not self._seed_restored):
            # unseeded fresh pass: a new random order every epoch (the
            # pre-resumability behavior), recorded so a crash mid-pass
            # still replays this exact permutation. A seed just restored
            # by set_state_dict is pinned — a resume landing exactly on an
            # epoch boundary must replay the RECORDED permutation
            self._epoch_seed = self._draw_epoch_seed()
            batches = self._epoch_batches()
        return iter(batches[self._cursor:])

    def __len__(self):
        counts: dict[int, int] = {}
        for b in self._bucket_of:
            counts[b] = counts.get(b, 0) + 1
        if self.drop_last:
            return sum(c // self.batch_size for c in counts.values())
        return sum((c + self.batch_size - 1) // self.batch_size
                   for c in counts.values())


class PadToBucket:
    """Collate: stack samples, zero-padding each variable-length array field
    up to the batch's bucket boundary, and append a validity mask.

    Field selection: an array field is padded when its leading dim equals
    the sample's length (``length_fn``, default: leading dim of the first
    array field). Pass ``pad_fields`` (tuple indices or dict keys) to make
    the selection explicit for layouts where fixed-size fields could
    coincide with the length.

    The mask (1 = real position, 0 = padding, shape ``[B, bucket]``) is
    appended as the last tuple field / under ``mask_key`` for dict samples.
    It composes with the jit layer: downstream masked losses make the
    zero-padding mathematically inert, which is exactly the contract
    the fused step's bucket padding assumes.

    ``as_tensor=False`` keeps the output numpy.
    """

    def __init__(self, boundaries, pad_value=0, with_mask=True,
                 mask_dtype="float32", mask_key="mask", length_fn=None,
                 pad_fields=None, as_tensor=True):
        self.boundaries = tuple(sorted(int(b) for b in boundaries))
        self.pad_value = pad_value
        self.with_mask = with_mask
        self.mask_dtype = mask_dtype
        self.mask_key = mask_key
        self.length_fn = length_fn or _sample_length
        self.pad_fields = pad_fields
        self.as_tensor = as_tensor

    def _bucket(self, max_len):
        i = bisect.bisect_left(self.boundaries, max_len)
        return self.boundaries[i] if i < len(self.boundaries) else max_len

    def _pad_stack(self, arrays, target):
        out = np.full((len(arrays), target) + tuple(arrays[0].shape[1:]),
                      self.pad_value, dtype=arrays[0].dtype)
        for j, a in enumerate(arrays):
            out[j, :a.shape[0]] = a
        return out

    def _finish(self, arr):
        return torch.from_numpy(arr) if self.as_tensor else arr

    def __call__(self, samples):
        samples = [self._to_numpy_tree(s) for s in samples]
        lengths = [self.length_fn(s) for s in samples]
        if any(n is None for n in lengths):
            raise ValueError("PadToBucket could not infer sample lengths; "
                             "pass length_fn=")
        target = self._bucket(max(lengths))
        mask = None
        if self.with_mask:
            mask = np.zeros((len(samples), target), dtype=self.mask_dtype)
            for j, n in enumerate(lengths):
                mask[j, :min(n, target)] = 1

        first = samples[0]
        if isinstance(first, dict):
            out = {k: self._collate_field(
                       [s[k] for s in samples], lengths,
                       target, pad=self._should_pad(k, first[k], lengths))
                   for k in first}
            if mask is not None:
                out[self.mask_key] = self._finish(mask)
            return out
        if isinstance(first, (list, tuple)):
            fields = list(zip(*samples))
            out = [self._collate_field(
                       list(f), lengths, target,
                       pad=self._should_pad(i, first[i], lengths))
                   for i, f in enumerate(fields)]
            if mask is not None:
                out.append(self._finish(mask))
            return out
        out = self._collate_field(samples, lengths, target, pad=True)
        if mask is not None:
            return [out, self._finish(mask)]
        return out

    # -- helpers --------------------------------------------------------
    def _to_numpy_tree(self, s):
        if isinstance(s, torch.Tensor):
            return s.detach().cpu().numpy()
        if isinstance(s, (list, tuple)):
            return type(s)(self._to_numpy_tree(v) for v in s)
        if isinstance(s, dict):
            return {k: self._to_numpy_tree(v) for k, v in s.items()}
        return s

    def _should_pad(self, field_id, field_value, lengths):
        if self.pad_fields is not None:
            return field_id in self.pad_fields
        if not isinstance(field_value, np.ndarray) or field_value.ndim == 0:
            return False
        # auto: a field is length-like when its leading dim tracks the
        # sample length (checked on the first sample)
        return int(field_value.shape[0]) == lengths[0]

    def _collate_field(self, arrays, lengths, target, pad):
        if isinstance(arrays[0], np.ndarray):
            if pad and arrays[0].ndim >= 1:
                return self._finish(self._pad_stack(arrays, target))
            return self._finish(np.stack(arrays))
        if isinstance(arrays[0], (int, float, np.number)):
            return self._finish(np.asarray(arrays))
        if isinstance(arrays[0], str):
            return list(arrays)
        return list(arrays)
