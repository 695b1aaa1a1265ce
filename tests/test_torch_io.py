"""The port's data pipeline, on the CPU: datasets, samplers, the data
loader, the resumable ``BucketedBatchSampler``, ``PadToBucket`` and the
``DevicePrefetcher``.

Against the JAX package: the same seed gives the same batches from both
packages' samplers (``RandomSampler`` under the same numpy global seed,
``DistributedBatchSampler``, ``BucketedBatchSampler`` seeded and resumed
mid-epoch, across an epoch edge) and the same padded arrays from
``PadToBucket`` (exact: index lists and integer or copied float data).
Within the port the invariants are the reference's
(``tests/test_supervision.py``'s sampler state and prefetcher close,
``tests/test_sentinel.py``'s epoch-edge advance and prefetcher reset,
``tests/test_overlap.py``'s ``TestDevicePrefetcher`` and
``TestBucketIntegration``). On the CPU the prefetcher stages CPU tensors
on its thread, with no stream; the card's staging stream and events run
in ``chip_smoke.py``.
"""

import gc
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as io
from paddle_tpu_torch import incubate, jit, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.utils import fault_injection as fi

BOUNDS = [8, 16, 32]


@pytest.fixture(autouse=True)
def _clean():
    yield
    pt.set_flags({"FLAGS_prefetch_depth": 2})
    jit.set_shape_buckets(None)
    jit.reset_cache_stats()


class _VarLen:
    """Variable-length [L, 2] float samples (the reference's ``_VarLen``)."""

    def __init__(self, n=24, seed=0):
        rng = np.random.RandomState(seed)
        self.lens = rng.randint(3, 25, size=n)
        self.data = [rng.randn(int(n_), 2).astype("float32")
                     for n_ in self.lens]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


def _sampler(pkg=io, **kw):
    ds = _VarLen()
    kw.setdefault("batch_size", 2)
    kw.setdefault("boundaries", BOUNDS)
    kw.setdefault("lengths", ds.lens.tolist())
    return pkg.BucketedBatchSampler(ds, **kw)


def _batches(sampler):
    return [tuple(b) for b in sampler]


# -- the same batches as the reference -----------------------------------------

@pytest.mark.parametrize("shuffle,seed,drop_last", [
    (False, 0, False), (True, 0, False), (True, 5, True)])
def test_bucketed_sampler_matches_reference(shuffle, seed, drop_last):
    """Two epochs, then a resume mid-epoch from a state dict, then a
    multi-epoch ``advance``: the same batches in both packages."""
    def make(pkg):
        return _sampler(pkg, shuffle=shuffle, seed=seed, drop_last=drop_last)

    got, want = make(io), make(jio)
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert _batches(got) == _batches(want)
    for s in (got, want):
        s.advance(3)
    assert got.state_dict() == want.state_dict()
    fresh = make(io)
    fresh.set_state_dict(want.state_dict())
    assert _batches(fresh) == _batches(want)
    for s in (got, want):
        s.advance(2 * len(s) + 1)
    assert got.state_dict() == want.state_dict()
    assert _batches(got) == _batches(want)


@pytest.mark.parametrize("kind", ["sequence", "random", "batch_shuffle",
                                  "distributed"])
def test_samplers_match_reference(kind):
    ds = list(range(23))

    def make(pkg):
        if kind == "sequence":
            return pkg.BatchSampler(ds, batch_size=4)
        if kind == "random":
            return pkg.RandomSampler(ds)
        if kind == "batch_shuffle":
            return pkg.BatchSampler(ds, shuffle=True, batch_size=5,
                                    drop_last=True)
        s = pkg.DistributedBatchSampler(ds, batch_size=3, num_replicas=2,
                                        rank=1, shuffle=True)
        s.set_epoch(4)
        return s

    out = []
    for pkg in (jio, io):
        np.random.seed(17)  # RandomSampler draws from numpy's global state
        s = make(pkg)
        out.append((list(s), len(s)))
    assert out[0] == out[1]


def test_pad_to_bucket_matches_reference():
    ds = _VarLen()
    samples = [(ds[i], np.float32(i), np.int64(i)) for i in (0, 1, 5)]
    got = io.PadToBucket(BOUNDS)(samples)
    want = jio.PadToBucket(BOUNDS, as_tensor=False)(samples)
    assert all(isinstance(t, torch.Tensor) for t in got)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[1] in BOUNDS


def test_dataloader_collates_cpu_tensors_and_refuses_workers():
    ids = np.arange(40, dtype=np.int64).reshape(10, 4)
    w = np.linspace(0, 1, 10).astype(np.float32)
    loader = io.DataLoader(io.TensorDataset([ids, w]), batch_size=4)
    batches = list(loader)
    assert len(loader) == len(batches) == 3
    assert batches[0][0].dtype == torch.int64
    assert batches[0][1].dtype == torch.float32
    assert batches[-1][0].shape == (2, 4)
    np.testing.assert_array_equal(batches[1][0].numpy(), ids[4:8])
    sub = io.Subset(io.TensorDataset([ids]), [3, 1])
    assert len(sub) == 2 and sub[0][0].tolist() == ids[3].tolist()
    with pytest.raises(NotImplementedError, match="item 10"):
        io.DataLoader(loader.dataset, num_workers=1)
    with pytest.raises(NotImplementedError, match="item 10"):
        io.DataLoader(loader.dataset, use_process_workers=True)


# -- the resumable sampler ------------------------------------------------------

class TestSamplerState:
    def test_state_dict_roundtrip_mid_epoch(self):
        s = _sampler(shuffle=True, seed=5)
        s.set_epoch(1)
        full = list(s)
        s.advance(4)
        s2 = _sampler(shuffle=True)
        s2.set_state_dict(s.state_dict())
        assert list(s2) == full[4:]

    def test_unseeded_sampler_is_still_replayable(self):
        s = _sampler(shuffle=True, seed=None)
        full = list(s)
        s.advance(3)
        s2 = _sampler(shuffle=True, seed=None)
        s2.set_state_dict(s.state_dict())
        assert list(s2) == full[3:]

    def test_set_epoch_resets_cursor_only_on_change(self):
        s = _sampler(shuffle=True, seed=1)
        s.advance(5)
        s.set_epoch(0)
        assert s.state_dict()["cursor"] == 5
        s.set_epoch(1)
        assert s.state_dict()["cursor"] == 0

    def test_fully_consumed_epoch_rolls_over(self):
        s = _sampler(shuffle=True, seed=4)
        n = len(list(s))
        s.advance(n)
        assert (s.state_dict()["epoch"], s.state_dict()["cursor"]) == (1, 0)
        assert len(list(s)) == n

    @pytest.mark.parametrize("key,other", [("batch_size", {"batch_size": 3}),
                                           ("shuffle", {"shuffle": False})])
    def test_fingerprint_mismatch_raises(self, key, other):
        sd = _sampler(shuffle=True, seed=1).state_dict()
        with pytest.raises(ValueError, match=key):
            _sampler(**{"shuffle": True, **other}).set_state_dict(sd)

    def test_dataloader_delegates_stream_state(self):
        s = _sampler(shuffle=True, seed=3)
        loader = io.DataLoader(_VarLen(), batch_sampler=s,
                               collate_fn=io.PadToBucket(BOUNDS))
        loader.advance(2)
        assert loader.state_dict()["cursor"] == 2
        loader.set_epoch(4)
        assert loader.state_dict()["epoch"] == 4
        assert io.resolve_resumable(loader) is s
        assert io.resolve_resumable(io.DevicePrefetcher(
            loader, device="cpu")) is s
        plain = io.DataLoader(_VarLen(), batch_size=2)
        with pytest.raises(TypeError, match="not resumable"):
            plain.state_dict()
        assert io.resolve_resumable(plain) is None

    def test_checkpoint_manager_persists_and_restores_sampler(self,
                                                              tmp_path):
        s = _sampler(shuffle=True, seed=7)
        loader = io.DataLoader(_VarLen(), batch_sampler=s,
                               collate_fn=io.PadToBucket(BOUNDS))
        full = list(s)
        loader.advance(3)
        mgr = pt.CheckpointManager(str(tmp_path))
        mgr.save(3, sampler=loader)
        s2 = _sampler(shuffle=True)
        loader2 = io.DataLoader(_VarLen(), batch_sampler=s2,
                                collate_fn=io.PadToBucket(BOUNDS))
        assert pt.CheckpointManager(str(tmp_path)).auto_resume(
            sampler=loader2) == 3
        assert list(s2) == full[3:]

    def test_prefetcher_resume_never_double_consumes(self):
        s = _sampler(shuffle=True, seed=9)
        loader = io.DataLoader(_VarLen(), batch_sampler=s,
                               collate_fn=io.PadToBucket(BOUNDS))
        expected = list(s)
        pf = io.DevicePrefetcher(loader, depth=2, device="cpu")
        for consumed, _ in enumerate(pf, 1):
            s.advance(1)
            if consumed == 2:
                break
        pf.close()
        sd = s.state_dict()
        assert sd["cursor"] == 2
        s2 = _sampler(shuffle=True)
        s2.set_state_dict(sd)
        assert list(s2) == expected[2:]


class TestEpochEdgeAdvance:
    def _sampler(self, seed=4, n=23, bs=4):
        lengths = list(np.random.RandomState(0).randint(3, 30, size=n))
        return io.BucketedBatchSampler(
            dataset=None, batch_size=bs, boundaries=BOUNDS, lengths=lengths,
            shuffle=True, seed=seed)

    def test_advance_carries_remainder_across_epochs(self):
        s = self._sampler(seed=4)
        n = len(s)
        s.advance(n + 2)
        assert s.state_dict()["epoch"] == 1
        assert s.state_dict()["cursor"] == 2
        assert s.state_dict()["epoch_seed"] == 5
        s.advance(2 * n)
        assert (s.state_dict()["epoch"], s.state_dict()["cursor"]) == (3, 2)

    def test_rolled_stream_matches_stepwise_consumer(self):
        a, b = self._sampler(seed=9), self._sampler(seed=9)
        a.advance(len(a) + 3)
        for _ in range(len(b) + 3):
            b.advance(1)
        assert a.state_dict() == b.state_dict()
        assert _batches(a) == _batches(b)

    def test_iter_carries_restored_overshoot(self):
        s = self._sampler(seed=6)
        sd = s.state_dict()
        sd["cursor"] = len(s) + 2
        s2 = self._sampler(seed=6)
        s2.set_state_dict(sd)
        ref = self._sampler(seed=6)
        ref.advance(len(ref) + 2)
        assert _batches(s2) == _batches(ref)


# -- the device prefetcher (CPU staging) ----------------------------------------

def _threads(tag):
    return [t for t in threading.enumerate() if t.is_alive() and tag in t.name]


class TestDevicePrefetcher:
    def test_delivers_all_batches_in_order_as_tensors(self):
        batches = [(np.full((2, 3), i, np.float32),) for i in range(9)]
        out = list(io.DevicePrefetcher(batches, depth=3, device="cpu"))
        assert len(out) == 9
        for i, (t,) in enumerate(out):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), batches[i][0])

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default resolves")
        with pytest.raises(RuntimeError, match="cuda"):
            io.DevicePrefetcher([])

    def test_wraps_dataloader_and_is_reiterable(self):
        loader = io.DataLoader(io.TensorDataset(
            [np.arange(16, dtype=np.float32).reshape(8, 2)]), batch_size=4)
        pf = io.DevicePrefetcher(loader, device="cpu")
        assert len(pf) == 2
        for _ in range(2):
            assert len([b for b in pf]) == 2

    def test_stats_depth_flag_and_validation(self):
        pf = io.DevicePrefetcher([(np.zeros((8, 8), np.float32),)] * 6,
                                 depth=2, device="cpu")
        list(pf)
        s = pf.stats()
        assert s["prefetched"] == s["batches"] == 6 and not s["fallback"]
        row = jit.cache_stats(pf._stats_name)
        assert row["host_blocked_ms"] >= 0.0
        assert row["avg_queue_depth"] is not None
        assert io.DevicePrefetcher([], device="cpu").depth == 2
        pt.set_flags({"FLAGS_prefetch_depth": 4})
        assert io.DevicePrefetcher([], device="cpu").depth == 4
        with pytest.raises(ValueError):
            io.DevicePrefetcher([], depth=0, device="cpu")
        with pytest.raises(ValueError):
            pt.set_flags({"FLAGS_prefetch_depth": 0})

    def test_transfer_thread_death_falls_back_without_losing_batches(self):
        batches = [(np.full((2, 2), i, np.float32),) for i in range(8)]
        pf = io.DevicePrefetcher(batches, depth=2, device="cpu")
        with fi.inject("io.prefetch", max_fires=1):
            with pytest.warns(RuntimeWarning, match="falling back"):
                out = list(pf)
        assert [int(t[0, 0]) for (t,) in out] == list(range(8))
        assert pf.stats()["fallback"] and pf.stats()["sync_fallback"] >= 1

    def test_source_error_propagates(self):
        def gen():
            yield (np.zeros((2, 2), np.float32),)
            raise ValueError("loader broke")

        with pytest.raises(ValueError, match="loader broke"):
            list(io.DevicePrefetcher(gen(), device="cpu"))

    def test_close_leaves_no_threads_and_stays_reiterable(self):
        batches = [np.full((2, 3), i, np.float32) for i in range(16)]
        pf = io.DevicePrefetcher(batches, depth=2, name="leaktest",
                                 device="cpu")
        for i, _ in enumerate(pf):
            if i == 1:
                break
        pf.close()
        assert _threads("leaktest") == []
        with pf:
            it = iter(pf)
            next(it)
        assert _threads("leaktest") == []
        assert len(list(it)) <= 15  # an abandoned generator ends
        it = iter(pf)
        next(it)
        it.close()
        gc.collect()
        assert _threads("leaktest") == []
        assert len(list(pf)) == 16

    def test_reset_discards_read_ahead_and_restores_sampler(self):
        batches = [(np.full((2, 2), i, np.float32),) for i in range(8)]
        pf = io.DevicePrefetcher(batches, depth=2, device="cpu")
        it = iter(pf)
        assert [int(next(it)[0][0, 0]) for _ in range(3)] == [0, 1, 2]
        pf.reset()
        assert [int(t[0][0, 0]) for t in pf] == list(range(8))
        with pytest.raises(TypeError, match="resumable"):
            pf.reset(sampler_state={"epoch": 0, "cursor": 0})
        s = _sampler(seed=0)
        loader = io.DataLoader(_VarLen(), batch_sampler=s,
                               collate_fn=io.PadToBucket(BOUNDS))
        pf = io.DevicePrefetcher(loader, depth=2, device="cpu")
        snap = s.state_dict()
        for _i, _b in zip(range(3), pf):
            s.advance(1)
        pf.reset(sampler_state=snap)
        assert s.state_dict() == snap

    def test_pads_to_the_buckets_on_the_thread(self):
        rng = np.random.RandomState(0)
        batches = [(rng.randn(4, n, 4).astype("float32"),)
                   for n in (5, 9, 14)]
        jit.set_shape_buckets([8, 16], axis=1)
        pf = io.DevicePrefetcher(batches, device="cpu")
        out = list(pf)
        assert [t.shape[1] for (t,) in out] == [8, 16, 16]
        assert pf.stats()["bucket_pads"] == 3
        for (t,), (x,) in zip(out, batches):
            np.testing.assert_array_equal(t[:, :x.shape[1]].numpy(), x)
            assert not t[:, x.shape[1]:].any()


def _mlp_step(shape_buckets=None, in_dim=8):
    torch.manual_seed(11)
    model = torch.nn.Sequential(tnn.Linear(in_dim, 16, device="cpu"),
                                torch.nn.Tanh(),
                                tnn.Linear(16, 1, device="cpu"))
    step = incubate.fused_train_step(
        model, optimizer.Adam(parameters=model.parameters(),
                              learning_rate=1e-2),
        loss_fn=lambda o: (o ** 2).mean(), shape_buckets=shape_buckets)
    return model, step


class TestDriveWithPrefetch:
    def test_prefetch_zero_extra_compiles(self):
        """Prefetched batches arrive padded: the drive compiles as often as
        direct calls, and the padding happened on the transfer thread."""
        rng = np.random.RandomState(0)
        batches = [(torch.from_numpy(
            rng.randn(4, (5, 9, 14)[i % 3], 4).astype("float32")),)
            for i in range(9)]
        _, a = _mlp_step([8, 16], in_dim=4)
        for b in batches:
            a(*b)
        _, b_ = _mlp_step([8, 16], in_dim=4)
        hist = b_.drive(batches, log_every=3)
        sa, sb = (jit.cache_stats(s._stats_name) for s in (a, b_))
        assert sb["compiles"] == sa["compiles"] == 2
        assert set(sb["per_shape_misses"]) == set(sa["per_shape_misses"])
        assert hist["prefetch"]["bucket_pads"] > 0
        assert sb["bucket_pads"] == 0 < sa["bucket_pads"]

    def test_prefetch_on_and_off_bit_equal(self):
        rng = np.random.RandomState(1)
        batches = [(rng.randn(8, 8).astype("float32"),) for _ in range(7)]
        runs = []
        for prefetch in (True, False):
            model, step = _mlp_step()
            hist = step.drive(batches, log_every=3, prefetch=prefetch)
            runs.append((hist["loss"], [p.detach().clone()
                                        for p in model.parameters()]))
            assert (hist["prefetch"] is None) == (not prefetch)
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    def test_training_completes_through_prefetch_fault(self):
        _, step = _mlp_step()
        batches = [(np.random.RandomState(i).randn(8, 8).astype("float32"),)
                   for i in range(10)]
        with fi.inject("io.prefetch", max_fires=1):
            with pytest.warns(RuntimeWarning, match="falling back"):
                hist = step.drive(batches, log_every=4)
        assert hist["steps"] == 10 and all(np.isfinite(hist["loss"]))

    def test_one_shot_source_capped_at_steps(self):
        _, step = _mlp_step()
        src = iter([(np.full((8, 8), i, np.float32),) for i in range(10)])
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            hist = step.drive(src, steps=4, log_every=2)
        assert hist["steps"] == 4
        assert int(next(src)[0][0, 0]) == 4  # nothing read ahead was lost
