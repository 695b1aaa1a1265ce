"""Checkpoints of the PyTorch port, on the CPU: ``framework.io.save`` /
``load``, the commit protocol of ``distributed.checkpoint``, the
``CheckpointManager`` lifecycle, the retry and fault-injection layer, the
heartbeat files, and checkpoints crossing between the port and the JAX
package both ways.

The invariants are the reference's (``tests/test_fault_tolerance.py``,
``tests/test_supervision.py``, ``tests/test_sentinel.py``'s health
tagging, ``tests/test_sparse_embedding.py::test_checkpoint_roundtrip_auto_
resume``), each driven through the port's own fault sites. Across the
packages: a checkpoint of fp32 ``llama_tiny`` with its ``FusedTrainStep``
state and its sampler's cursor, written by one package and resumed by the
other, restores parameters and moments within 1e-6 (fp32 copies: in fact
exactly) and the same cursor, and two more steps on both sides agree at
the tolerances of ``tests/test_torch_training.py`` (losses rtol 1e-5,
parameters and moments atol 1e-5).
"""

import json
import os
import pickle
import shutil
import struct
import zipfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu.models import llama as jax_llama
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import checkpoint as dist
from paddle_tpu_torch.distributed.checkpoint import (COMMIT_FILE,
                                                     is_committed,
                                                     verify_checkpoint)
from paddle_tpu_torch.distributed.launch import heartbeat as hb
from paddle_tpu_torch.distributed.ps import SparseEmbedding
from paddle_tpu_torch.framework.io import CheckpointCorruptionError
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.utils import fault_injection as fi
from paddle_tpu_torch.utils.retry import replace_across_fs, retry_os

EXACT_ATOL = 1e-6
LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5
# llama_tiny's AdamW step size (epsilon 1e-6): Adam scales an update's
# sensitivity to a gradient near zero by lr / epsilon, and at 1e-3 the
# two frameworks' rounding alone ends two steps from the same restored
# state nearly STATE_ATOL apart; at 1e-4 ten times less
LR = 1e-4


@pytest.fixture(autouse=True)
def _fast_retries():
    """Negligible backoff sleeps; flags back to their defaults after."""
    pt.set_flags({"FLAGS_ckpt_save_retries": 2})
    yield
    pt.set_flags({"FLAGS_ckpt_save_retries": 3,
                  "FLAGS_ckpt_quarantine_keep": -1})


def _flip_shard_byte(npz_path):
    """Flip the last payload byte of the first npz member (array data)."""
    with zipfile.ZipFile(npz_path) as z:
        info = z.infolist()[0]
    blob = bytearray(open(npz_path, "rb").read())
    hdr = info.header_offset
    nlen, elen = struct.unpack("<HH", blob[hdr + 26:hdr + 30])
    blob[hdr + 30 + nlen + elen + info.compress_size - 1] ^= 0xFF
    open(npz_path, "wb").write(bytes(blob))


def _linear(seed=0, din=6, dout=3):
    torch.manual_seed(seed)
    return tnn.Linear(din, dout, device="cpu")


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# -- framework.io save / load ------------------------------------------------

class TestAtomicSave:
    def test_killed_save_preserves_previous_file(self, tmp_path):
        p = str(tmp_path / "m.pdparams")
        pt.save({"w": 1}, p)
        with fi.inject("io.save"):
            with pytest.raises(OSError):
                pt.save({"w": 2}, p)
        assert pt.load(p)["w"] == 1
        assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]

    def test_transient_oserror_is_retried(self, tmp_path):
        p = str(tmp_path / "m.pdparams")
        with fi.inject("io.save", max_fires=1, exc=OSError) as inj:
            pt.save({"w": 7}, p)
        assert inj.fires == 1 and inj.calls == 2
        assert pt.load(p)["w"] == 7

    def test_retry_budget_flag(self, tmp_path):
        pt.set_flags({"FLAGS_ckpt_save_retries": 0})
        with fi.inject("io.save", exc=OSError) as inj:
            with pytest.raises(OSError):
                pt.save({"w": 7}, str(tmp_path / "m.pdparams"))
        assert inj.calls == 1

    def test_missing_file_names_path(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="nope.pdparams"):
            pt.load(str(tmp_path / "nope.pdparams"))

    @pytest.mark.parametrize("damage", ["truncate", "garbage"])
    def test_damaged_file_raises_typed_error(self, tmp_path, damage):
        p = str(tmp_path / "m.pdparams")
        pt.save({"w": np.arange(1000)}, p)
        blob = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(blob[: len(blob) // 2] if damage == "truncate"
                    else b"not a pickle at all")
        with pytest.raises(CheckpointCorruptionError):
            pt.load(p)

    def test_tensors_travel_as_numpy_and_load_as_cpu_tensors(self,
                                                             tmp_path):
        p = str(tmp_path / "m.pdparams")
        w = torch.nn.Parameter(torch.randn(3, 2))
        b16 = torch.randn(4).to(torch.bfloat16)
        pt.save({"w": w, "b16": b16, "n": [1, "x"]}, p)
        with open(p, "rb") as f:
            raw = pickle.load(f)  # a plain pickle: numpy payloads
        assert isinstance(raw["w"].array, np.ndarray)
        got = pt.load(p)
        assert isinstance(got["w"], torch.nn.Parameter)
        assert torch.equal(got["w"], w) and got["w"].device.type == "cpu"
        assert got["b16"].dtype == torch.bfloat16
        assert torch.equal(got["b16"], b16) and got["n"] == [1, "x"]
        assert isinstance(pt.load(p, return_numpy=True)["w"], np.ndarray)

    def test_reads_the_jax_package_tensor_payloads(self, tmp_path):
        p = str(tmp_path / "j.pdparams")
        arr = np.arange(6, dtype=np.float32).reshape(2, 3)
        paddle.save({"t": paddle.to_tensor(arr), "k": 3}, p)
        got = pt.load(p)
        assert isinstance(got["t"], torch.Tensor)
        np.testing.assert_array_equal(got["t"].numpy(), arr)
        assert got["k"] == 3


# -- the commit protocol ------------------------------------------------------

class TestCommitProtocol:
    def test_commit_written_last_with_crc_fragments(self, tmp_path):
        dist.save_state_dict(_linear().state_dict(), str(tmp_path))
        assert is_committed(str(tmp_path))
        commit = json.load(open(tmp_path / COMMIT_FILE))
        assert commit == {"version": 3, "world_size": 1}
        frag = json.load(open(tmp_path / "rank0.meta.json"))
        for info in frag["state"].values():
            assert all("crc32" in sh for sh in info["shards"])

    def test_torn_resave_retracts_commit(self, tmp_path):
        lin = _linear()
        dist.save_state_dict(lin.state_dict(), str(tmp_path))
        with fi.inject("ckpt.shard_write"):
            with pytest.raises(OSError):
                dist.save_state_dict(lin.state_dict(), str(tmp_path))
        assert not is_committed(str(tmp_path))
        with pytest.raises(CheckpointCorruptionError, match="COMMIT"):
            dist.load_state_dict(lin.state_dict(), str(tmp_path))

    def test_corrupt_shard_byte_raises(self, tmp_path):
        lin = _linear()
        dist.save_state_dict(lin.state_dict(), str(tmp_path))
        _flip_shard_byte(str(tmp_path / "rank0.npz"))
        with pytest.raises(CheckpointCorruptionError):
            dist.load_state_dict(lin.state_dict(), str(tmp_path))
        with pytest.raises(CheckpointCorruptionError):
            verify_checkpoint(str(tmp_path))

    def test_missing_dir_raises_file_not_found(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="latest_valid_step"):
            dist.load_state_dict(_linear().state_dict(),
                                 str(tmp_path / "absent"))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_roundtrip_in_place_bit_exact(self, tmp_path, dtype):
        src = _linear(seed=3).to(dtype)
        want = _params(src)
        dist.save_state_dict(src.state_dict(), str(tmp_path))
        meta = verify_checkpoint(str(tmp_path))
        assert {v["dtype"] for v in meta["state"].values()} == {
            "float32" if dtype == torch.float32 else "bfloat16"}
        fresh = _linear(seed=9).to(dtype)
        ptrs = [p.data_ptr() for p in fresh.parameters()]
        dist.load_state_dict(fresh.state_dict(), str(tmp_path))
        assert [p.data_ptr() for p in fresh.parameters()] == ptrs
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, want[k]), k

    def test_async_save_snapshots_before_returning(self, tmp_path):
        lin = _linear(seed=4)
        want = _params(lin)
        handle = dist.save_state_dict(lin.state_dict(), str(tmp_path),
                                      async_save=True)
        with torch.no_grad():
            lin.weight.add_(1.0)  # the next step overwrites in place
        handle.wait()
        assert handle.done() and is_committed(str(tmp_path))
        dist.load_state_dict(lin.state_dict(), str(tmp_path))
        assert torch.equal(lin.weight, want["weight"])

    def test_process_group_is_not_ported(self, tmp_path):
        with pytest.raises(NotImplementedError, match="item 8"):
            dist.save_state_dict({}, str(tmp_path), process_group=object())

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_layout_crosses_between_the_packages(self, tmp_path, writer):
        """A ``Linear`` state, bf16 included, saved by one package's
        ``save_state_dict`` loads in the other's, bit for bit."""
        rng = np.random.RandomState(1)
        arrays = {"weight": rng.randn(6, 3).astype(np.float32),
                  "bias": rng.randn(3).astype(np.float32)}
        jlin = paddle.nn.Linear(6, 3)
        jlin.set_state_dict({k: paddle.to_tensor(v)
                             for k, v in arrays.items()})
        tlin = _linear()
        load_paddle_tpu_state_dict(tlin, arrays)
        from paddle_tpu.distributed import checkpoint as jdist

        if writer == "jax":
            jdist.save_state_dict(jlin.state_dict(), str(tmp_path))
            fresh = _linear(seed=8)
            dist.load_state_dict(fresh.state_dict(), str(tmp_path))
            for k, v in arrays.items():
                np.testing.assert_array_equal(
                    fresh.state_dict()[k].numpy(), v)
        else:
            dist.save_state_dict(tlin.state_dict(), str(tmp_path))
            jdist.verify_checkpoint(str(tmp_path))
            fresh = paddle.nn.Linear(6, 3)
            jdist.load_state_dict(fresh.state_dict(), str(tmp_path))
            for k, v in arrays.items():
                np.testing.assert_array_equal(
                    np.asarray(fresh.state_dict()[k].numpy()), v)


# -- CheckpointManager ---------------------------------------------------------

def _training_stack(seed=0):
    lin = _linear(seed, 5, 2)
    opt = optimizer.Adam(parameters=lin.parameters(), learning_rate=1e-2)
    scaler = pt.amp.GradScaler(init_loss_scaling=1024.0)
    return lin, opt, scaler


def _train(model, opt, n, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        loss = (model(torch.from_numpy(
            rng.randn(4, 5).astype("float32"))) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


class TestCheckpointManager:
    def test_latest_valid_skips_torn_save_and_resumes_bit_exact(
            self, tmp_path):
        model, opt, scaler = _training_stack()
        _train(model, opt, 2)
        scaler._scale, scaler._good_steps = 512.0, 7
        mgr = pt.CheckpointManager(str(tmp_path), keep_last_n=3)
        mgr.save(10, model=model, optimizer=opt, scaler=scaler)
        snap = _params(model)
        snap_opt = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in opt.state_dict().items()}
        _train(model, opt, 2, seed=1)
        with fi.inject("ckpt.shard_write"):
            with pytest.raises(OSError):
                mgr.save(20, model=model, optimizer=opt, scaler=scaler)
        assert mgr.latest_valid_step() == 10
        assert 20 in mgr.steps() and not is_committed(mgr.step_dir(20))
        _train(model, opt, 1, seed=2)
        scaler._scale, scaler._good_steps = 2.0, 0
        assert mgr.auto_resume(model=model, optimizer=opt,
                               scaler=scaler) == 10
        for k, v in model.state_dict().items():
            assert torch.equal(v, snap[k]), k
        got = opt.state_dict()
        for k, v in snap_opt.items():
            assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor)
                    else got[k] == v), k
        assert scaler._scale == 512.0 and scaler._good_steps == 7

    def test_auto_resume_cold_start_returns_none(self, tmp_path):
        model, opt, scaler = _training_stack()
        before = _params(model)
        assert pt.CheckpointManager(str(tmp_path)).auto_resume(
            model=model, optimizer=opt, scaler=scaler) is None
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k])

    def test_retention_keeps_last_n_and_sweeps_torn(self, tmp_path):
        model = _training_stack()[0]
        mgr = pt.CheckpointManager(str(tmp_path), keep_last_n=2)
        for s in (1, 2, 3):
            mgr.save(s, model=model)
        with fi.inject("ckpt.shard_write"):
            with pytest.raises(OSError):
                mgr.save(4, model=model)
        mgr.save(5, model=model)
        assert mgr.steps() == [3, 5] and mgr.latest_valid_step() == 5
        with pytest.raises(ValueError):
            pt.CheckpointManager(str(tmp_path), keep_last_n=0)

    def test_resave_quarantines_and_a_restart_recovers_it(self, tmp_path):
        model = _training_stack()[0]
        mgr = pt.CheckpointManager(str(tmp_path), keep_last_n=1)
        mgr.save(1, model=model)
        with fi.inject("ckpt.shard_write"):
            with pytest.raises(OSError):
                mgr.save(1, model=model)
        quarantined = [e for e in os.listdir(tmp_path) if ".replaced." in e]
        assert len(quarantined) == 1
        assert is_committed(str(tmp_path / quarantined[0]))
        mgr2 = pt.CheckpointManager(str(tmp_path), keep_last_n=1)
        assert mgr2.latest_valid_step() == 1
        assert not [e for e in os.listdir(tmp_path) if ".replaced." in e]

    def test_async_save_defers_retention_until_landed(self, tmp_path):
        model, opt, _ = _training_stack()
        mgr = pt.CheckpointManager(str(tmp_path), keep_last_n=1,
                                   async_save=True)
        mgr.save(1, model=model, optimizer=opt)
        mgr.wait()
        handle = mgr.save(2, model=model, optimizer=opt)
        assert handle is not None
        mgr.wait()
        assert mgr.committed_steps() == [2]
        assert os.path.exists(os.path.join(mgr.step_dir(2),
                                           "optimizer.pdopt"))

    def test_latest_valid_verify_walks_past_corruption(self, tmp_path):
        model = _training_stack()[0]
        mgr = pt.CheckpointManager(str(tmp_path))
        mgr.save(1, model=model)
        mgr.save(2, model=model)
        _flip_shard_byte(os.path.join(mgr.step_dir(2), "rank0.npz"))
        assert mgr.latest_valid_step() == 2
        assert mgr.latest_valid_step(verify=True) == 1

    def test_fused_step_composes_with_auto_resume(self, tmp_path):
        """Restored in place: the step's parameters and moments keep
        their storage, and a fresh stack resumes bit for bit."""
        def stack():
            model = _linear(7, 4, 1)
            step = incubate.fused_train_step(
                model, optimizer.Adam(parameters=model.parameters(),
                                      learning_rate=1e-2),
                loss_fn=lambda o: (o ** 2).mean())
            return model, step

        x = torch.from_numpy(np.random.RandomState(0).randn(
            8, 4).astype("float32"))
        model, step = stack()
        for _ in range(3):
            step(x)
        mgr = pt.CheckpointManager(str(tmp_path))
        mgr.save(3, model=model, optimizer=step)
        step(x)
        w4 = model.weight.detach().clone()
        ptrs = step._ptrs()
        assert mgr.auto_resume(model=model, optimizer=step) == 3
        assert step._ptrs() == ptrs
        step(x)
        assert torch.equal(model.weight, w4)
        model2, step2 = stack()
        assert mgr.auto_resume(model=model2, optimizer=step2) == 3
        step2(x)
        assert torch.equal(model2.weight, w4)

    def test_lazy_row_moments_resume_bit_exact(self, tmp_path):
        """The row-sparse route's full-table moments survive a checkpoint:
        a fresh stack resumed mid-training replays the losses, tables and
        moments bit for bit."""
        class Mini(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.emb = SparseEmbedding(97, 5, device="cpu")
                self.lin = tnn.Linear(5, 1, device="cpu")

            def forward(self, ids, label):
                out = self.lin(self.emb(ids)).squeeze(-1).sum(-1,
                                                              keepdim=True)
                return ((out - label) ** 2).mean()

        def build(seed):
            torch.manual_seed(seed)
            m = Mini()
            step = incubate.fused_train_step(m, optimizer.Adam(
                learning_rate=0.05, parameters=m.parameters(),
                lazy_mode=True))
            return m, step

        rng = np.random.RandomState(0)
        batches = [(torch.from_numpy(rng.randint(0, 97, (2, 6))),
                    torch.from_numpy(rng.randn(2, 1).astype("float32")))
                   for _ in range(4)]
        ml, sl = build(21)
        for b in batches[:2]:
            sl(*b)
        mgr = pt.CheckpointManager(str(tmp_path))
        mgr.save(2, model=ml, optimizer=sl)
        cont = [float(sl(*b)) for b in batches[2:]]
        m2, s2 = build(999)
        assert s2._sparse_names == ("emb.weight",)
        assert mgr.auto_resume(model=m2, optimizer=s2) == 2
        assert [float(s2(*b)) for b in batches[2:]] == cont
        for (n, a), (_, b) in zip(ml.named_parameters(),
                                  m2.named_parameters()):
            assert torch.equal(a, b), n
        for k, v in sl.state_dict().items():
            if k.startswith(("m1.", "m2.")):
                np.testing.assert_array_equal(s2.state_dict()[k], v, k)

    def test_plan_is_not_ported(self, tmp_path):
        # plan= is ported (tests/test_torch_plan.py); what stays out is a
        # model holding plan-sharded blocks: per-rank shards and their
        # commit barrier are ROADMAP item 8
        mgr = pt.CheckpointManager(str(tmp_path))
        m = _linear()
        m._plan_shards = {"weight": (tuple(m.weight.shape),
                                     (slice(None), slice(None)))}
        with pytest.raises(NotImplementedError, match="item 8"):
            mgr.save(1, model=m)
        assert mgr.committed_steps() == []


class TestHealthTagging:
    def _mgr(self, tmp_path, **kw):
        return _linear(1, 3, 1), pt.CheckpointManager(str(tmp_path / "ck"),
                                                      **kw)

    def test_k_clean_windows_promote_and_a_bad_one_resets(self, tmp_path):
        m, mgr = self._mgr(tmp_path)
        mgr.save(10, model=m)
        assert mgr.latest_healthy_step() is None
        assert mgr.note_window(clean=True, k=2) == []   # registers 10@0
        assert mgr.note_window(clean=True, k=2) == []   # 10@1
        mgr.note_window(clean=False, k=2)               # reset to 0
        assert mgr.note_window(clean=True, k=2) == []
        assert mgr.note_window(clean=True, k=2) == [10]
        assert mgr.latest_healthy_step() == 10 and mgr.is_healthy(10)

    def test_step_saved_at_this_boundary_needs_k_more(self, tmp_path):
        m, mgr = self._mgr(tmp_path)
        mgr.save(5, model=m)
        mgr.note_window(clean=True, k=1)
        mgr.save(9, model=m)
        assert mgr.note_window(clean=True, k=1) == [5]
        assert mgr.note_window(clean=True, k=1) == [9]

    def test_retention_never_deletes_newest_healthy(self, tmp_path):
        m, mgr = self._mgr(tmp_path, keep_last_n=1)
        mgr.save(10, model=m)
        mgr.note_window(clean=True, k=1)
        mgr.note_window(clean=True, k=1)
        mgr.save(20, model=m)
        mgr.save(30, model=m)
        assert 10 in mgr.committed_steps()
        assert mgr.latest_healthy_step() == 10

    def test_auto_resume_pinned_step_and_drop_after(self, tmp_path):
        m, mgr = self._mgr(tmp_path)
        w0 = m.weight.detach().clone()
        mgr.save(10, model=m)
        with torch.no_grad():
            m.weight.mul_(3.0)
        mgr.save(20, model=m)
        mgr.save(30, model=m)
        assert mgr.auto_resume(model=m, step=10) == 10
        assert torch.equal(m.weight, w0)
        with pytest.raises(ValueError, match="no committed checkpoint"):
            mgr.auto_resume(model=m, step=15)
        assert mgr.drop_steps_after(10) == [20, 30]
        assert mgr.committed_steps() == [10]

    def test_quarantine_sweep_flag(self, tmp_path):
        m, mgr = self._mgr(tmp_path)
        mgr.save(10, model=m)
        d = mgr.step_dir(10)
        for i, age in ((1, 100), (2, 50), (3, 10)):
            q = os.path.join(mgr.root, f"step_10.replaced.{i}")
            shutil.copytree(d, q)
            t = 1_700_000_000 - age
            os.utime(q, (t, t))
        os.remove(os.path.join(d, "COMMIT"))
        mgr._retain()
        assert len([e for e in os.listdir(mgr.root)
                    if ".replaced." in e]) == 3
        pt.set_flags({"FLAGS_ckpt_quarantine_keep": 1})
        mgr._retain()
        assert sorted(e for e in os.listdir(mgr.root)
                      if ".replaced." in e) == ["step_10.replaced.3"]
        assert mgr.latest_valid_step() == 10


# -- retry, fault injection, heartbeats ---------------------------------------

class TestRetryAndInjection:
    def test_exdev_is_never_retried(self):
        calls = []

        def fn():
            calls.append(1)
            raise OSError(18, "Invalid cross-device link")

        with pytest.raises(OSError):
            retry_os(fn, retries=5)
        assert len(calls) == 1

    def test_replace_across_fs_falls_back_to_copy(self, tmp_path,
                                                  monkeypatch):
        src, dst = tmp_path / "a", tmp_path / "b"
        src.write_bytes(b"payload")
        real = os.replace

        def replace(a, b):
            if str(a) == str(src):
                raise OSError(18, "Invalid cross-device link")
            return real(a, b)

        monkeypatch.setattr(os, "replace", replace)
        replace_across_fs(str(src), str(dst))
        assert dst.read_bytes() == b"payload" and not src.exists()

    def test_injector_semantics(self):
        assert not fi.should_fire("train.spike")  # unarmed: free
        with pytest.raises(ValueError, match="unknown fault site"):
            with fi.inject("nope"):
                pass
        with fi.inject("train.grad_nan", every_n=3) as inj:
            hits = [fi.should_fire("train.grad_nan") for _ in range(6)]
        assert hits == [False, False, True] * 2 and inj.fires == 2
        with fi.inject("io.save", max_fires=1) as outer:
            with fi.inject("io.save", every_n=2):
                assert not fi.should_fire("io.save")
            assert fi.should_fire("io.save") and outer.fires == 1

    def test_same_site_registry_as_the_reference(self):
        from paddle_tpu.utils import fault_injection as jfi

        assert fi.SITES == jfi.SITES


class TestHeartbeat:
    def test_write_read_and_staleness(self, tmp_path, monkeypatch):
        monkeypatch.setenv(hb.HEARTBEAT_DIR_ENV, str(tmp_path))
        monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
        assert hb.write(step=12)
        beats = hb.read_all(str(tmp_path))
        assert beats["3"]["step"] == 12 and beats["3"]["pid"] == os.getpid()
        now = beats["3"]["time"]
        assert not hb.stale(str(tmp_path), 5.0, now=now + 1)
        assert hb.stale(str(tmp_path), 5.0, now=now + 10)
        assert not hb.stale(str(tmp_path), 0, now=now + 1e6)

    def test_unsupervised_and_failed_writes_never_raise(self, tmp_path,
                                                        monkeypatch):
        monkeypatch.delenv(hb.HEARTBEAT_DIR_ENV, raising=False)
        assert hb.write(step=1) is False
        with fi.inject("hb.write"):
            assert hb.write(step=1, dir=str(tmp_path)) is False
        assert hb.read_all(str(tmp_path)) == {}

    def test_trap_preemption_records_and_restores(self):
        import signal

        prev = signal.getsignal(signal.SIGTERM)
        with hb.trap_preemption() as state:
            signal.raise_signal(signal.SIGTERM)
            assert state.triggered and state.signum == signal.SIGTERM
        assert signal.getsignal(signal.SIGTERM) is prev
        assert hb.PREEMPT_EXIT_CODE == 123


# -- checkpoints across the packages ------------------------------------------

N, S = 16, 16


def _data():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 512, (N, S)).astype(np.int64),
            rng.randint(0, 512, (N, S)).astype(np.int64))


def _loader(io):
    ds = io.TensorDataset(list(_data()))
    sampler = io.BucketedBatchSampler(ds, batch_size=2, boundaries=[S],
                                      lengths=[S] * N, shuffle=True, seed=0)
    return io.DataLoader(ds, batch_sampler=sampler)


def _jax_stack(seed):
    paddle.seed(seed)
    model = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    step = paddle.incubate.fused_train_step(model, paddle.optimizer.AdamW(
        learning_rate=LR, epsilon=1e-6, parameters=model.parameters()))
    return model, step, _loader(jio)


def _port_stack(seed):
    paddle.seed(seed)
    state = {k: np.asarray(v.numpy()) for k, v in jax_llama.LlamaForCausalLM(
        jax_llama.llama_tiny()).state_dict().items()}
    model = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(),
                                         device="cpu")
    load_paddle_tpu_state_dict(model, state)
    step = incubate.fused_train_step(model, optimizer.AdamW(
        learning_rate=LR, epsilon=1e-6, parameters=model.parameters()))
    return model, step, _loader(tio)


def _state(model, step):
    params = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v,
                            np.float32)
              for k, v in model.state_dict().items()}
    moments = {k: np.asarray(v) for k, v in step.state_dict().items()
               if k.startswith(("m1.", "m2."))}
    return params, moments


def _close(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fused_llama_checkpoint_resumes_across_packages(tmp_path, writer):
    """Two steps on the writer's side through ``drive`` with its manager
    (the sampler advanced per trained batch), a checkpoint; the other
    package's fresh stack (other weights) resumes it: the same step count,
    cursor, parameters and moments; then two more steps on both sides."""
    with jax.default_matmul_precision("highest"):
        stacks = {"jax": _jax_stack, "port": _port_stack}
        reader = "port" if writer == "jax" else "jax"
        wm, ws, wl = stacks[writer](3)
        mgrs = {"jax": paddle.CheckpointManager, "port": pt.CheckpointManager}
        mgr = mgrs[writer](str(tmp_path))
        kw = {"prefetch": False} if writer == "jax" else {}
        ws.drive(wl, steps=2, log_every=2, checkpoint=mgr, **kw)
        mgr.save(2, model=wm, optimizer=ws, sampler=wl)
        want = _state(wm, ws)
        rm, rs, rl = stacks[reader](11)
        assert mgrs[reader](str(tmp_path)).auto_resume(
            model=rm, optimizer=rs, sampler=rl) == 2
        assert rl.state_dict()["cursor"] == wl.state_dict()["cursor"] == 2
        assert rs.state_dict()["step_count"] == 2
        got = _state(rm, rs)
        _close(got[0], want[0], EXACT_ATOL)
        _close(got[1], want[1], EXACT_ATOL)
        losses = {}
        for name, (m, s, ld) in ((writer, (wm, ws, wl)),
                                 (reader, (rm, rs, rl))):
            kw = {"prefetch": False} if name == "jax" else {}
            losses[name] = s.drive(ld, steps=2, log_every=2, sampler=ld,
                                   **kw)["loss"]
        np.testing.assert_allclose(losses["port"], losses["jax"],
                                   rtol=LOSS_RTOL)
        after = {"jax": _state(*((wm, ws) if writer == "jax" else (rm, rs))),
                 "port": _state(*((wm, ws) if writer == "port"
                                  else (rm, rs)))}
        _close(after["port"][0], after["jax"][0], STATE_ATOL)
        _close(after["port"][1], after["jax"][1], STATE_ATOL)
