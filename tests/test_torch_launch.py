"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``,
``paddle_tpu_torch.distributed.spawn``) against the JAX package's, on the
CPU, and the two repairs of the ``distributed`` namespace.

- Parity: ``parse_args`` (defaults and a full command line) and the
  controller's worker environment equal the reference's for the same
  arguments (the device visibility variables aside: the port sets only
  ``CUDA_VISIBLE_DEVICES``); ``all_gather(..., axis=0)`` and the four
  checkpoint names resolve in both packages the same way.
- ``CollectiveController._watch`` and ``run`` over fake worker processes
  and aged heartbeat files: a crash, a partial preemption, a stale
  heartbeat, a budget-free preemption, a crash loop and the liveness log.
- Real processes whose workers are plain Python scripts (no torch in the
  launcher or the bootstrap): the reference's flaky script restarts once
  and succeeds, a failure's exit code propagates, a crash loop ends with
  its code, and ``--nnodes 2`` needs ``--master``.
- Slow tier (each worker imports torch): a 2-worker gloo ``all_reduce``
  job through the launcher, ``spawn(nprocs=2)`` and its failure, and the
  kill/preempt/hang drill on fp32 llama_tiny (``chip_smoke.py``'s phase 16
  at tiny size), each rank's losses bit for bit its uninterrupted run.
"""

import argparse
import importlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu.distributed as jdist
jmain = importlib.import_module("paddle_tpu.distributed.launch.main")
from paddle_tpu.distributed.launch.controllers import collective as jcoll
import paddle_tpu_torch
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed.launch import heartbeat as hb
tmain = importlib.import_module("paddle_tpu_torch.distributed.launch.main")
from paddle_tpu_torch.distributed.launch.controllers import collective as tcoll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's (tests/test_launch.py)
FLAKY_SCRIPT = """
import os, sys

flag = os.path.join({out!r}, "attempted")
if not os.path.exists(flag):
    open(flag, "w").write("x")
    sys.exit(3)
open(os.path.join({out!r}, "succeeded"), "w").write("x")
"""

# a worker that reports whether anything imported torch before it
TORCH_FREE_SCRIPT = """
import os, sys
rank = os.environ["PADDLE_TRAINER_ID"]
open(os.path.join({out!r}, "torch." + rank), "w").write(
    str("torch" in sys.modules))
sys.exit({code})
"""

COLLECTIVE_SCRIPT = """
import os, sys
import torch
import paddle_tpu_torch.distributed as dist

dist.init_parallel_env(device="cpu")
assert dist.get_world_size() == 2, dist.get_world_size()
rank = dist.get_rank()
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
got = []
dist.all_gather(got, torch.tensor([rank]), axis=0)
open(os.path.join({out!r}, f"rank{{rank}}.ok"), "w").write(
    f"{{float(t)}} {{[int(x) for x in got]}}")
"""


@pytest.fixture
def flags():
    """Set port flags for one test; put the defaults back after."""
    names = ("worker_hang_timeout_s", "worker_term_grace_s",
             "restart_backoff_s")
    before = {n: paddle_tpu_torch.get_flags([f"FLAGS_{n}"])[f"FLAGS_{n}"]
              for n in names}

    def set_(**kw):
        paddle_tpu_torch.set_flags({f"FLAGS_{k}": v for k, v in kw.items()})

    yield set_
    paddle_tpu_torch.set_flags({f"FLAGS_{k}": v for k, v in before.items()})


# -- parity with the reference ------------------------------------------------

FULL_ARGV = ["--master", "10.0.0.1:6170", "--nnodes", "2",
             "--nproc_per_node", "4", "--node_rank", "1", "--log_dir",
             "logs", "--max_restart", "3", "--devices", "0,1,2,3",
             "train.py", "--lr", "0.1", "--epochs", "2"]


@pytest.mark.parametrize("argv", [["train.py", "--lr", "0.1"], FULL_ARGV],
                         ids=["defaults", "full"])
def test_parse_args_equals_the_reference(argv):
    assert vars(tmain.parse_args(argv)) == vars(jmain.parse_args(argv))


def _args(log_dir, **kw):
    a = dict(master="10.0.0.1:6170", nnodes=2, nproc_per_node=2, rank=1,
             log_dir=str(log_dir), max_restart=0, devices="3,5",
             training_script="train.py", training_script_args=["--x"],
             master_auto=False)
    a.update(kw)
    return argparse.Namespace(**a)


def test_worker_env_equals_the_reference(tmp_path):
    visible = ("CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES",
               "JAX_VISIBLE_DEVICES")
    j = jcoll.CollectiveController(_args(tmp_path))
    t = tcoll.CollectiveController(_args(tmp_path))
    for lr in range(2):
        want, got = j._worker_env(lr), t._worker_env(lr)
        keys = {k for k in want if k.startswith(("PADDLE_", "MASTER_"))}
        assert {k for k in got if k.startswith(("PADDLE_", "MASTER_"))} \
            == keys and "PADDLE_HEARTBEAT_DIR" in keys
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert got["PADDLE_TRAINER_ID"] == str(2 + lr)
        assert got["CUDA_VISIBLE_DEVICES"] == want["CUDA_VISIBLE_DEVICES"] \
            == ("3", "5")[lr]
        for k in visible[1:]:
            assert got.get(k) == os.environ.get(k) != want[k]
    cmd = t._cmd()
    assert cmd[:4] == [sys.executable, "-u", "-m",
                       "paddle_tpu_torch.distributed.launch.bootstrap"]
    assert cmd[4:] == j._cmd()[4:] == ["train.py", "--x"]


def test_all_gather_takes_the_reference_axis_keyword():
    import torch

    import paddle_tpu as paddle

    want, got = [], []
    jt = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    tt = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    jdist.all_gather(want, jt, axis=0)
    tdist.all_gather(got, tt, axis=0)
    # one entry a rank of the default group, each that rank's whole tensor
    # (the reference's group spans its devices, the port's its processes)
    assert len(want) == jdist.collective._get_default_group().nranks
    assert len(got) == tdist.collective._get_default_group().nranks
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))


@pytest.mark.parametrize("name", ["CheckpointManager", "PlanMismatchError",
                                  "save_state_dict", "load_state_dict",
                                  "spawn", "launch"])
def test_distributed_exports_the_reference_names(name):
    from paddle_tpu_torch.distributed import checkpoint as tckpt

    assert name in jdist.__all__ and name in tdist.__all__
    assert getattr(tdist, name).__name__.rsplit(".", 1)[-1] == \
        getattr(jdist, name).__name__.rsplit(".", 1)[-1]
    if name not in ("spawn", "launch"):
        assert getattr(tdist, name) is getattr(tckpt, name)
    else:
        assert callable(getattr(tdist, name))


def test_launcher_and_bootstrap_import_no_torch():
    code = ("import sys\n"
            "import paddle_tpu_torch.distributed.launch.bootstrap\n"
            "from paddle_tpu_torch.distributed.launch.main import main\n"
            "assert 'torch' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]


# -- _watch and run over fake processes ---------------------------------------

class FakeProc:
    """A worker: ``poll`` is None until ``after`` polls, then ``code``
    (None: runs until signalled); SIGTERM ends it with ``on_term`` (None:
    it ignores SIGTERM and needs the SIGKILL)."""

    def __init__(self, code=None, after=0, on_term=-signal.SIGTERM):
        self.code, self.after, self.on_term = code, after, on_term
        self.polls, self.rc, self.signals, self.killed = 0, None, [], False

    def poll(self):
        if self.rc is None and self.code is not None \
                and self.polls >= self.after:
            self.rc = self.code
        self.polls += 1
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        if self.rc is None and self.on_term is not None:
            self.rc = self.on_term

    def wait(self, timeout=None):
        if self.rc is None:
            raise subprocess.TimeoutExpired("fake worker", timeout)
        return self.rc

    def kill(self):
        self.killed = True
        self.rc = -signal.SIGKILL


def _controller(tmp_path, rounds, **kw):
    """A controller whose ``_spawn_all`` installs the next round of fake
    workers (each round a function returning its list)."""
    ctrl = tcoll.CollectiveController(_args(
        tmp_path / "logs", master="127.0.0.1:1", nnodes=1, rank=0,
        devices=None, **kw))
    it = iter(rounds)
    ctrl.rounds = []

    def spawn_all():
        ctrl.procs = next(it)()
        ctrl.rounds.append(ctrl.procs)
        ctrl._spawn_time = time.time()

    ctrl._spawn_all = spawn_all
    return ctrl


def _liveness(tmp_path):
    with open(tmp_path / "logs" / "liveness.log") as f:
        return [int(line.split()[1]) for line in f]


def test_watch_a_crash_kills_the_group_and_returns_its_code(tmp_path, flags):
    flags(worker_term_grace_s=0.5)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(), FakeProc(-9, 2)]])
    ctrl._spawn_all()
    assert ctrl._watch() == -9
    survivor = ctrl.procs[0]
    assert survivor.signals == [signal.SIGTERM] and not survivor.killed


def test_watch_kills_a_survivor_that_ignores_sigterm(tmp_path, flags):
    flags(worker_term_grace_s=0.2)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(on_term=None),
                                           FakeProc(3)]])
    ctrl._spawn_all()
    assert ctrl._watch() == 3
    assert ctrl.procs[0].killed


def test_watch_a_partial_preemption_resolves_after_the_grace_window(
        tmp_path, flags):
    flags(worker_term_grace_s=0.3)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(hb.PREEMPT_EXIT_CODE),
                                           FakeProc()]])
    ctrl._spawn_all()
    t0 = time.time()
    assert ctrl._watch() == hb.PREEMPT_EXIT_CODE
    assert time.time() - t0 >= 0.3
    assert ctrl.procs[1].signals == [signal.SIGTERM]


def test_watch_a_stale_heartbeat_returns_124(tmp_path, flags, capsys):
    flags(worker_hang_timeout_s=0.5, worker_term_grace_s=0.2)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(), FakeProc()]])
    ctrl._spawn_all()
    hb.write(step=4, dir=ctrl._hb_dir, rank=0)
    with open(os.path.join(ctrl._hb_dir, "hb.1"), "w") as f:
        json.dump({"step": 4, "time": time.time() - 10, "pid": 1}, f)
    assert tcoll.HANG_EXIT_CODE == 124
    assert ctrl._watch() == 124
    assert "worker heartbeats stale" in capsys.readouterr().err
    assert all(p.signals == [signal.SIGTERM] for p in ctrl.procs)


def test_watch_a_fresh_heartbeat_keeps_the_group(tmp_path, flags):
    flags(worker_hang_timeout_s=5.0)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(0, 3), FakeProc(0, 4)]])
    ctrl._spawn_all()
    assert ctrl._watch() == 0
    assert not any(p.signals for p in ctrl.procs)


def test_run_a_preemption_leaves_the_budget_untouched(tmp_path, flags,
                                                      capsys):
    flags(restart_backoff_s=0.0)
    code = hb.PREEMPT_EXIT_CODE
    ctrl = _controller(tmp_path, [lambda: [FakeProc(code), FakeProc(code)],
                                  lambda: [FakeProc(0), FakeProc(0)]])
    assert ctrl.run() == 0
    err = capsys.readouterr().err
    assert "restart budget untouched (0/0 used)" in err
    assert "worker failed" not in err and len(ctrl.rounds) == 2


def test_run_a_crash_loop_raises_with_the_exit_code(tmp_path, flags, capsys):
    flags(restart_backoff_s=0.0, worker_term_grace_s=0.2)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(), FakeProc(3)]] * 2,
                       max_restart=1)
    with pytest.raises(tcoll.CrashLoopError) as e:
        ctrl.run()
    assert e.value.exit_code == 3 and e.value.restarts == 1
    assert "crash loop" in str(e.value)
    assert "restart 1/1" in capsys.readouterr().err


def test_run_liveness_log_records_the_dip_and_the_recovery(tmp_path, flags):
    flags(restart_backoff_s=0.0, worker_term_grace_s=0.2)
    ctrl = _controller(tmp_path, [lambda: [FakeProc(), FakeProc(-9, 1)],
                                  lambda: [FakeProc(0, 2), FakeProc(0, 2)]],
                       max_restart=1)
    assert ctrl.run() == 0
    vals = _liveness(tmp_path)
    assert vals[0] == 2 and vals[1] < 2 and 2 in vals[2:], vals
    assert vals[-1] == 0


# -- real processes, no torch -------------------------------------------------

def _launch(args, script, timeout=60, env=None):
    e = dict(os.environ, PYTHONPATH=REPO, FLAGS_restart_backoff_s="0.1")
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args,
         str(script)], cwd=REPO, env=e, capture_output=True, text=True,
        timeout=timeout)


def test_launch_the_flaky_script_restarts_once_and_succeeds(tmp_path):
    script = tmp_path / "flaky.py"
    script.write_text(FLAKY_SCRIPT.format(out=str(tmp_path)))
    r = _launch(["--nproc_per_node=1", "--max_restart=1"], script)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "succeeded").exists()
    assert "restart 1/1" in r.stderr


def test_launch_two_workers_import_no_torch(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(TORCH_FREE_SCRIPT.format(out=str(tmp_path), code=0))
    r = _launch(["--nproc_per_node=2", f"--log_dir={tmp_path / 'logs'}"],
                script)
    assert r.returncode == 0, r.stderr[-2000:]
    for rank in (0, 1):
        assert (tmp_path / f"torch.{rank}").read_text() == "False"
    assert sorted(os.listdir(tmp_path / "logs" / "heartbeats")) == \
        ["hb.0", "hb.1"]


def test_launch_a_failure_propagates_its_exit_code(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(7)")
    r = _launch(["--nproc_per_node=1"], script)
    assert r.returncode == 7


def test_launch_a_crash_loop_ends_with_its_code(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(TORCH_FREE_SCRIPT.format(out=str(tmp_path), code=3))
    r = _launch(["--nproc_per_node=2", "--max_restart=1"], script)
    assert r.returncode == 3, r.stderr[-2000:]
    assert "[launch] crash loop" in r.stderr and "restart 1/1" in r.stderr
    assert (tmp_path / "torch.0").read_text() == "False"


def test_launch_multinode_requires_master(tmp_path):
    script = tmp_path / "x.py"
    script.write_text("pass")
    r = _launch(["--nnodes=2"], script)
    with pytest.raises(SystemExit) as want:
        jmain.main(["--nnodes=2", "x.py"])
    assert r.returncode == 1
    assert r.stderr.strip().splitlines()[-1] == str(want.value)
    assert "--master" in r.stderr


def test_spawn_one_process_runs_inline():
    called = []
    assert tdist.spawn(called.append, args=(1,), nprocs=1) is None
    assert called == [1]


@pytest.mark.parametrize("nprocs", [0, -2])
def test_spawn_invalid_nprocs(nprocs):
    for dist in (jdist, tdist):
        with pytest.raises(ValueError, match="nprocs"):
            dist.spawn(lambda: None, nprocs=nprocs)


# -- slow: workers that import torch ------------------------------------------

def _spawn_target(out_dir):
    import torch

    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(device="cpu")
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"spawn{dist.get_rank()}.ok"), "w") as f:
        f.write(str(float(t)))


def _spawn_crasher(out_dir):
    raise RuntimeError("boom")


@pytest.mark.slow
def test_launch_two_worker_gloo_job(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(COLLECTIVE_SCRIPT.format(out=str(tmp_path)))
    r = _launch(["--nproc_per_node=2"], script, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    for rank in (0, 1):
        assert (tmp_path / f"rank{rank}.ok").read_text() == "3.0 [0, 1]"


@pytest.mark.slow
def test_spawn_two_processes(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO)
    tdist.spawn(_spawn_target, args=(str(tmp_path),), nprocs=2)
    for rank in (0, 1):
        assert (tmp_path / f"spawn{rank}.ok").read_text() == "3.0"


@pytest.mark.slow
def test_spawn_failure_raises_not_hangs(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="exit codes"):
        tdist.spawn(_spawn_crasher, args=(str(tmp_path),), nprocs=2)
    assert time.time() - t0 < 120


@pytest.mark.slow
def test_kill_preempt_hang_drill_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 16 on fp32 llama_tiny on the CPU: each
    job ends in exit 0 with both ranks' losses bit for bit the
    uninterrupted run's; kill and hang charge one restart, preempt none;
    the liveness log dips and recovers; a crash loop ends with exit 3."""
    sys.path.insert(0, REPO)
    import chip_smoke as S

    whole = S.launch_baseline(str(tmp_path / "whole"), "cpu")
    res = S.launch_drill(str(tmp_path), whole, "cpu")
    assert sorted(res) == ["hang", "kill", "preempt"]
    S.launch_crash_loop(str(tmp_path / "crash-loop"))
