"""Checkpoint lifecycle manager: step-stamped saves, retention, auto-resume
(counterpart of ``paddle_tpu/distributed/checkpoint/manager.py``).

The reference's layout, so either package resumes the other's runs::

    root/
      step_100/   rank0.npz  rank0.meta.json  metadata.json  COMMIT
                  optimizer.pdopt  scaler.pdscaler  sampler.pdsampler
                  sampler.rank0.pdsampler  HEALTHY
      step_200/   ...                                   <- newest committed

- ``save(step, model=…, optimizer=…, scaler=…, sampler=…)`` writes the
  auxiliary pickles first (atomic, via ``framework.io.save``) and the
  model shards + ``COMMIT`` last, so the sentinel certifies the whole
  directory. An asynchronous save (``async_save``) takes every state dict
  and the model's host snapshot before it returns and writes the pickles,
  the shards and ``COMMIT`` on the save's thread (the reference writes
  the pickles before returning).
- ``latest_valid_step()`` is the crash-recovery query: the newest
  committed step (optionally CRC-verified), skipping torn saves.
- ``auto_resume(model, optimizer, scaler, sampler, step=)`` restores from
  that step, or the pinned ``step``, and returns the step number, or
  ``None`` when nothing valid exists. The model is written in place (its
  parameters keep their ``data_ptr()``, which a ``FusedTrainStep``'s
  captured graphs read).
- Retention keeps the last ``keep_last_n`` committed steps and never
  deletes the newest committed or the newest healthy one; with an async
  save it waits until the write lands.
- **Health metadata** (the divergence sentinel's contract): a committed
  step is *healthy* once ``k`` clean windows passed beyond it
  (``note_window``); ``latest_healthy_step()`` is the rollback query and
  ``drop_steps_after(step)`` the post-rollback sweep.

- **The plan gate**: ``save(..., plan=)`` records the plan's
  fingerprint (``plan.json``: mesh + rule digest, the reference's format)
  and ``auto_resume(..., plan=)`` (and ``LLMEngine.reload_weights``)
  raises :class:`PlanMismatchError` before touching any state when the
  recorded plan differs. A plan-sharded model restores by reading each
  tensor whole and keeping its block (``load_model_state``).

Saves are single-process (``distributed.checkpoint`` raises for a larger
world): rank 0 saves the full state dict of a model whose parameters are
whole. Sharded per-rank checkpoints and the commit barrier are ROADMAP
Queue 1 item 8, and saving a plan-sharded model raises naming it.
"""

from __future__ import annotations

import os
import re
import shutil
import time

from ...framework import io as _fio
from ...framework.io import CheckpointCorruptionError
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from . import (_write_commit, is_committed, load_model_state,
               save_state_dict, verify_checkpoint)

__all__ = ["CheckpointManager", "PlanMismatchError"]

_STEP_RE = re.compile(r"^step_(\d+)$")

# checkpoint IO observability: durations as histograms, bytes as a
# counter (process-wide, unlabeled). For async saves the duration covers
# the synchronous part; bytes are accounted when the save lands.
_H_SAVE_S = _obs_metrics.histogram(
    "ckpt_save_seconds", "wall time of CheckpointManager.save (async: "
    "the synchronous submission portion)",
    buckets=_obs_metrics.DEFAULT_SECONDS_BUCKETS)
_H_RESTORE_S = _obs_metrics.histogram(
    "ckpt_restore_seconds", "wall time of CheckpointManager.auto_resume "
    "when a checkpoint was actually restored",
    buckets=_obs_metrics.DEFAULT_SECONDS_BUCKETS)
_M_SAVE_BYTES = _obs_metrics.counter(
    "ckpt_save_bytes_total", "bytes in committed checkpoint step dirs, "
    "accounted when the save lands")

_OPT_FILE = "optimizer.pdopt"
_SCALER_FILE = "scaler.pdscaler"
_SAMPLER_FILE = "sampler.pdsampler"
_RANK_SAMPLER_RE = re.compile(r"^sampler\.rank(\d+)\.pdsampler$")
_HEALTH_FILE = "HEALTHY"
_PLAN_FILE = "plan.json"


class PlanMismatchError(RuntimeError):
    """A checkpoint written under one sharding plan is being restored
    under an incompatible one (different mesh shape, or different
    param-spec/strategy tables over the same mesh). Restoring anyway
    would mis-shard silently. Re-create the Plan the checkpoint records
    (``plan.json`` in the step directory holds its mesh + digest), or
    restore with ``plan=None`` to skip the check deliberately."""


def _rank_sampler_file(rank):
    return f"sampler.rank{int(rank)}.pdsampler"


def dir_bytes(path):
    """Bytes of the files under ``path``."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:
                pass
    return total


def _resolve_sampler(obj):
    """Accept a BucketedBatchSampler, a DataLoader or a DevicePrefetcher
    as ``sampler=`` and unwrap to the object owning the stream state."""
    from ...io import resolve_resumable

    r = resolve_resumable(obj)
    if r is None:
        raise TypeError(
            f"{type(obj).__name__} is not a resumable data stream: it "
            "must expose (or wrap something exposing) state_dict/"
            "set_state_dict/advance — see io.BucketedBatchSampler")
    return r


def _whole(model, what):
    """Refuse to save a plan-sharded model: its tensors are this rank's
    blocks, and per-rank shards with their commit barrier are not
    ported."""
    if model is not None and getattr(model, "_plan_shards", None):
        raise NotImplementedError(
            f"CheckpointManager.{what}: the model holds plan-sharded "
            "blocks; sharded per-rank checkpoints and the commit barrier "
            "are not ported yet (ROADMAP Queue 1, item 8) — save the whole "
            "model from one process")


class CheckpointManager:
    def __init__(self, root, keep_last_n=None, async_save=False):
        if keep_last_n is not None and int(keep_last_n) < 1:
            raise ValueError("keep_last_n must be >= 1 (the newest committed "
                             "checkpoint is never deleted)")
        self.root = str(root)
        self.keep_last_n = None if keep_last_n is None else int(keep_last_n)
        self.async_save = bool(async_save)
        self._pending = None  # in-flight (step, AsyncSaveHandle)
        # committed steps awaiting their k clean windows, {step: clean
        # windows seen}; in memory on purpose: a restarted process earns
        # them again (never healthy on less than k observed windows)
        self._health_pending: dict[int, int] = {}
        os.makedirs(self.root, exist_ok=True)

    # ---- layout ---------------------------------------------------------
    def step_dir(self, step):
        return os.path.join(self.root, f"step_{int(step)}")

    def steps(self):
        """All step-stamped directories under the root, sorted ascending
        (committed or not)."""
        out = []
        for entry in os.listdir(self.root):
            m = _STEP_RE.match(entry)
            if m and os.path.isdir(os.path.join(self.root, entry)):
                out.append(int(m.group(1)))
        return sorted(out)

    def committed_steps(self):
        return [s for s in self.steps() if is_committed(self.step_dir(s))]

    def _recover_quarantines(self):
        """A crash mid-resave leaves the only committed copy of a step
        under ``step_{n}.replaced.*`` while ``step_{n}`` itself is torn —
        restore it so resume finds it."""
        if self._pending is not None:
            return
        for entry in os.listdir(self.root):
            base, sep, _ = entry.partition(".replaced.")
            if not sep or not _STEP_RE.match(base):
                continue
            q = os.path.join(self.root, entry)
            d = os.path.join(self.root, base)
            if not os.path.isdir(q) or not is_committed(q):
                continue
            if is_committed(d):
                continue  # the resave landed; retention sweeps the copy
            if os.path.isdir(d):
                shutil.rmtree(d)  # the torn resave attempt
            os.rename(q, d)

    def latest_valid_step(self, verify=False):
        """Newest committed step; ``verify=True`` also CRC-checks every
        shard, walking further back past corrupt saves. ``None`` when no
        valid checkpoint exists."""
        self._recover_quarantines()
        for s in reversed(self.committed_steps()):
            if not verify:
                return s
            try:
                verify_checkpoint(self.step_dir(s))
                return s
            except (CheckpointCorruptionError, FileNotFoundError):
                continue
        return None

    # ---- health metadata (divergence sentinel) --------------------------
    def is_healthy(self, step):
        """Committed AND tagged HEALTHY: the sentinel saw ``k`` clean
        windows pass beyond it."""
        d = self.step_dir(step)
        return (is_committed(d)
                and os.path.exists(os.path.join(d, _HEALTH_FILE)))

    def tag_healthy(self, step):
        """Stamp a committed step as a rollback target (atomic marker
        write). No-op on an uncommitted or missing step."""
        d = self.step_dir(step)
        if not is_committed(d):
            return False
        marker = os.path.join(d, _HEALTH_FILE)
        tmp = f"{marker}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("healthy\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, marker)
        return True

    def note_window(self, clean, k=1):
        """Sentinel hook, once per window boundary (after any checkpoint
        written at it): a clean window credits every pending committed
        step, promoting those that reach ``k`` to HEALTHY, then registers
        newly committed steps at zero (a step saved at this very boundary
        needs ``k`` more); a bad window resets every pending count.
        Returns the steps promoted."""
        promoted = []
        if not clean:
            for s in self._health_pending:
                self._health_pending[s] = 0
            return promoted
        k = max(1, int(k))
        for s in sorted(self._health_pending):
            self._health_pending[s] += 1
            if self._health_pending[s] >= k:
                if self.tag_healthy(s):
                    promoted.append(s)
                self._health_pending.pop(s)
        for s in self.committed_steps():
            if s not in self._health_pending and not self.is_healthy(s):
                self._health_pending[s] = 0
        return promoted

    def latest_healthy_step(self, verify=False):
        """Newest committed step tagged HEALTHY (``verify=True`` also
        CRC-walks it) — the rollback target. ``None`` when none is."""
        self._recover_quarantines()
        for s in reversed(self.committed_steps()):
            if not self.is_healthy(s):
                continue
            if not verify:
                return s
            try:
                verify_checkpoint(self.step_dir(s))
                return s
            except (CheckpointCorruptionError, FileNotFoundError):
                continue
        return None

    def drop_steps_after(self, step):
        """Post-rollback sweep: delete every step directory (committed or
        torn) newer than ``step``, and their quarantine copies. Returns
        the dropped step numbers."""
        self.wait()
        step = int(step)
        dropped = [s for s in self.steps() if s > step]
        for s in list(self._health_pending):
            if s > step:
                self._health_pending.pop(s)
        for s in dropped:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        for entry in os.listdir(self.root):
            base, sep, _ = entry.partition(".replaced.")
            m = _STEP_RE.match(base)
            if sep and m and int(m.group(1)) > step:
                shutil.rmtree(os.path.join(self.root, entry),
                              ignore_errors=True)
        return dropped

    # ---- plan fingerprint ----------------------------------------------
    def plan_fingerprint(self, step):
        """The ``{"mesh": {...}, "digest": ...}`` fingerprint recorded at
        save time, or ``None`` for plan-less checkpoints."""
        import json

        p = os.path.join(self.step_dir(step), _PLAN_FILE)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    @staticmethod
    def _check_plan(recorded, plan, step):
        """Raise :class:`PlanMismatchError` when ``plan``'s fingerprint
        disagrees with the recorded one. A plan-less checkpoint restored
        under a plan (or vice versa) passes — there is nothing recorded
        to contradict."""
        if recorded is None or plan is None:
            return
        fp = plan.fingerprint()
        if dict(recorded.get("mesh", {})) != dict(fp["mesh"]):
            raise PlanMismatchError(
                f"checkpoint step_{step} was written under mesh "
                f"{recorded.get('mesh')} but is being restored under mesh "
                f"{fp['mesh']} — restoring would mis-shard silently; "
                "rebuild the recorded mesh or pass plan=None to override")
        if recorded.get("digest") != fp["digest"]:
            raise PlanMismatchError(
                f"checkpoint step_{step} was written under the same mesh "
                f"{fp['mesh']} but a DIFFERENT plan table (digest "
                f"{recorded.get('digest')} vs {fp['digest']}): param/"
                "moment layouts differ — rebuild the recorded plan or "
                "pass plan=None to override")

    # ---- save -----------------------------------------------------------
    def save(self, step, model=None, optimizer=None, scaler=None,
             state_dict=None, writer=None, async_save=None, sampler=None,
             plan=None):
        """Write a committed checkpoint for ``step``: ``model`` /
        ``state_dict`` through the sharded writer (COMMIT last),
        ``optimizer`` / ``scaler`` / ``sampler`` state dicts pickled
        before the shards (``sampler``: the batch sampler, its DataLoader
        or a DevicePrefetcher), ``writer(dir_path)`` for extra files under
        the same commit, ``plan``'s fingerprint as ``plan.json``. Returns
        the :class:`AsyncSaveHandle` of an async save, else ``None``."""
        _whole(model, "save")
        # land the previous async save before this save's timer starts
        self.wait()
        t0_ns = time.perf_counter_ns()
        try:
            handle = self._save_impl(step, model=model, optimizer=optimizer,
                                     scaler=scaler, state_dict=state_dict,
                                     writer=writer, async_save=async_save,
                                     sampler=sampler, plan=plan)
        finally:
            t1_ns = time.perf_counter_ns()
            _H_SAVE_S.observe((t1_ns - t0_ns) / 1e9)
            _obs_trace.add_complete("ckpt.save", t0_ns, t1_ns, cat="ckpt",
                                    args={"step": int(step)})
        if handle is None:
            _M_SAVE_BYTES.inc(dir_bytes(self.step_dir(step)))
        return handle

    def _save_impl(self, step, model=None, optimizer=None, scaler=None,
                   state_dict=None, writer=None, async_save=None,
                   sampler=None, plan=None):
        if async_save is None:
            async_save = self.async_save
        # one snapshot serves both cursor files
        sampler_state = (None if sampler is None
                         else _resolve_sampler(sampler).state_dict())
        d = self.step_dir(step)
        if os.path.isdir(d):
            if is_committed(d):
                # never destroy committed data before its replacement
                # commits: quarantine it out of the step_{n} namespace
                os.rename(d, f"{d}.replaced.{os.getpid()}")
            else:
                shutil.rmtree(d)  # torn attempt at the same step
        os.makedirs(d, exist_ok=True)
        # every state dict is taken, its tensors copied, now: the files
        # may be written later, on the save's thread
        aux = []
        if optimizer is not None:
            aux.append((_OPT_FILE, optimizer.state_dict()))
        if scaler is not None:
            aux.append((_SCALER_FILE, scaler.state_dict()))
        aux = [(fn, _fio.to_saveable(obj)) for fn, obj in aux]
        if sampler_state is not None:
            rank = (sampler_state.get("rank", 0)
                    if isinstance(sampler_state, dict) else 0)
            aux += [(_SAMPLER_FILE, sampler_state),
                    (_rank_sampler_file(rank), sampler_state)]
        if plan is not None:
            # step metadata: mesh shape + rule/strategy digest, so a
            # restore under an incompatible plan fails typed
            import json

            from ...utils.retry import atomic_write

            payload = json.dumps(plan.fingerprint()).encode()
            atomic_write(os.path.join(d, _PLAN_FILE),
                         lambda f: f.write(payload))
        if writer is not None:
            writer(d)

        def write_aux():
            for fn, obj in aux:
                _fio.save(obj, os.path.join(d, fn))

        sd = {}
        if model is not None:
            sd.update(model.state_dict())
        if state_dict:
            sd.update(state_dict)
        if sd:
            handle = save_state_dict(sd, d, async_save=async_save,
                                     pre_write=write_aux)
            if handle is not None:
                self._pending = (int(step), handle)
                return handle
        else:
            write_aux()
            _write_commit(d)  # pickle/writer-only save: commit it here
        self._retain()
        return None

    def wait(self):
        """Block until the in-flight async save lands (re-raising its write
        failure), then run the retention it deferred."""
        if self._pending is None:
            return
        step, handle = self._pending
        self._pending = None
        handle.wait()
        _M_SAVE_BYTES.inc(dir_bytes(self.step_dir(step)))
        self._retain()

    def _retain(self):
        """keep-last-N over committed steps, run right after a save lands.
        Torn directories are swept, and ``*.replaced.*`` quarantines once
        redundant (their re-save landed or a newer commit exists); the
        others are bounded by ``FLAGS_ckpt_quarantine_keep`` when >= 0.
        The newest committed step and the newest HEALTHY step survive."""
        from ...core.flags import flag_value

        committed = self.committed_steps()
        newest = committed[-1] if committed else None
        survivors = []
        for entry in os.listdir(self.root):
            base, sep, _ = entry.partition(".replaced.")
            m = _STEP_RE.match(base)
            if not sep or not m:
                continue
            if is_committed(os.path.join(self.root, base)) or (
                    newest is not None and newest > int(m.group(1))):
                shutil.rmtree(os.path.join(self.root, entry),
                              ignore_errors=True)
            else:
                survivors.append(entry)
        qkeep = int(flag_value("ckpt_quarantine_keep", -1))
        if qkeep >= 0 and len(survivors) > qkeep:
            def qage(entry):
                try:
                    return os.path.getmtime(os.path.join(self.root, entry))
                except OSError:
                    return 0.0
            survivors.sort(key=qage, reverse=True)  # newest first
            for entry in survivors[qkeep:]:
                shutil.rmtree(os.path.join(self.root, entry),
                              ignore_errors=True)
        if self.keep_last_n is None:
            return
        healthy = [s for s in committed if self.is_healthy(s)]
        newest_healthy = healthy[-1] if healthy else None
        victims = [s for s in self.steps() if s not in committed]
        victims += [s for s in committed[:-self.keep_last_n]
                    if s != newest_healthy]
        for s in victims:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ---- resume ---------------------------------------------------------
    def auto_resume(self, model=None, optimizer=None, scaler=None,
                    verify=False, sampler=None, step=None, plan=None):
        """Restore ``model`` + ``optimizer`` + ``scaler`` + ``sampler``
        from the newest valid checkpoint (or the committed ``step``) and
        return its step; ``None``, touching nothing, when no committed
        checkpoint exists. The model's tensors are written in place (a
        plan-sharded model keeps its blocks of the whole tensors).
        ``verify=True`` CRC-walks candidate steps first; an uncommitted
        ``step`` raises ValueError. ``plan`` is checked against the
        step's recorded fingerprint before any state is touched
        (:class:`PlanMismatchError`)."""
        self.wait()
        if step is None:
            step = self.latest_valid_step(verify=verify)
        else:
            step = int(step)
            self._recover_quarantines()
            if not is_committed(self.step_dir(step)):
                raise ValueError(
                    f"auto_resume(step={step}): no committed checkpoint "
                    f"at {self.step_dir(step)} (committed steps: "
                    f"{self.committed_steps()})")
            if verify:
                verify_checkpoint(self.step_dir(step))
        if step is None:
            return None
        # plan fingerprint gate before any state is touched: a mismatch
        # must leave model/optimizer exactly as they were
        self._check_plan(self.plan_fingerprint(step), plan, step)
        t0_ns = time.perf_counter_ns()
        d = self.step_dir(step)
        if model is not None and any(
                fn.endswith(".npz") for fn in os.listdir(d)):
            load_model_state(model, d)
        opt_p = os.path.join(d, _OPT_FILE)
        if optimizer is not None and os.path.exists(opt_p):
            optimizer.set_state_dict(_fio.load(opt_p))
        sc_p = os.path.join(d, _SCALER_FILE)
        if scaler is not None and os.path.exists(sc_p):
            scaler.load_state_dict(_fio.load(sc_p))
        if sampler is not None:
            self._restore_sampler(sampler, d)
        t1_ns = time.perf_counter_ns()
        _H_RESTORE_S.observe((t1_ns - t0_ns) / 1e9)
        _obs_trace.add_complete("ckpt.restore", t0_ns, t1_ns, cat="ckpt",
                                args={"step": int(step)})
        return step

    def _restore_sampler(self, sampler, d):
        """Restore the stream cursor recorded in step dir ``d``: this
        rank's ``sampler.rank0.pdsampler`` before the legacy
        ``sampler.pdsampler``; a resumable with ``set_group_state`` gets
        every rank's file."""
        r = _resolve_sampler(sampler)
        rank_states = {}
        for fn in os.listdir(d):
            m = _RANK_SAMPLER_RE.match(fn)
            if m:
                rank_states[int(m.group(1))] = os.path.join(d, fn)
        if rank_states and hasattr(r, "set_group_state"):
            r.set_group_state([_fio.load(rank_states[k])
                               for k in sorted(rank_states)])
            return
        mine = rank_states.get(0)
        if mine is not None:
            r.set_state_dict(_fio.load(mine))
            return
        sp_p = os.path.join(d, _SAMPLER_FILE)
        if os.path.exists(sp_p):
            r.set_state_dict(_fio.load(sp_p))
