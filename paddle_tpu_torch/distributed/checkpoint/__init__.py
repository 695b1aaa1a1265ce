"""Checkpoint save and load in the commit-protocol layout (counterpart of
``paddle_tpu/distributed/checkpoint/__init__.py``).

The on-disk layout is the reference's v3 layout, so a checkpoint either
package writes, the other loads: one ``rank{r}.npz`` of rank-namespaced
shard keys (``<name>@r<r>full``), a ``rank{r}.meta.json`` fragment
recording each entry's global shape, dtype and the CRC32 of its raw
bytes, ``metadata.json`` (the coordinator's fragment, for parity) and a
``COMMIT`` sentinel written strictly last and retracted first. A
directory without ``COMMIT`` is a torn save; a CRC mismatch or an
unreadable member raises :class:`CheckpointCorruptionError`. bfloat16
tensors are stored as their uint16 bits with the dtype "bfloat16" in the
metadata, as the reference stores its extended dtypes.

Saves are single-process: a ``process_group``, or a save in an
initialized ``torch.distributed`` world larger than one (per-rank shards
and the commit barrier), raises ``NotImplementedError`` (ROADMAP Queue 1,
item 8), and each save writes rank 0's shard holding every tensor whole.
Loading reads whole tensors, in any world; :func:`load_model_state` cuts
them to a plan-sharded model's blocks (every rank of a tensor-parallel
engine reads the same whole checkpoint).

``load_state_dict`` copies into the tensors of the given state dict in
place (``copy_`` under ``no_grad``): a module's ``state_dict()`` shares
its parameters' storage, so a restore keeps every ``data_ptr()`` — what
the captured CUDA graphs of a ``FusedTrainStep`` read. An asynchronous
save copies every tensor to host memory before it returns (a ``.cpu()``
copy, never a view of device storage the next step overwrites) and does
everything else on a thread: the CRC32s, the shard, the metadata and the
commit.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import warnings
import zlib

import numpy as np
import torch

from ...framework.io import (CheckpointCorruptionError, numpy_to_tensor,
                             tensor_to_numpy)

__all__ = ["save_state_dict", "load_state_dict", "load_model_state",
           "AsyncSaveHandle",
           "CheckpointManager", "PlanMismatchError",
           "CheckpointCorruptionError", "is_committed",
           "verify_checkpoint"]

COMMIT_FILE = "COMMIT"


def require_single_process(what):
    """Raise ``NotImplementedError`` for ``what`` when ``torch.distributed``
    runs a world larger than one process."""
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            f"{what} in a world of {dist.get_world_size()} processes is not "
            "ported yet (ROADMAP Queue 1, item 8)")


class AsyncSaveHandle:
    """Completion handle for ``save_state_dict(..., async_save=True)``:
    the host snapshot was taken before the save returned; the write runs
    on this handle's thread."""

    def __init__(self, thread, errbox, path=None):
        self._thread = thread
        self._errbox = errbox
        self._path = path

    def done(self):
        return not self._thread.is_alive()

    def wait(self, timeout=None):
        """Block until the write completes; re-raises a write failure (once
        — a waited handle is retired, so a later unrelated save does not
        re-raise it)."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("async checkpoint write still in flight")
        if self in _IN_FLIGHT:
            _IN_FLIGHT.remove(self)
        if self._errbox:
            err = self._errbox[0]
            self._errbox = []
            raise err
    result = wait


_IN_FLIGHT: list = []  # AsyncSaveHandle s not yet waited on


def _drain_in_flight():
    """A new save waits for prior async writes, so two saves to one path
    cannot interleave. A prior save's failure is a warning here (its own
    handle's ``wait()`` still raises it), not an abort of the new save."""
    while _IN_FLIGHT:
        h = _IN_FLIGHT.pop()
        try:
            h.wait()
        except Exception as e:
            warnings.warn(
                f"a previous async checkpoint save to {h._path!r} FAILED: "
                f"{type(e).__name__}: {e} — that checkpoint is incomplete",
                stacklevel=3)


atexit.register(_drain_in_flight)  # never exit with a write mid-file


def _atomic_json(obj, dest, fire_site=None):
    from ...utils.retry import atomic_write

    atomic_write(dest, lambda f: f.write(json.dumps(obj).encode()),
                 fire_site=fire_site)


def _write_commit(path, world_size=1):
    """Publish the COMMIT sentinel — written strictly after every shard and
    metadata fragment of this save is durable."""
    _atomic_json({"version": 3, "world_size": int(world_size)},
                 os.path.join(path, COMMIT_FILE))


def is_committed(path):
    """True iff ``path`` holds a committed checkpoint (COMMIT present and
    parseable)."""
    return _read_commit(path) is not None


def _read_commit(path):
    try:
        with open(os.path.join(path, COMMIT_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _snapshot(value):
    """(host numpy array, dtype name) of one state entry, copied off any
    device."""
    if isinstance(value, torch.Tensor):
        return tensor_to_numpy(value)
    arr = np.asarray(value)
    return arr, arr.dtype.name


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False,
                    pre_write=None):
    """Write ``state_dict`` (name -> tensor or array) as a committed
    checkpoint at ``path``. With ``async_save=True`` the host snapshot is
    taken before returning and the rest runs on a thread; returns an
    :class:`AsyncSaveHandle` (sync saves return None). ``pre_write()``,
    when given, runs first on the writing thread (the manager's auxiliary
    files, so ``COMMIT`` certifies them too)."""
    if process_group is not None:
        raise NotImplementedError(
            "save_state_dict(process_group=...) is not ported yet (ROADMAP "
            "Queue 1, item 8)")
    require_single_process("save_state_dict")
    _drain_in_flight()
    os.makedirs(path, exist_ok=True)
    # retract the previous save's COMMIT first: while this save rewrites
    # the shards the directory must not read as committed; drop fragments
    # of other ranks (a larger world's save) that would otherwise merge
    commit_p = os.path.join(path, COMMIT_FILE)
    if os.path.exists(commit_p):
        os.remove(commit_p)
    for fn in os.listdir(path):
        m = re.match(r"rank(\d+)\.(npz|meta\.json)$", fn)
        if m and int(m.group(1)) >= 1:
            os.remove(os.path.join(path, fn))
    snap = {name: _snapshot(v) for name, v in state_dict.items()}

    def write():
        from ...utils.retry import atomic_write, retry_os

        if pre_write is not None:
            pre_write()
        fragment = {"state": {}, "version": 3, "rank": 0, "world_size": 1}
        payload = {}
        for name, (data, dtype) in snap.items():
            key = f"{name}@r0full"
            payload[key] = data
            fragment["state"][name] = {
                "global_shape": list(data.shape), "dtype": dtype,
                "shards": [{"key": key, "index": None,
                            "crc32": zlib.crc32(
                                np.ascontiguousarray(data).data)}]}
        # the commit protocol's order: shards, then the metadata
        # fragment, then COMMIT; each file lands by tmp + fsync + rename
        retry_os(lambda: atomic_write(
            os.path.join(path, "rank0.npz"),
            lambda f: np.savez(f, **payload),
            fire_site="ckpt.shard_write"))
        retry_os(lambda: _atomic_json(
            fragment, os.path.join(path, "rank0.meta.json")))
        retry_os(lambda: _atomic_json(
            fragment, os.path.join(path, "metadata.json")))
        retry_os(lambda: _write_commit(path, world_size=1))

    if not async_save:
        write()
        return None

    errbox = []

    def run():
        try:
            write()
        except BaseException as e:  # surfaced on handle.wait()
            errbox.append(e)

    # non-daemon: interpreter exit joins the thread instead of killing the
    # write mid-file (and the atexit drain above)
    thread = threading.Thread(target=run, name="ckpt-async-save",
                              daemon=False)
    thread.start()
    handle = AsyncSaveHandle(thread, errbox, path=path)
    _IN_FLIGHT.append(handle)
    return handle


def _merged_metadata(path):
    """Union of every rank's metadata fragment (a save of the JAX package
    may hold several); the private ``_version`` / ``_ranks`` keys feed the
    commit check."""
    merged = {"state": {}, "_version": 1, "_ranks": set()}
    names = sorted(fn for fn in os.listdir(path)
                   if fn.endswith(".meta.json"))
    if not names:
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("version", 1) >= 2:
            raise CheckpointCorruptionError(
                f"checkpoint at {path} is missing its rank*.meta.json "
                "fragments (v2+ layout); copy the full checkpoint directory")
        meta.setdefault("_version", meta.get("version", 1))
        meta.setdefault("_ranks", set())
        return meta
    for fn in names:
        try:
            with open(os.path.join(path, fn)) as f:
                frag = json.load(f)
        except ValueError as e:
            raise CheckpointCorruptionError(
                f"metadata fragment {fn!r} in checkpoint {path} is not "
                f"valid JSON ({e}); the save was torn mid-write") from e
        merged["_version"] = max(merged["_version"],
                                 int(frag.get("version", 1)))
        if "rank" in frag:
            merged["_ranks"].add(int(frag["rank"]))
        for name, info in frag["state"].items():
            entry = merged["state"].setdefault(name, {
                "global_shape": info["global_shape"],
                "dtype": info["dtype"], "shards": []})
            entry["shards"].extend(info["shards"])
    return merged


def _check_commit(path, metadata):
    """v3 checkpoints must carry COMMIT, and every fragment rank of the
    saving world must be present — anything less is a torn save."""
    if metadata.get("_version", 1) < 3:
        return
    commit = _read_commit(path)
    if commit is None:
        raise CheckpointCorruptionError(
            f"checkpoint at {path} has no COMMIT sentinel — the save was "
            "killed before completing; resume from the newest committed "
            "step (CheckpointManager.latest_valid_step skips this one)")
    world = int(commit.get("world_size", 1))
    missing = set(range(world)) - metadata.get("_ranks", set())
    if missing:
        raise CheckpointCorruptionError(
            f"checkpoint at {path} was saved by {world} processes but the "
            f"metadata fragments of rank(s) {sorted(missing)} are missing")


def _storage_dtype(name):
    """The numpy dtype a shard of dtype ``name`` is stored in (extended
    dtypes as same-width unsigned integers)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError as e:
        raise CheckpointCorruptionError(
            f"checkpoint dtype {name!r} has no counterpart here") from e


class _ShardReader:
    """Lazy npz access with typed corruption errors and CRC verification."""

    def __init__(self, path):
        self.path = path
        self._files = []
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".npz"):
                continue
            try:
                self._files.append(np.load(os.path.join(path, fn)))
            except Exception as e:
                raise CheckpointCorruptionError(
                    f"checkpoint shard file {fn!r} in {path} is unreadable "
                    f"({type(e).__name__}: {e})") from e

    def read(self, shard, dtype):
        key = shard["key"]
        for f in self._files:
            if key not in f:
                continue
            try:
                data = f[key]
            except Exception as e:  # zipfile/zlib CRC or truncation errors
                raise CheckpointCorruptionError(
                    f"shard {key!r} in checkpoint {self.path} is corrupt "
                    f"({type(e).__name__}: {e})") from e
            want = shard.get("crc32")
            if want is not None and zlib.crc32(
                    np.ascontiguousarray(data).data) != want:
                raise CheckpointCorruptionError(
                    f"shard {key!r} in checkpoint {self.path} failed CRC32 "
                    "verification — the bytes on disk do not match what "
                    "was saved")
            if data.dtype != dtype:
                data = data.view(dtype)
            return data
        raise CheckpointCorruptionError(
            f"shard {key!r} named by the metadata of checkpoint "
            f"{self.path} is absent from every shard file")

    def close(self):
        for f in self._files:
            f.close()
        self._files = []


def _read_full(reader, info):
    """The whole array of one entry, assembled from its shards."""
    dtype = _storage_dtype(info["dtype"])
    full = np.zeros(info["global_shape"], dtype=dtype)
    if full.ndim == 0:
        return np.asarray(reader.read(info["shards"][0], dtype))
    for sh in info["shards"]:
        data = reader.read(sh, dtype)
        if sh["index"] is None:
            full = np.asarray(data)
        else:
            full[tuple(slice(a, b) for a, b in sh["index"])] = data
    return full


def verify_checkpoint(path):
    """Full integrity pass: commit sentinel, fragment completeness, and
    CRC32 of every shard. Returns the merged metadata; raises
    :class:`CheckpointCorruptionError` (or ``FileNotFoundError``)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path!r}")
    try:
        metadata = _merged_metadata(path)
    except FileNotFoundError:
        # no sharded payload at all (a pickle/writer-only save): the files
        # are whole by the atomic-rename guarantee, COMMIT alone decides
        if is_committed(path):
            return {"state": {}}
        raise CheckpointCorruptionError(
            f"checkpoint at {path} has neither shard metadata nor a "
            "COMMIT sentinel — nothing verifiable was saved there")
    _check_commit(path, metadata)
    reader = _ShardReader(path)
    try:
        for info in metadata["state"].values():
            dtype = _storage_dtype(info["dtype"])
            for sh in info["shards"]:
                reader.read(sh, dtype)
    finally:
        reader.close()
    return metadata


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, offload=False):
    """Fill ``state_dict``'s tensors in place (``copy_``, in each tensor's
    dtype and on its device) from the committed checkpoint at ``path``,
    after verifying COMMIT, the fragments and each shard's CRC32. Names
    the checkpoint lacks are left as they are; a shape mismatch raises
    ``ValueError`` before anything is copied."""
    if process_group is not None:
        raise NotImplementedError(
            "load_state_dict(process_group=...) is not ported yet (ROADMAP "
            "Queue 1, item 8)")
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"no checkpoint directory at {path!r}; "
            "CheckpointManager.latest_valid_step() locates the newest "
            "committed step under a checkpoint root")
    metadata = _merged_metadata(path)
    _check_commit(path, metadata)
    reader = _ShardReader(path)
    try:
        loaded = {}
        for name, t in state_dict.items():
            info = metadata["state"].get(name)
            if info is None:
                continue
            src = numpy_to_tensor(_read_full(reader, info), info["dtype"])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(src.shape)} != {tuple(t.shape)}")
            loaded[name] = src
    finally:
        reader.close()
    with torch.no_grad():
        for name, src in loaded.items():
            t = state_dict[name]
            t.copy_(src.to(device=t.device, dtype=t.dtype))
    return state_dict


def load_model_state(model, path):
    """Load the committed checkpoint at ``path`` into ``model`` in place.
    A model that adopted a sharding plan (``model._plan_shards``) reads
    each sharded tensor whole on the host and keeps its own block
    (``nn.layer.layers.set_state_dict``); any other model loads through
    :func:`load_state_dict`."""
    shards = getattr(model, "_plan_shards", None)
    if not shards:
        return load_state_dict(model.state_dict(), path)
    from ...nn.layer.layers import set_state_dict

    own = model.state_dict()
    whole = {name: (torch.empty(shards[name][0], dtype=t.dtype)
                    if name in shards else t)
             for name, t in own.items()}
    load_state_dict(whole, path)
    set_state_dict(model, {n: whole[n] for n in shards})
    return own


from .manager import (CheckpointManager,  # noqa: E402  (needs the fns above)
                      PlanMismatchError)
