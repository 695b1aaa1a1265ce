"""Transient-failure retry with exponential backoff + jitter (counterpart
of ``paddle_tpu/utils/retry.py``).

One backoff shape for every durability path: ``framework/io.save`` and
the ``distributed/checkpoint`` shard writes funnel through
:func:`retry_os`, so the retry budget is tuned in one place
(``FLAGS_ckpt_save_retries``). The reference Paddle hand-rolls the
same shape per call site (e.g. HDFSClient's sleep_inter loop); centralizing
it keeps the checkpoint lifecycle's failure semantics uniform.

Cross-filesystem publication: ``os.rename``/``os.replace`` across mount
points fails with ``EXDEV`` *deterministically* — retrying spins through the
whole budget and then fails anyway, which is why EXDEV is classified
non-transient here. :func:`replace_across_fs` is the escape hatch the
publish paths use instead: same-filesystem renames stay one atomic syscall,
and an EXDEV falls back to copy-to-tmp-on-the-destination-filesystem +
fsync + ``os.replace`` — the destination still only ever holds complete
bytes, so checkpoints to a mounted volume (NFS/GCS-FUSE scratch) keep the
atomic-visibility guarantee.
"""

from __future__ import annotations

import errno
import os
import random
import shutil
import time

__all__ = ["retry_os", "atomic_write", "replace_across_fs", "atomic_copy"]

# deterministic failures: retrying can't fix a missing path, a permission
# wall, or a path-type mismatch — surface them immediately, no backoff
_NON_TRANSIENT = (FileNotFoundError, PermissionError, FileExistsError,
                  IsADirectoryError, NotADirectoryError)
# errno-classified deterministic failures (no dedicated exception subclass):
# EXDEV (cross-device rename) needs a different *strategy*, not a retry
_NON_TRANSIENT_ERRNOS = frozenset({errno.EXDEV, errno.ENOSPC})


def _is_non_transient(e):
    return (isinstance(e, _NON_TRANSIENT)
            or getattr(e, "errno", None) in _NON_TRANSIENT_ERRNOS)


def retry_os(fn, retries=None, base_delay=0.01, max_delay=0.5, jitter=0.5,
             rng=None, retry_on=(OSError,)):
    """Call ``fn()``; on a *transient* exception in ``retry_on`` retry up to
    ``retries`` times (default ``FLAGS_ckpt_save_retries``), sleeping
    ``min(max_delay, base_delay * 2**attempt) * (1 + jitter * U[0,1))``
    between attempts. Deterministic OSErrors (missing path, permissions,
    path-type mismatch, cross-device rename, disk full) are never retried.
    The final failure re-raises the original exception. Pass a seeded
    ``rng`` (anything with ``.random()``) for deterministic jitter in
    tests."""
    if retries is None:
        from ..core.flags import flag_value

        retries = int(flag_value("ckpt_save_retries", 3))
    if rng is None:
        rng = random
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if _is_non_transient(e) or attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2 ** attempt))
            time.sleep(delay * (1.0 + jitter * rng.random()))
            attempt += 1


def replace_across_fs(src, dst):
    """``os.replace`` that survives crossing a filesystem boundary. The
    fast path is the plain atomic rename; on ``EXDEV`` the payload is
    copied to a tmp name *on the destination filesystem*, fsynced, and
    published with a same-filesystem ``os.replace`` — so ``dst`` never
    holds partial bytes even when ``src`` lives on a different mount.
    Directories fall back to a tree copy published the same way. ``src``
    is removed after a successful cross-filesystem publish (rename
    semantics)."""
    try:
        os.replace(src, dst)
        return
    except OSError as e:
        if e.errno != errno.EXDEV:
            raise
    tmp = f"{dst}.xfs.{os.getpid()}"
    try:
        if os.path.isdir(src):
            _copytree_fsynced(src, tmp)
        else:
            with open(src, "rb") as fsrc, open(tmp, "wb") as fdst:
                shutil.copyfileobj(fsrc, fdst)
                fdst.flush()
                os.fsync(fdst.fileno())
        os.replace(tmp, dst)
    except BaseException:
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            else:
                os.remove(tmp)
        except OSError:
            pass
        raise
    # publish succeeded; clearing the source is best-effort (a leftover
    # source never violates the destination's atomicity)
    try:
        if os.path.isdir(src):
            shutil.rmtree(src)
        else:
            os.remove(src)
    except OSError:
        pass


def _copytree_fsynced(src, tmp):
    """Copy ``src`` to the fresh tmp tree ``tmp`` and fsync every file:
    copytree alone does not fsync, and without the walk a power loss
    after a later publish could leave the destination as a
    complete-looking directory of truncated files."""
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    shutil.copytree(src, tmp)
    for root, _dirs, files in os.walk(tmp):
        for fn in files:
            with open(os.path.join(root, fn), "rb") as f:
                os.fsync(f.fileno())


def atomic_copy(src, dst):
    """Copy ``src`` (file or directory) to ``dst`` with atomic
    visibility: the payload lands under a tmp name next to ``dst``,
    is fsynced, and publishes with one rename — a torn ``dst`` is never
    visible. Files route through :func:`atomic_write` (fully atomic).

    Directory destinations are atomic-or-RECOVERABLE: ``os.replace``
    cannot clobber a non-empty directory, so an existing ``dst`` is
    first moved to the deterministic tool-owned quarantine name
    ``dst + ".__atomic_copy_old__"`` and deleted only after the new
    tree publishes. A process killed inside that window leaves ``dst``
    absent with the old tree intact under the quarantine name — the
    NEXT ``atomic_copy`` to the same destination restores it before
    doing anything else, so the previous contents are never lost (an
    in-process failure restores it immediately). The quarantine name is
    deliberately ugly: it belongs to this function, and anything found
    there is treated as its own crash leftover."""
    if os.path.isdir(src):
        old = f"{dst}.__atomic_copy_old__"
        # crash recovery from a previous copy killed between quarantine
        # and publish: the old tree is authoritative while dst is
        # missing; once dst exists again the leftover is stale
        if os.path.isdir(old):
            if not os.path.exists(dst):
                os.replace(old, dst)
            else:
                shutil.rmtree(old)
        tmp = f"{dst}.cp.{os.getpid()}"
        try:
            _copytree_fsynced(src, tmp)
            if os.path.isdir(dst):
                os.replace(dst, old)
                try:
                    replace_across_fs(tmp, dst)
                except BaseException:
                    try:
                        if not os.path.exists(dst):
                            os.replace(old, dst)
                    except OSError:
                        pass
                    raise
                shutil.rmtree(old, ignore_errors=True)
            else:
                replace_across_fs(tmp, dst)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return

    def body(f):
        with open(src, "rb") as fsrc:
            shutil.copyfileobj(fsrc, f)

    atomic_write(dst, body)


def atomic_write(dest, write_body, fire_site=None):
    """The one atomic-publication shape: tmp file → ``write_body(f)`` →
    (injection point) → flush+fsync → ``os.replace``. The destination only
    ever holds complete bytes; any failure removes the tmp file and leaves
    the previous destination untouched. ``fire_site`` names the
    fault-injection site sitting in the "killed mid-save" window (data
    written, nothing published). The final publish goes through
    :func:`replace_across_fs`, so a ``dest`` whose directory resolves to a
    different filesystem than the tmp file (exotic overlay/bind setups)
    still lands atomically instead of burning the retry budget on EXDEV."""
    from . import fault_injection

    tmp = f"{dest}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_body(f)
            if fire_site is not None:
                fault_injection.fire(fire_site)
            f.flush()
            os.fsync(f.fileno())
        replace_across_fs(tmp, dest)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
