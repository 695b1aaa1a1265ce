"""Deterministic fault injection for the fault-tolerance surface (counterpart
of ``paddle_tpu/utils/fault_injection.py``: the same site registry, so a
drill arms the same names in both packages; the port calls the training,
checkpoint, prefetch and heartbeat sites, and the serving and streaming
sites wait for their subsystems).

Reference inspiration: the reference Paddle exercises its elastic/checkpoint
recovery paths with unit-test fakes (fake etcd stores, forced
check_finite_and_unscale overflows). Here every failure mode the durability
layer defends against is a *named site* that production code calls into; a
test (or a chaos drill) arms a site with :func:`inject` and the exact same
code path that would fail in production fails on demand, deterministically.

Sites wired into the framework:

- ``ckpt.shard_write``  — distributed.checkpoint shard write, fired after the
  shard payload hits the tmp file but before the atomic rename (the "process
  killed mid-save" window: data on disk, checkpoint not visible/committed).
- ``io.save``           — paddle.save pickle write, same window.
- ``train.grad_nan``    — FusedTrainStep input poisoning: the step's first
  floating-point input becomes NaN, so loss/grads go non-finite and the step
  guard must react.
- ``fs.rename``         — fleet.utils.fs.LocalFS.rename, fired before the
  os.rename (exercises the transient-OSError retry/backoff path).
- ``io.prefetch``       — DevicePrefetcher transfer thread, fired before a
  batch is staged (bucket-pad + device_put): the thread dies and the
  consumer must fall back to synchronous transfers without losing a batch.
- ``proc.kill``         — FusedTrainStep.drive loop head (boolean site): the
  worker SIGKILLs itself, simulating an OOM-killer/node loss at step N; the
  supervisor restarts the group and auto_resume must replay bit-exactly.
- ``hb.write``          — launch.heartbeat.write, fired before the heartbeat
  file is written: heartbeating is best-effort, so the write must fail
  WITHOUT crashing training (write() returns False).
- ``train.stall``       — FusedTrainStep.drive fetch point (boolean site):
  the step blocks as if a collective wedged; FLAGS_step_timeout_s surfaces
  it as TrainStallError (or, with the in-process guard off, the launcher's
  heartbeat watchdog kills + restarts the group).
- ``train.spike``       — FusedTrainStep input poisoning (boolean site):
  the step's first floating-point input is scaled by 1e3, so loss/grads go
  finite-but-huge — the NaN guard stays silent and the divergence sentinel
  (FLAGS_sentinel_action) must detect the spike at the next metric-fetch
  window boundary and warn/skip/rollback/raise.
- ``serve.replica_crash`` — fleet replica worker loop head (boolean site):
  the replica SIGKILLs itself mid-serve; the ReplicaSupervisor must see
  the death, respawn under the restart budget, and the Router must replay
  the replica's in-flight requests bit-exactly on a healthy peer.
- ``serve.replica_hang``  — fleet replica worker loop head (boolean site):
  the replica wedges forever WITHOUT heartbeating; only the supervisor's
  hang watchdog (SIGTERM→SIGKILL escalation) can end it — the redispatch
  dedup must also survive the window where the replica is presumed dead.
- ``serve.dispatch``      — Router placement, fired as a request is sent
  to a replica: the dispatch fails, the request requeues at the front
  with a bumped generation, and a half-delivered copy can never
  double-emit into the replayed stream.
- ``io.stream.open``      — StreamingDataset shard open, fired before the
  file handle is acquired: transient failures ride the shared retry/
  backoff budget; exhaustion surfaces as typed StreamReadError.
- ``io.stream.read``      — StreamingDataset frame read, fired before
  each positioned read (the retry re-seeks, so a flaky read can never
  skew the record framing); exhaustion surfaces as StreamReadError.
- ``io.stream.corrupt``   — StreamingDataset record decode: the record
  is treated as corrupt and must be QUARANTINED (skipped under the
  per-epoch skip budget, counted in io_records_quarantined_total) —
  never retried, never silently dropped past the budget.
- ``serve.prefill_crash`` — disaggregated prefill worker, fired between
  KV-page frame emissions (boolean site): the worker SIGKILLs itself
  MID-TRANSFER — the router must discard the partial pages atomically
  and re-drive the prefill on a healthy prefill worker
  (fleet_handoff_failovers_total), with decode streams of other
  requests never hiccuping.
- ``serve.kv_transfer_corrupt`` — disaggregated prefill worker, fired
  per KV-page frame (boolean site): the frame's payload bytes are
  corrupted AFTER its CRC was computed, so the router's CRC check must
  catch the mismatch and re-drive the prefill under the transfer retry
  budget (fleet_kv_transfer_retries_total) instead of decoding on
  garbage; past the budget the request fails with a typed
  KVTransferError.
- ``serve.kv_spill`` — HostKVTier spill capture, fired as a cold page
  set (preempted request or reclaimed prefix block) is snapshotted for
  the host-RAM tier: spilling is an *optimisation*, so the failure must
  degrade to plain recompute-eviction (the request re-prefills on
  re-admission; the block identity is simply forgotten) — never crash
  the engine, never leave a half-registered host entry.
- ``serve.store_write`` — persistent prefix-store save, fired after the
  CRC-framed shard payload hits the tmp file but before the atomic
  rename (the "killed mid-store-write" window): a previously published
  store must stay intact byte-for-byte and a torn shard must never
  become visible; boot after the failure recovers warm from the old
  store or cold-starts cleanly.
- ``serve.tenant_flood`` — Router admission, fired per submit: the fleet
  behaves as if a tenant flood has saturated the queue, so the submit is
  shed with a typed FleetOverloadedError carrying a machine-readable
  ``retry_after_s`` hint — well-behaved clients back off instead of
  hammering an overloaded fleet.
- ``serve.scale_down_kill`` — Router autoscale tick (boolean site), fired
  as a scale-down decision starts draining the victim replica: the
  replica is SIGKILLed MID-DRAIN, so its still-queued requests must ride
  the normal crash-redispatch path to healthy peers — scale-down remains
  zero-drop even when the retiring replica dies uncleanly.
- ``serve.group_member_crash`` — replica-group worker loop (boolean
  site), armed on ONE member rank of a multi-process replica group:
  that rank SIGKILLs itself mid-burst, the partial-group failure shape.
  The supervisor must fell the WHOLE group (survivors SIGTERM→SIGKILL —
  a half-dead tp group must never answer), charge one restart-budget
  slot, respawn the group on a fresh coordination port and redispatch
  its in-flight requests bit-exact.
- ``serve.group_member_hang`` — replica-group worker loop (boolean
  site), armed on ONE member rank: the rank wedges without
  heartbeating, so the group's next collective stalls EVERY member. No
  process exits — only the hang watchdog (any member's stale
  ``hb.<replica>.<rank>``) can detect it and fell the group.
- ``serve.bit_flip`` — replica worker loop (boolean site):
  injects SILENT data corruption (``integrity.flip_bit``) into a KV
  pool page, a host-tier entry, or a weight buffer
  (``CHAOS_SERVE_BIT_FLIP_TARGET`` picks which). Nothing crashes and
  nothing raises — only the integrity sentinel (page CRCs, the sampled
  output audit, the weight re-audit) can catch it.

Arming a site is scoped and seeded::

    with inject("ckpt.shard_write"):            # every call raises
        ...
    with inject("io.save", max_fires=1, exc=OSError):  # first call only
        ...
    with inject("train.grad_nan", every_n=3):   # calls 3, 6, 9, ...
        ...
    with inject("fs.rename", prob=0.5, seed=7): # seeded coin per call
        ...

Sites are process-global (checkpoint writes run on background threads and
must see the armed injector); nesting the same site restores the previous
injector on exit.
"""

from __future__ import annotations

import contextlib
import random

__all__ = ["SITES", "InjectedFault", "inject", "fire", "should_fire"]

SITES = ("ckpt.shard_write", "io.save", "train.grad_nan", "fs.rename",
         "io.prefetch", "proc.kill", "hb.write", "train.stall",
         "train.spike", "serve.replica_crash", "serve.replica_hang",
         "serve.dispatch", "io.stream.open", "io.stream.read",
         "io.stream.corrupt", "serve.prefill_crash",
         "serve.kv_transfer_corrupt", "serve.kv_spill",
         "serve.store_write", "serve.tenant_flood",
         "serve.scale_down_kill", "serve.group_member_crash",
         "serve.group_member_hang", "serve.bit_flip")


class InjectedFault(OSError):
    """Default injected exception. Subclasses OSError on purpose: the
    durability layer treats OSErrors as transient and retries them, so an
    armed site exercises the full backoff path before the failure wins."""


class _Injector:
    __slots__ = ("site", "every_n", "prob", "exc", "max_fires", "_rng",
                 "calls", "fires")

    def __init__(self, site, every_n=None, prob=None, exc=None, seed=0,
                 max_fires=None):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; known: {SITES}")
        if every_n is not None and prob is not None:
            raise ValueError("pass at most one of every_n / prob")
        if every_n is not None and every_n < 1:
            raise ValueError("every_n must be >= 1")
        self.site = site
        self.every_n = every_n
        self.prob = prob
        self.exc = exc
        self.max_fires = max_fires
        self._rng = random.Random(seed)
        self.calls = 0
        self.fires = 0

    def should_fire(self):
        self.calls += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.prob is not None:
            hit = self._rng.random() < self.prob
        elif self.every_n is not None:
            hit = self.calls % self.every_n == 0
        else:
            hit = True  # armed with no rate: every call fires
        if hit:
            self.fires += 1
        return hit

    def make_exc(self):
        exc = self.exc
        if exc is None:
            return InjectedFault(f"injected fault at site {self.site!r} "
                                 f"(call #{self.calls})")
        if isinstance(exc, BaseException):
            return exc
        return exc(f"injected fault at site {self.site!r} "
                   f"(call #{self.calls})")


_ACTIVE: dict[str, _Injector] = {}


@contextlib.contextmanager
def inject(site, every_n=None, prob=None, exc=None, seed=0, max_fires=None):
    """Arm ``site`` for the duration of the block. Exactly one of
    ``every_n`` (fire on calls n, 2n, ...) or ``prob`` (seeded Bernoulli per
    call) selects the rate; neither means every call fires. ``max_fires``
    caps total fires (e.g. ``max_fires=1`` = one transient failure, then
    healthy — the retry path must recover). ``exc`` is an exception class or
    instance for raising sites; boolean sites (``train.grad_nan``) ignore it.
    Yields the injector, whose ``calls``/``fires`` counters are readable
    after the block."""
    inj = _Injector(site, every_n=every_n, prob=prob, exc=exc, seed=seed,
                    max_fires=max_fires)
    prev = _ACTIVE.get(site)
    _ACTIVE[site] = inj
    try:
        yield inj
    finally:
        if prev is None:
            _ACTIVE.pop(site, None)
        else:
            _ACTIVE[site] = prev


def should_fire(site):
    """Boolean probe for non-raising sites (``train.grad_nan``). False when
    the site is unarmed — the production fast path is one dict lookup."""
    inj = _ACTIVE.get(site)
    return inj is not None and inj.should_fire()


def fire(site):
    """Raising probe for write-path sites: no-op when unarmed, raises the
    armed exception when the injector decides this call fails."""
    inj = _ACTIVE.get(site)
    if inj is not None and inj.should_fire():
        raise inj.make_exc()
