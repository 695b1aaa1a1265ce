"""Fleet front-end router (counterpart of
``paddle_tpu/inference/serving/fleet/router.py``).

``Router`` dispatches requests over the replicas a
:class:`~.supervisor.ReplicaSupervisor` keeps alive:

* **Least-loaded placement** scored from router-tracked in-flight counts
  plus each replica's self-reported load gauges (KV-block utilization
  and decode occupancy), with **session affinity**: requests carrying the
  same ``session`` key prefer the replica that served the session last,
  so a prefix-cached replica keeps its warm blocks hot.
* **Deadlines**: every request may carry ``deadline_s``; expiry is checked
  at admission (an already-expired request is rejected with a typed
  :class:`~..errors.RequestTimeoutError` before anything is queued) and
  at every router tick for queued and placed requests (placed expiries
  also cancel on the replica, freeing its blocks).
* **Load shedding**: the admission queue is bounded (``max_queue``); a
  full queue sheds with a typed :class:`~..errors.FleetOverloadedError`.
* **Redispatch**: when a replica dies (crash or hang, as the supervisor
  reports), its in-flight requests are replayed on a healthy replica
  from their prompt plus the tokens already emitted (greedy decode is
  deterministic, so in fp32 the resumed stream is bit-identical). Token
  events carry the dispatch generation and source replica; emissions
  from a superseded assignment are dropped, so a slow-but-alive replica
  can never double-emit into a redispatched stream.
* **Graceful drain**: ``drain(i)`` stops admission to a replica, lets its
  in-flight requests finish, then runs ``then=``: ``"resume"``,
  ``"reload"`` (hot weight swap through the worker's ``reload_weights``)
  or ``"retire"``, for zero-drop rolling weight updates.

**Disaggregated prefill/decode** (``roles=`` on the fleet): requests on a
split fleet place in two stages. A prefill worker computes the prompt's
KV pages and streams them back as CRC-framed ``kvpage`` events and a
``kvdone`` carrying the first sampled token; the router ships the
verified pages to a decode worker (session affinity pins there, where
the prefix cache lives), which imports them and decodes with no prefill.
Every handoff is fenced by a handoff id (a zombie prefill worker cannot
double-deliver); a corrupt frame voids the whole transfer and re-drives
the prefill under a bounded retry budget (a typed
:class:`~..errors.KVTransferError` past it); a prefill worker dying
mid-transfer discards its partial pages and fails over to a healthy peer;
decode-worker death rides the replay (deadline unchanged); a stalled
transfer channel pauses new prefills, so the bounded queue sheds; a
fleet with no healthy prefill worker degrades to colocated prefill on
the decode side, with one warning.

**Multi-tenant QoS**: requests may carry ``tenant=`` and ``tier=``
(latency | batch). A tenant declared through :meth:`Router.configure_tenant`
gets a hard leaky-bucket admission quota at the router (token demand
charged at submit; over it, a typed
:class:`~..errors.TenantQuotaExceededError` with ``retry_after_s``), and
its envelope is pushed to every replica engine (again to respawns and
autoscaled newcomers). ``slo_admission=True`` rejects a request whose
deadline is smaller than the estimated queue wait plus prefill cost (the
TTFT EMA) with a typed :class:`~..errors.DeadlineInfeasibleError`.
``enable_autoscale`` turns on the supervisor's autoscale tick inside
:meth:`step`: scale-up spawns a replica, scale-down rides :meth:`drain`
(``then="retire"``). All of it is off by default.

**Serving integrity**: ``audit_fraction=p`` replays a deterministic
sample of completed requests on a different replica as batch-tier
background work and compares the token streams bit for bit. A mismatch
triggers a third-replica referee replay that votes out the corrupt
side; confirmed corruption (and repeated unrefereed disagreement, and
failed weight audits the replicas report) charges a per-replica
leaky-bucket suspicion score whose overflow quarantines the replica:
killed without grace, out of placement, restarted under one
restart-budget slot, its in-flight requests redispatched. Off by default.

The router is single-threaded: all state mutates inside :meth:`step`
(the pump), as in ``LLMEngine.step``. ``submit`` + ``join``/``step`` +
``result`` is the whole client API. Model-parallel replica groups:
``group_size > 1`` makes every slot a multi-process group serving one
plan-sharded engine, ``plan`` is the JSON plan spec (``{"axes": {"tp":
2}, "strategies": ["tp"]}``) every member rebuilds over its group. The
router is group-blind: a group is one handle, placed by rank 0's load
like any other replica.
"""

from __future__ import annotations

import itertools
import os
import signal
import time
import warnings
from collections import deque

import numpy as np

from ....observability import metrics as _obs_metrics
from ....utils import fault_injection as _fi
from ..errors import (DeadlineInfeasibleError, EngineClosedError,
                      FleetOverloadedError, KVTransferError,
                      RequestTimeoutError, TenantQuotaExceededError)
from ..integrity import SuspicionScore, audit_sampled
from ..scheduler import TIER_BATCH, TIER_LATENCY, TenantQuota
from .framing import decode_frame, join_frames
from .supervisor import ReplicaSupervisor

__all__ = ["Router", "FleetRequest"]

_M_REDISPATCH = _obs_metrics.counter(
    "fleet_redispatches_total",
    "in-flight requests replayed on a healthy replica after their "
    "replica died (or a dispatch failed)")
_M_SHED = _obs_metrics.counter(
    "fleet_requests_shed_total",
    "requests rejected with FleetOverloadedError because the bounded "
    "admission queue was full")
_M_TIMEOUTS = _obs_metrics.counter(
    "fleet_deadline_expired_total",
    "requests finished with RequestTimeoutError by the router "
    "(admission-time rejections included)")
_G_QUEUE = _obs_metrics.gauge(
    "fleet_queue_depth", "requests waiting in the router's admission "
    "queue (bounded by max_queue)")
_G_DRAINING = _obs_metrics.gauge(
    "fleet_replicas_draining",
    "replicas currently draining (no new placements)")
# disaggregated prefill/decode handoff
_M_KV_PAGES = _obs_metrics.counter(
    "fleet_kv_pages_transferred_total",
    "CRC-valid KV-page frames received from prefill workers (corrupt "
    "frames are not counted — they void the whole handoff)")
_M_KV_RETRIES = _obs_metrics.counter(
    "fleet_kv_transfer_retries_total",
    "KV handoffs re-driven after a transient transfer failure (corrupt "
    "frame, failed delivery) — bounded by max_kv_retries, past which the "
    "request fails with a typed KVTransferError")
_M_HANDOFFS = _obs_metrics.counter(
    "fleet_prefill_handoffs_total",
    "completed prefill->decode KV-page handoffs (CRC-verified pages plus "
    "the first sampled token accepted by the router)")
_M_FAILOVERS = _obs_metrics.counter(
    "fleet_handoff_failovers_total",
    "handoffs abandoned because a worker died mid-transfer, with the "
    "prefill re-dispatched elsewhere (partial pages discarded "
    "atomically)")
# multi-tenant QoS front door
_M_QUOTA_REJECTED = _obs_metrics.counter(
    "fleet_quota_rejections_total",
    "requests rejected at submit with TenantQuotaExceededError because "
    "their tenant's leaky-bucket admission quota was exhausted")
_M_INFEASIBLE = _obs_metrics.counter(
    "fleet_deadline_infeasible_total",
    "requests rejected at submit by the SLO feasibility check "
    "(estimated queue wait + prefill cost already exceed the deadline "
    "budget)")
# serving integrity sentinel
_M_AUDITS = _obs_metrics.counter(
    "fleet_audits_total",
    "sampled output audits completed: a finished request replayed "
    "bit-for-bit on a DIFFERENT replica as batch-tier background work "
    "(greedy decode is deterministic, so any disagreement IS silent "
    "data corruption)")
_M_AUDIT_MISMATCH = _obs_metrics.counter(
    "fleet_audit_mismatches_total",
    "output audits whose replayed token stream disagreed with the "
    "served one; a third-replica referee replay majority-votes which "
    "side is corrupt")
_M_QUARANTINED = _obs_metrics.counter(
    "fleet_replicas_quarantined_total",
    "replicas force-restarted by the integrity sentinel after their "
    "leaky-bucket suspicion score crossed the quarantine threshold "
    "(drain of trust -> removal from placement -> one restart-budget "
    "slot)")

QUEUED, PREFILLING, PLACED, DONE, FAILED = (
    "queued", "prefilling", "placed", "done", "failed")


class _IdleBackoff:
    """Exponential idle backoff for the router's wait loops: ``idle()``
    sleeps the current delay and doubles it toward ``ceiling``; any
    progress ``reset()``\\ s it to ``floor``, so a busy fleet stays
    responsive while an idle one sleeps ~ceiling seconds a probe instead
    of burning a core."""

    __slots__ = ("floor", "ceiling", "_delay")

    def __init__(self, floor=0.0005, ceiling=0.05):
        self.floor = float(floor)
        self.ceiling = max(float(ceiling), float(floor))
        self._delay = self.floor

    def reset(self):
        self._delay = self.floor

    def idle(self):
        time.sleep(self._delay)
        self._delay = min(self.ceiling, self._delay * 2)


class FleetRequest:
    """Router-side record of one request: the original prompt/sampling
    (the redispatch replay source), emitted tokens so far, the absolute
    deadline, and the current assignment (replica + generation). On a
    role-split fleet it also carries the handoff state: ``hid`` (the
    handoff generation — stale frames from a zombie prefill worker are
    dropped by id), the frame buffer of an in-flight transfer, and the
    CRC-verified ``pages`` awaiting decode placement."""

    __slots__ = ("gid", "prompt", "max_new", "eos", "deadline", "session",
                 "state", "replica", "generation", "emitted", "error",
                 "finish_reason", "t_submit", "t_first", "t_done",
                 "redispatches", "hid", "kv_retries", "frames", "pages",
                 "tenant", "tier", "audit")

    def __init__(self, gid, prompt, max_new, eos, deadline, session,
                 tenant=None, tier=None):
        self.gid = gid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.eos = eos
        self.deadline = deadline
        self.session = session
        self.tenant = str(tenant) if tenant else "default"
        tier = tier or TIER_LATENCY
        if tier not in (TIER_LATENCY, TIER_BATCH):
            raise ValueError(f"unknown tier {tier!r}; expected "
                             f"{TIER_LATENCY!r} or {TIER_BATCH!r}")
        self.tier = tier
        self.state = QUEUED
        self.replica = None
        self.generation = 0
        self.emitted: list[int] = []
        self.error = None
        self.finish_reason = None
        self.t_submit = time.perf_counter()
        self.t_first = None
        self.t_done = None
        self.redispatches = 0
        self.hid = 0
        self.kv_retries = 0
        # in-flight transfer buffer: seq -> (raw chunk, encoded data,
        # declared crc) — the raw bytes feed the whole-payload CRC at
        # kvdone; the already-encoded+verified form forwards verbatim
        # to the decode worker (no re-encode, no re-CRC)
        self.frames: dict[int, tuple] = {}
        self.pages = None  # {"frames": [(data_b64, crc)], "crc", "count"}
        # integrity-sentinel replay metadata; None for
        # normal traffic. An audit request carries the gid it audits,
        # the served token stream it must reproduce, the replicas it
        # may NOT place on, and the verdict stage (audit | referee).
        self.audit = None

    @property
    def finished(self):
        return self.state in (DONE, FAILED)

    @property
    def remaining(self):
        return self.max_new - len(self.emitted)


class Router:
    """Fault-tolerant request dispatch over a replica fleet."""

    _ids = itertools.count(1)
    # session-affinity map bound (LRU eviction): affinity is a locality
    # hint, so forgetting a cold session costs one prefix re-prefill —
    # never correctness
    MAX_SESSIONS = 4096

    def __init__(self, supervisor=None, *, artifact=None, n_replicas=None,
                 engine_kwargs=None, ckpt_root=None, max_queue=64,
                 max_inflight_per_replica=None, session_affinity=True,
                 hang_timeout_s=0.0, max_restarts=3, log_dir=None,
                 env_extra=None, wait_ready=True, roles=None,
                 max_kv_retries=3, max_pending_handoffs=8,
                 idle_backoff=(0.0005, 0.05), slo_admission=False,
                 group_size=1, plan=None, audit_fraction=0.0):
        self._name = f"fleet#{next(Router._ids)}"
        engine_kwargs = dict(engine_kwargs or {})
        if supervisor is None:
            if artifact is None or n_replicas is None:
                raise ValueError("pass either a supervisor or "
                                 "artifact= + n_replicas=")
            # model-parallel replica groups: group_size > 1 makes every
            # slot a multi-process group; `plan` is its JSON spec
            config = {"artifact": artifact, "engine": engine_kwargs,
                      "ckpt_root": ckpt_root}
            if plan is not None:
                config["plan"] = plan
            supervisor = ReplicaSupervisor(
                n_replicas, config,
                hang_timeout_s=hang_timeout_s, max_restarts=max_restarts,
                log_dir=log_dir, env_extra=env_extra, instance=self._name,
                roles=roles, group_size=group_size)
            if wait_ready:
                try:
                    supervisor.wait_ready()
                except BaseException:
                    supervisor.shutdown()  # never leak worker processes
                    raise
        self.supervisor = supervisor
        self._ckpt_root = ckpt_root
        self.max_queue = int(max_queue)
        self.max_inflight_per_replica = int(
            max_inflight_per_replica
            or 2 * int(engine_kwargs.get("max_batch_size", 4) or 4))
        self.session_affinity = bool(session_affinity)
        # disaggregated handoff knobs: the transfer retry
        # budget (the utils.retry idiom — re-drive on transient failure,
        # typed KVTransferError past the budget) and the backpressure
        # bound on concurrently buffered handoffs (a stalled transfer
        # channel pauses NEW prefill placements; the bounded admission
        # queue then sheds with a typed error — never silent growth)
        self.max_kv_retries = int(max_kv_retries)
        self.max_pending_handoffs = int(max_pending_handoffs)
        # idle-backoff floor/ceiling for join/drain/stats wait loops
        self.idle_backoff = (float(idle_backoff[0]), float(idle_backoff[1]))
        self._degraded_warned = False
        self._reqs: dict[int, FleetRequest] = {}
        self._queue: deque[FleetRequest] = deque()
        self._inflight: dict[int, set] = {
            h.id: set() for h in supervisor.handles}
        self._load: dict[int, dict] = {}
        self._sessions: dict = {}
        self._draining: dict[int, dict] = {}
        self.drains_completed = 0
        self.reloads: list[tuple] = []  # (replica_id, checkpoint step)
        self._gids = itertools.count(1)
        self._closed = False
        # multi-tenant QoS: tenant envelopes declared via
        # configure_tenant — router-side hard quota + the config pushed
        # down to every replica incarnation (tracked per (id, inc) so
        # respawns and autoscaled newcomers get it too)
        self._tenants: dict[str, dict] = {}
        self._tenant_quota: dict[str, TenantQuota] = {}
        self._cfg_sent: set[tuple] = set()
        # SLO-aware admission: recent completion times feed the queue
        # drain-rate estimate (retry_after_s hints + feasibility); the
        # TTFT EMA estimates the prefill cost of a new request
        self.slo_admission = bool(slo_admission)
        self._done_times: deque[float] = deque(maxlen=256)
        self._ttft_ema = None
        # fleet autoscaling: armed by enable_autoscale, ticked in step()
        self._autoscale = None
        self.scale_ups = 0
        self.scale_downs = 0
        # serving integrity sentinel: a deterministic sample
        # of completed requests is replayed on a DIFFERENT replica as
        # batch-tier background work; mismatches escalate through a
        # third-replica referee into per-replica suspicion scores that
        # drive quarantine (drain from placement + forced restart)
        self.audit_fraction = float(audit_fraction)
        self._suspicion: dict[int, SuspicionScore] = {}
        self.audit_log: list[dict] = []
        for m in (_M_REDISPATCH, _M_SHED, _M_TIMEOUTS, _M_KV_PAGES,
                  _M_KV_RETRIES, _M_HANDOFFS, _M_FAILOVERS,
                  _M_QUOTA_REJECTED, _M_INFEASIBLE, _M_AUDITS,
                  _M_AUDIT_MISMATCH, _M_QUARANTINED):
            m.inc(0, instance=self._name)
        _G_QUEUE.set(0, instance=self._name)
        _G_DRAINING.set(0, instance=self._name)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new=32, eos=None, deadline_s=None,
               session=None, tenant=None, tier=None):
        """Admit a request; returns its fleet-wide id. Raises
        :class:`RequestTimeoutError` when the deadline is already spent,
        :class:`TenantQuotaExceededError` when the tenant's admission
        quota is exhausted, :class:`DeadlineInfeasibleError` when the
        SLO feasibility check (``slo_admission=True``) says the deadline
        cannot be met, and :class:`FleetOverloadedError` when the
        bounded queue is full — in every case NOTHING was queued or
        placed, and every load rejection carries a machine-readable
        ``retry_after_s``."""
        if self._closed:
            raise EngineClosedError(f"{self._name} is closed")
        deadline = (time.time() + float(deadline_s)
                    if deadline_s is not None else None)
        if deadline is not None and time.time() >= deadline:
            _M_TIMEOUTS.inc(instance=self._name)
            raise RequestTimeoutError(
                f"deadline_s={deadline_s} already expired at admission",
                deadline=deadline)
        req = FleetRequest(next(self._gids), prompt, max_new, eos,
                           deadline, session, tenant=tenant, tier=tier)
        try:
            # chaos hook: an armed tenant-flood site makes THIS submit
            # behave as if the fleet were drowning — the typed overload
            # path (retry_after_s included) fires without needing a real
            # thousand-request flood in the test
            _fi.fire("serve.tenant_flood")
        except Exception:
            _M_SHED.inc(instance=self._name)
            raise FleetOverloadedError(
                f"injected tenant flood: request from tenant "
                f"{req.tenant!r} shed",
                queue_depth=len(self._queue),
                retry_after_s=self._retry_after(len(self._queue) + 1))
        quota = self._tenant_quota.get(req.tenant)
        if quota is not None and not quota.admissible():
            _M_QUOTA_REJECTED.inc(instance=self._name)
            raise TenantQuotaExceededError(
                f"tenant {req.tenant!r} exhausted its admission quota; "
                "back off instead of hammering the router",
                tenant=req.tenant, retry_after_s=quota.retry_after())
        if (self.slo_admission and deadline_s is not None
                and req.tier == TIER_LATENCY):
            est = self._estimate_service_start()
            if est is not None and float(deadline_s) < est:
                _M_INFEASIBLE.inc(instance=self._name)
                raise DeadlineInfeasibleError(
                    f"deadline_s={deadline_s} cannot be met: estimated "
                    f"queue wait + prefill cost is {est:.3f}s; rejecting "
                    "at placement instead of expiring mid-decode",
                    deadline=deadline,
                    retry_after_s=max(0.05, est - float(deadline_s)))
        if len(self._queue) >= self.max_queue:
            _M_SHED.inc(instance=self._name)
            raise FleetOverloadedError(
                f"admission queue full ({self.max_queue} requests "
                "waiting); shedding instead of queuing unboundedly",
                queue_depth=len(self._queue),
                retry_after_s=self._retry_after(len(self._queue)))
        if quota is not None:
            # charge the bucket only once every rejection gate passed —
            # shed/infeasible requests must not burn quota
            quota.note(len(req.prompt) + req.max_new)
        self._reqs[req.gid] = req
        self._queue.append(req)
        _G_QUEUE.set(len(self._queue), instance=self._name)
        return req.gid

    # -- QoS estimation helpers -----------------------------------------------
    _RATE_WINDOW_S = 5.0

    def _drain_rate(self):
        """Recent completion rate (requests/s) over the rate window —
        the denominator of every retry_after_s hint."""
        now = time.time()
        n = sum(1 for t in self._done_times
                if now - t <= self._RATE_WINDOW_S)
        return n / self._RATE_WINDOW_S

    def _retry_after(self, n_ahead):
        """Seconds until ~``n_ahead`` queued requests should have
        drained at the observed completion rate (1.0s floor default
        when the rate is still unknown)."""
        rate = self._drain_rate()
        if rate <= 0.0:
            return 1.0
        return max(0.05, float(n_ahead) / rate)

    def _estimate_service_start(self):
        """Estimated submit→first-token latency for a request admitted
        NOW: queue wait at the observed drain rate plus the TTFT EMA.
        None (= admit; never guess-reject) before any completion
        history exists."""
        if self._ttft_ema is None:
            return None
        wait = 0.0
        rate = self._drain_rate()
        if rate > 0.0 and self._queue:
            wait = len(self._queue) / rate
        return wait + self._ttft_ema

    def _note_done(self, req):
        """Completion bookkeeping shared by every terminal transition:
        feeds the drain-rate window and the TTFT EMA."""
        if req.audit is not None:
            # background audit replays must not skew the SLO
            # estimators: their batch-tier latency is not what a
            # latency-tier admission decision should be priced on
            return
        self._done_times.append(time.time())
        if req.t_first is not None and req.t_submit is not None:
            dt = req.t_first - req.t_submit
            self._ttft_ema = (dt if self._ttft_ema is None
                              else 0.8 * self._ttft_ema + 0.2 * dt)

    # ------------------------------------------------------------------
    # sampled output audit + replica quarantine
    # ------------------------------------------------------------------
    AUDIT_DEADLINE_S = 120.0

    def _incarnation(self, replica_id):
        h = self._handle(replica_id)
        return h.incarnation if h is not None else None

    def _note_audit(self, req):
        """Terminal-transition hook of the integrity sentinel. A
        normally finished request that the deterministic sampler picks
        spawns a batch-tier replay of the same work on a DIFFERENT
        replica; a finished audit is compared against the served stream
        and escalates (referee replay -> suspicion charge ->
        quarantine) on mismatch. Greedy decode is bit-exact across
        replicas, so two honest replicas CANNOT disagree — a mismatch
        is, by the core invariant, silent data corruption."""
        if req.audit is not None:
            self._audit_finished(req)
            return
        if req.state != DONE or not req.emitted:
            return
        if sum(1 for h in self.supervisor.handles if not h.retired) < 2:
            return  # no second replica to disagree with
        if not audit_sampled(req.gid, self.audit_fraction):
            return
        self._spawn_audit(req.prompt, req.max_new, req.eos, req.tenant, {
            "of": req.gid, "stage": "audit",
            "expect": list(req.emitted),
            "exclude": ([req.replica] if req.replica is not None else []),
            "server": req.replica,
            "server_inc": (self._incarnation(req.replica)
                           if req.replica is not None else None),
            "auditor": None, "auditor_inc": None,
        })

    def _spawn_audit(self, prompt, max_new, eos, tenant, audit):
        """Enqueue one audit replay. Bypasses every admission gate
        (quota, shed, SLO): audits are the sentinel's own background
        work, not tenant traffic — but they DO carry a deadline, so an
        audit the fleet cannot run ends inconclusive instead of
        pinning its request record forever."""
        req = FleetRequest(next(self._gids), prompt, max_new, eos,
                           time.time() + self.AUDIT_DEADLINE_S, None,
                           tenant=tenant, tier=TIER_BATCH)
        req.audit = audit
        self._reqs[req.gid] = req
        self._queue.append(req)
        return req.gid

    def _audit_finished(self, req):
        """Verdict logic for a finished audit/referee replay."""
        audit = req.audit
        self._reqs.pop(req.gid, None)  # audits self-release
        of, stage = audit["of"], audit["stage"]
        auditor, expect = audit.get("auditor"), audit["expect"]
        got = list(req.emitted)
        if req.state != DONE:
            # the replay itself failed (deadline, replica error):
            # inconclusive — never charge anyone for an audit the
            # fleet failed to run
            self.audit_log.append({"of": of, "stage": stage,
                                   "verdict": "inconclusive",
                                   "auditor": auditor})
            return
        server = audit.get("server")
        if stage == "audit":
            _M_AUDITS.inc(instance=self._name)
            if got == expect:
                self.audit_log.append({"of": of, "stage": stage,
                                       "verdict": "match",
                                       "auditor": auditor})
                return
            _M_AUDIT_MISMATCH.inc(instance=self._name)
            self.audit_log.append({"of": of, "stage": stage,
                                   "verdict": "mismatch",
                                   "auditor": auditor, "server": server})
            warnings.warn(
                f"{self._name}: output audit mismatch on request {of}: "
                f"replica {server} served a stream replica {auditor} "
                "could not reproduce — one of them is corrupt",
                RuntimeWarning)
            exclude = [x for x in (server, auditor) if x is not None]
            if self._audit_candidates(exclude):
                # referee replay on a THIRD replica majority-votes the
                # corrupt side
                self._spawn_audit(req.prompt, req.max_new, req.eos,
                                  req.tenant, {
                    "of": of, "stage": "referee",
                    "expect": expect, "exclude": exclude,
                    "server": server,
                    "server_inc": audit.get("server_inc"),
                    "auditor": None, "auditor_inc": None,
                    "auditor0": auditor,
                    "auditor0_inc": audit.get("auditor_inc"),
                    "audit_toks": got,
                })
            else:
                # no third replica: no majority possible — both
                # parties take one suspicion point, and whichever is
                # really corrupt keeps disagreeing until its bucket
                # overflows
                why = f"unrefereed audit mismatch on request {of}"
                self._charge_suspicion(server, 1, why,
                                       inc=audit.get("server_inc"))
                self._charge_suspicion(auditor, 1, why,
                                       inc=audit.get("auditor_inc"))
            return
        # stage == "referee": two of the three streams agree — the
        # odd one out is the corrupt replica (charged straight to the
        # quarantine threshold); three-way disagreement charges both
        # original parties one point each
        auditor0 = audit.get("auditor0")
        thr = SuspicionScore().threshold
        if got == expect:
            self.audit_log.append({"of": of, "stage": stage,
                                   "verdict": "auditor_corrupt",
                                   "corrupt": auditor0})
            self._charge_suspicion(
                auditor0, thr,
                f"referee confirmed replica {auditor0} corrupted the "
                f"audit replay of request {of}",
                inc=audit.get("auditor0_inc"))
        elif got == audit.get("audit_toks"):
            self.audit_log.append({"of": of, "stage": stage,
                                   "verdict": "server_corrupt",
                                   "corrupt": server})
            self._charge_suspicion(
                server, thr,
                f"referee confirmed replica {server} served a corrupt "
                f"stream for request {of}",
                inc=audit.get("server_inc"))
        else:
            self.audit_log.append({"of": of, "stage": stage,
                                   "verdict": "no_majority"})
            why = f"three-way audit disagreement on request {of}"
            self._charge_suspicion(server, 1, why,
                                   inc=audit.get("server_inc"))
            self._charge_suspicion(auditor0, 1, why,
                                   inc=audit.get("auditor0_inc"))

    def _charge_suspicion(self, replica_id, n, why, inc=None):
        """Charge ``n`` points against a replica's leaky-bucket
        suspicion score; crossing the threshold quarantines it. A
        charge whose evidence predates the replica's current
        incarnation is dropped — a restart already replaced the
        corrupt process, so old sins must not re-fell the fresh one."""
        if replica_id is None:
            return
        h = self._handle(replica_id)
        if h is None or h.retired:
            return
        if inc is not None and h.incarnation != inc:
            return
        s = self._suspicion.get(replica_id)
        if s is None:
            s = self._suspicion[replica_id] = SuspicionScore()
        if s.charge(n):
            self._quarantine(replica_id, why)

    def _quarantine(self, replica_id, why):
        """Remove a suspect replica from service NOW: the supervisor
        kills it (no grace — a corrupt replica must stop emitting),
        charges one restart-budget slot and schedules the respawn; its
        final events and in-flight requests ride the exact same
        recovery path as a crash, so every in-flight request is
        redispatched bit-exact on a healthy peer."""
        idx = next((i for i, h in enumerate(self.supervisor.handles)
                    if h.id == replica_id), None)
        if idx is None:
            return
        self._suspicion.pop(replica_id, None)
        death = self.supervisor.quarantine(idx)
        if death is None:
            return  # already retired or already pending respawn
        _M_QUARANTINED.inc(instance=self._name)
        warnings.warn(
            f"{self._name}: quarantining replica {replica_id}: {why}",
            RuntimeWarning)
        self.audit_log.append({"stage": "quarantine",
                               "replica": replica_id, "why": why})
        for ev in death["events"]:
            self._handle_event_from(death["replica"], ev)
        self._recover_replica(death["replica"])

    def _audit_candidates(self, exclude):
        return [h for h in self.supervisor.handles
                if self._role(h) != "prefill" and self._placeable(h)
                and h.id not in exclude]

    def _pick_audit_replica(self, req):
        return self._least_loaded(
            self._audit_candidates(req.audit["exclude"]))

    # -- tenant configuration -------------------------------------------------
    def configure_tenant(self, name, *, weight=1.0, rate_tokens_per_s=None,
                         window_s=1.0, host_blocks=None,
                         prefix_blocks=None):
        """Declare one tenant's QoS envelope fleet-wide: the router
        enforces a HARD admission quota (token demand — prompt +
        max_new — charged at submit against the leaky bucket; over it,
        submits raise :class:`TenantQuotaExceededError`), and the full
        envelope (weight, quota, cache shares) is pushed to every
        replica engine, where weighted-fair scheduling paces SERVED
        tokens. The push is tracked per replica incarnation, so respawns
        and autoscaled newcomers are configured automatically at the
        next :meth:`step`."""
        name = str(name)
        if not name:
            raise ValueError("tenant name must be non-empty")
        cfg = {"weight": float(weight), "window": float(window_s)}
        if rate_tokens_per_s is not None:
            cfg["rate"] = float(rate_tokens_per_s)
            self._tenant_quota[name] = TenantQuota(
                float(rate_tokens_per_s), window_s=float(window_s))
        else:
            self._tenant_quota.pop(name, None)
        if host_blocks is not None:
            cfg["host_blocks"] = int(host_blocks)
        if prefix_blocks is not None:
            cfg["prefix_blocks"] = int(prefix_blocks)
        self._tenants[name] = cfg
        # force a full re-push: config is idempotent on the replica side
        self._cfg_sent.clear()

    def _push_tenant_config(self):
        """Send the declared tenant envelopes to every live replica
        incarnation that has not received them yet (fresh boots,
        respawns after a crash, autoscaled newcomers)."""
        for h in self.supervisor.handles:
            if not (h.ready and h.alive and not h.retired):
                continue
            key = (h.id, h.incarnation)
            if key in self._cfg_sent:
                continue
            ok = True
            for name, cfg in self._tenants.items():
                ok = h.send({"op": "configure_tenant", "tenant": name,
                             **cfg}) and ok
            if ok:
                self._cfg_sent.add(key)

    # -- fleet autoscaling ----------------------------------------------------
    def enable_autoscale(self, min_replicas, max_replicas, **kw):
        """Arm the supervisor's autoscale tick inside :meth:`step`:
        queue pressure grows the fleet one replica at a time, calm
        shrinks it by draining the highest slot (``then="retire"`` — the
        zero-drop drain). ``kw`` forwards watermarks / cooldown /
        scale-event budget to :meth:`ReplicaSupervisor.autoscale`;
        disable again with :meth:`disable_autoscale`."""
        min_replicas, max_replicas = int(min_replicas), int(max_replicas)
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min ({min_replicas}) <= max ({max_replicas})")
        self._autoscale = {"min": min_replicas, "max": max_replicas,
                           "kw": dict(kw)}

    def disable_autoscale(self):
        self._autoscale = None

    def _mean_occupancy(self):
        """Mean decode-slot occupancy over live replicas' self-reported
        load gauges (replicas that never reported count as 0 — a booting
        replica is idle capacity, and treating it as busy would wedge
        scale-down forever)."""
        occ, n = 0.0, 0
        for h in self.supervisor.handles:
            if h.retired:
                continue
            n += 1
            occ += float(self._load.get(h.id, {}).get("occ", 0.0))
        return occ / n if n else 0.0

    def _autoscale_tick(self):
        cfg = self._autoscale
        decision = self.supervisor.autoscale(
            cfg["min"], cfg["max"], queue_depth=len(self._queue),
            occupancy=self._mean_occupancy(), **cfg["kw"])
        if decision is None:
            return
        action, rid = decision
        if action == "up":
            # the supervisor already spawned it — give it an in-flight
            # set so placement/recovery bookkeeping treats it as any
            # other slot (tenant config follows via _push_tenant_config)
            self._inflight.setdefault(rid, set())
            self.scale_ups += 1
            return
        # scale-down: zero-drop by construction — drain first, retire
        # only once the slot's in-flight set empties
        if rid in self._draining:
            return
        self.scale_downs += 1
        self.drain(rid, then="retire")
        try:
            # chaos hook (serve.scale_down_kill): SIGKILL the draining
            # replica mid-drain — its in-flight requests must redispatch
            # and still drop zero requests
            _fi.fire("serve.scale_down_kill")
        except Exception:
            h = self._handle(rid)
            if h is not None and h.proc.poll() is None:
                os.kill(h.pid, signal.SIGKILL)

    def request(self, gid):
        return self._reqs[gid]

    def tokens(self, gid):
        """Tokens emitted so far (partial results survive a stored
        error — a deadline-killed stream keeps what it produced)."""
        return list(self._reqs[gid].emitted)

    def result(self, gid):
        """Full prompt+generated array for a DONE request; re-raises the
        stored typed error for a FAILED one."""
        req = self._reqs[gid]
        if req.error is not None:
            raise req.error
        if req.state != DONE:
            raise RuntimeError(f"request {gid} is {req.state}")
        return np.concatenate(
            [req.prompt, np.asarray(req.emitted, np.int32)])

    def release(self, gid):
        req = self._reqs.get(gid)
        if req is not None and not req.finished:
            raise ValueError(f"request {gid} is {req.state}; only "
                             "finished requests can be released")
        self._reqs.pop(gid, None)

    def pending(self):
        return [r.gid for r in self._reqs.values() if not r.finished]

    def inflight(self, replica_id):
        """Request ids currently assigned to ``replica_id`` (the chaos
        drill picks its SIGKILL victim by load)."""
        return sorted(self._inflight.get(replica_id, ()))

    def join(self, timeout=None, poll_s=None):
        """Pump :meth:`step` until every submitted request finished.
        Idle ticks back off exponentially (``idle_backoff``
        floor→ceiling) instead of busy-polling — an idle fleet sleeps,
        it does not burn a core. ``poll_s`` (legacy) pins a fixed poll
        interval instead."""
        deadline = (time.time() + float(timeout)
                    if timeout is not None else None)
        backoff = (_IdleBackoff(poll_s, poll_s) if poll_s is not None
                   else _IdleBackoff(*self.idle_backoff))
        while self.pending():
            progressed = self.step()
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    f"fleet join timed out with {len(self.pending())} "
                    "requests unfinished")
            if progressed:
                backoff.reset()
            else:
                backoff.idle()

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------
    def step(self):
        """One router tick: consume replica events, recover deaths
        (redispatch), enforce deadlines, place queued requests, advance
        drains. Returns the number of events processed + placements made
        (0 = nothing to do right now)."""
        if self._closed:
            raise EngineClosedError(f"{self._name} is closed")
        progressed = 0
        # 1. replica events (tokens, loads, ready/reloaded acks)
        for h in list(self.supervisor.handles):
            for ev in h.events():
                progressed += 1
                self._handle_event(h, ev)
        # 2. supervision: deaths drain their final events first, then
        #    their in-flight requests are replayed elsewhere
        for death in self.supervisor.check():
            progressed += 1
            for ev in death["events"]:
                self._handle_event_from(death["replica"], ev)
            self._recover_replica(death["replica"])
        # 3. deadlines (queued + placed)
        self._expire_deadlines()
        # 3b. QoS config push + autoscale tick — both no-ops
        #     unless armed
        if self._tenants:
            self._push_tenant_config()
        if self._autoscale is not None:
            self._autoscale_tick()
        # 4. placement
        progressed += self._place()
        # 5. drains
        self._advance_drains()
        _G_QUEUE.set(len(self._queue), instance=self._name)
        _G_DRAINING.set(len(self._draining), instance=self._name)
        return progressed

    # -- events ----------------------------------------------------------
    def _handle_event(self, handle, ev):
        self._handle_event_from(handle.id, ev)

    def _handle_event_from(self, replica_id, ev):
        kind = ev.get("e")
        if kind == "tok":
            req = self._reqs.get(ev.get("gid"))
            if req is None or req.finished:
                return
            # dedup contract: accept only the CURRENT assignment — same
            # replica AND same dispatch generation. A slow-but-alive
            # replica still emitting a superseded copy is ignored.
            if (req.state != PLACED or req.replica != replica_id
                    or ev.get("gen") != req.generation):
                return
            # first tokens from the decode worker ack the handed-off
            # pages arrived intact — the router's buffered copy can go
            # and the transfer retry budget re-arms (NOT at kvdone: a
            # decode side that keeps rejecting deliveries must still be
            # able to exhaust the budget into a typed KVTransferError)
            if ev.get("toks"):
                req.pages = None
                req.kv_retries = 0
            for tok in ev.get("toks", ()):
                if req.t_first is None:
                    req.t_first = time.perf_counter()
                req.emitted.append(int(tok))
            if ev.get("fin"):
                reason = ev.get("reason")
                self._inflight[replica_id].discard(req.gid)
                if reason == "timeout":
                    self._fail(req, RequestTimeoutError(
                        f"request {req.gid} hit its deadline mid-stream "
                        f"on replica {replica_id}", rid=req.gid,
                        deadline=req.deadline), reason)
                else:
                    req.state = DONE
                    req.finish_reason = reason
                    req.t_done = time.perf_counter()
                    self._note_done(req)
                    self._note_audit(req)
        elif kind == "kvpage":
            self._handle_kvpage(replica_id, ev)
        elif kind == "kvdone":
            self._handle_kvdone(replica_id, ev)
        elif kind == "load":
            self._load[replica_id] = ev
        elif kind == "err":
            req = self._reqs.get(ev.get("gid"))
            if req is not None and not req.finished:
                self._inflight[replica_id].discard(req.gid)
                if ev.get("kind") in ("KVTransferError",
                                      "KVIntegrityError"):
                    # the decode worker rejected the handed-off pages
                    # (corrupt/incomplete buffer, or the page CRCs
                    # failed verification at import): transient —
                    # re-drive the prefill under the transfer retry
                    # budget rather than ever decoding on garbage
                    self._kv_transfer_failed(
                        req, f"decode replica {replica_id} rejected the "
                             f"pages: {ev.get('msg')}")
                    return
                self._fail(req, RuntimeError(
                    f"replica {replica_id} rejected request {req.gid}: "
                    f"{ev.get('kind')}: {ev.get('msg')}"), "error")
        elif kind == "integrity":
            # a replica's periodic weight re-audit failed: its live
            # fingerprint drifted from the artifact's. The replica
            # reloads its own weights; the router charges one
            # suspicion point — repeated drift means the slot's
            # hardware cannot be trusted and quarantine restarts it
            self._charge_suspicion(
                replica_id, 1,
                f"weight fingerprint audit failed on replica "
                f"{replica_id} ({ev.get('kind')})",
                inc=self._incarnation(replica_id))
        elif kind == "reloaded":
            self.reloads.append((replica_id, ev.get("step")))
            d = self._draining.get(replica_id)
            if d is not None and d.get("state") == "reloading":
                d["reloaded_step"] = ev.get("step")
                self._finish_drain(replica_id)
        # "ready"/"stats"/"bye" need no router action (ready flips the
        # handle flag inside handle.events())

    def _fail(self, req, error, reason):
        req.state = FAILED
        req.error = error
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        req.frames = {}
        req.pages = None
        self._note_done(req)
        if isinstance(error, RequestTimeoutError):
            _M_TIMEOUTS.inc(instance=self._name)
        self._note_audit(req)

    # -- disaggregated KV-page handoff ----------------------------------------
    def _handoff_current(self, replica_id, ev):
        """The in-flight handoff this frame/done event belongs to, or
        None when it is stale: wrong state, wrong replica, or a
        superseded handoff id — a zombie prefill worker re-delivering
        pages for an already re-driven transfer is dropped by id, so it
        can never double-deliver into the replayed stream."""
        req = self._reqs.get(ev.get("gid"))
        if (req is None or req.finished or req.state != PREFILLING
                or req.replica != replica_id
                or ev.get("hid") != req.hid):
            return None
        return req

    def _handle_kvpage(self, replica_id, ev):
        req = self._handoff_current(replica_id, ev)
        if req is None:
            return
        chunk = decode_frame(ev)
        if chunk is None:
            # corrupt frame: the WHOLE handoff is void — the prefill is
            # re-driven rather than ever decoded-on-garbage
            self._kv_transfer_failed(
                req, f"corrupt page frame {ev.get('seq')} from replica "
                     f"{replica_id}")
            return
        # keep the raw bytes (whole-payload CRC at kvdone) beside the
        # already-encoded data+crc (verified: crc == crc32(chunk)),
        # which forward verbatim to the decode worker
        req.frames[int(ev.get("seq", 0))] = (chunk, ev.get("data"),
                                             ev.get("crc"))
        _M_KV_PAGES.inc(instance=self._name)

    def _handle_kvdone(self, replica_id, ev):
        req = self._handoff_current(replica_id, ev)
        if req is None:
            return
        self._inflight[replica_id].discard(req.gid)
        if ev.get("fin") and ev.get("first_tok") is None:
            # prefill-side typed end before a first token existed
            # (deadline expired inside the prefill worker)
            req.frames = {}
            reason = ev.get("reason") or "error"
            if reason == "timeout":
                self._fail(req, RequestTimeoutError(
                    f"request {req.gid} hit its deadline during prefill "
                    f"on replica {replica_id}", rid=req.gid,
                    deadline=req.deadline), reason)
            else:
                self._fail(req, RuntimeError(
                    f"request {req.gid} ended during prefill on replica "
                    f"{replica_id}: {reason}"), reason)
            return
        total = int(ev.get("frames", 0))
        frames, req.frames = req.frames, {}
        blob, why = join_frames({i: c for i, (c, _, _) in frames.items()},
                                total, ev.get("crc"))
        if why is not None:
            self._kv_transfer_failed(
                req, f"{why} (from replica {replica_id})")
            return
        tok = int(ev["first_tok"])
        if req.t_first is None:
            req.t_first = time.perf_counter()
        req.emitted.append(tok)
        _M_HANDOFFS.inc(instance=self._name)
        if ev.get("fin") or req.remaining <= 0:
            # the first token already finished the request: no decode
            # stage, no pages to ship
            req.state = DONE
            req.finish_reason = ev.get("reason") or "length"
            req.t_done = time.perf_counter()
            self._note_done(req)
            self._note_audit(req)
            return
        # stage 2 pending: verified pages queue (front — oldest work)
        # for decode placement. Only the already-encoded frames are
        # kept — they forward verbatim, no re-encode.
        req.pages = {"frames": [(frames[i][1], frames[i][2])
                                for i in range(total)],
                     "crc": int(ev.get("crc", 0)), "count": total}
        req.state = QUEUED
        req.replica = None
        self._queue.appendleft(req)

    def _kv_transfer_failed(self, req, why, failover=False):
        """Void a handoff atomically — partial frames and buffered pages
        dropped, handoff id bumped so a zombie's stale deliveries miss —
        and re-drive the prefill elsewhere. Transient failures (corrupt
        frames, rejected deliveries) charge the transfer retry budget
        and fail with a typed :class:`KVTransferError` past it; worker
        deaths (``failover=True``) are counted as handoff failovers and
        governed by the supervisor's restart budget instead. The next
        prefill dispatch assigns a fresh handoff id; until then the
        QUEUED state alone fences stale deliveries."""
        req.frames = {}
        req.pages = None
        if req.state == PREFILLING and req.replica is not None:
            self._inflight.get(req.replica, set()).discard(req.gid)
        if failover:
            _M_FAILOVERS.inc(instance=self._name)
            _M_REDISPATCH.inc(instance=self._name)
            req.redispatches += 1
        else:
            req.kv_retries += 1
            if req.kv_retries > self.max_kv_retries:
                self._fail(req, KVTransferError(
                    f"request {req.gid}: KV-page handoff failed "
                    f"({why}); transfer retry budget "
                    f"({self.max_kv_retries}) exhausted",
                    gid=req.gid, retries=req.kv_retries), "kv_transfer")
                return
            _M_KV_RETRIES.inc(instance=self._name)
        req.state = QUEUED
        req.replica = None
        self._queue.appendleft(req)

    # -- death recovery --------------------------------------------------
    def _recover_replica(self, replica_id):
        """Requeue (at the FRONT, preserving age order) every in-flight
        request of a dead replica for replay elsewhere. The replay
        prompt is prompt + emitted-so-far; greedy determinism makes the
        resumed stream bit-identical to an undisturbed one. A handoff
        the dead replica was mid-transfer on is discarded atomically and
        the prefill re-driven (counted as a handoff failover)."""
        gids = sorted(self._inflight.get(replica_id, ()))
        self._inflight[replica_id] = set()
        self._load.pop(replica_id, None)
        # a dying replica cancels any drain it was serving
        self._draining.pop(replica_id, None)
        # session pins at the dead replica are stale either way: the
        # respawn rejoins with a COLD prefix cache, so steering the next
        # session request at the slot buys nothing and used to aim at a
        # corpse during the restart window
        if self._sessions:
            self._sessions = {k: v for k, v in self._sessions.items()
                              if v != replica_id}
        for gid in reversed(gids):
            req = self._reqs.get(gid)
            if req is None or req.finished:
                continue
            if req.state == PREFILLING:
                # prefill worker died mid-transfer: partial pages are
                # dropped atomically, the prefill re-drives elsewhere —
                # decode streams of other requests never hiccup
                self._kv_transfer_failed(
                    req, f"prefill replica {replica_id} died "
                         "mid-transfer", failover=True)
                continue
            if req.audit is not None:
                # clean-room replay: an audit must be served start to
                # finish by ONE replica, or mismatch attribution is
                # meaningless — discard partial tokens, replay whole
                req.emitted = []
            if req.remaining <= 0:
                # everything was emitted; only the fin event was lost
                req.state = DONE
                req.finish_reason = "length"
                req.t_done = time.perf_counter()
                self._note_done(req)
                self._note_audit(req)
                continue
            req.state = QUEUED
            req.replica = None
            req.redispatches += 1
            # emitted moved past the handed-off pages: the replay
            # re-drives prefill from prompt+emitted, not stale pages
            req.frames = {}
            req.pages = None
            self._queue.appendleft(req)
            _M_REDISPATCH.inc(instance=self._name)

    # -- deadlines -------------------------------------------------------
    def _expire_deadlines(self):
        now = time.time()
        for req in list(self._reqs.values()):
            if req.finished or req.deadline is None or now < req.deadline:
                continue
            if req.state == QUEUED:
                try:
                    self._queue.remove(req)
                except ValueError:
                    pass
            elif req.state in (PLACED, PREFILLING):
                # free the replica's blocks; its own engine-side deadline
                # check races with this cancel — both are idempotent.
                # A mid-transfer handoff's partial pages die with the
                # request (_fail drops frames + pages).
                h = self._handle(req.replica)
                if h is not None:
                    h.send({"op": "cancel", "gid": req.gid,
                            "reason": "timeout"})
                self._inflight[req.replica].discard(req.gid)
            self._fail(req, RequestTimeoutError(
                f"request {req.gid} deadline expired "
                f"({'queued' if req.state == QUEUED else 'in flight'})",
                rid=req.gid, deadline=req.deadline), "timeout")

    # -- placement -------------------------------------------------------
    def _handle(self, replica_id):
        for h in self.supervisor.handles:
            if h.id == replica_id:
                return h
        return None

    def _placeable(self, h):
        return (h.ready and h.alive and not h.retired
                and h.id not in self._draining
                and len(self._inflight[h.id])
                < self.max_inflight_per_replica)

    # -- roles: prefill workers take stage-1 work only ------------------------
    def _role(self, h):
        return getattr(h, "role", None) or "both"

    @property
    def split(self):
        """True when the fleet has dedicated prefill workers
        (role-disaggregated serving)."""
        return any(self._role(h) == "prefill"
                   for h in self.supervisor.handles)

    def _pending_handoffs(self):
        """Requests whose pages are buffered at the router (transfer in
        flight or awaiting decode placement) — the backpressure bound.
        Scans only the in-flight sets and the queue (both bounded), not
        the full request table: finished-but-unreleased requests on a
        long-lived server must not slow placement down."""
        n = 0
        for gids in self._inflight.values():
            for gid in gids:
                r = self._reqs.get(gid)
                if (r is not None and not r.finished
                        and (r.state == PREFILLING
                             or r.pages is not None)):
                    n += 1
        for r in self._queue:
            if r.pages is not None:
                n += 1
        return n

    def _least_loaded(self, candidates):
        best, best_score = None, None
        for h in candidates:
            load = self._load.get(h.id, {})
            score = (len(self._inflight[h.id]),
                     float(load.get("kv", 0.0))
                     + float(load.get("occ", 0.0)), h.id)
            if best_score is None or score < best_score:
                best, best_score = h, score
        return best

    def _pick_replica(self, req):
        """Decode-capable placement (any non-prefill role): session
        affinity first — the pin lives on the replica whose prefix
        cache is warm, i.e. the DECODE replica on a split fleet — then
        least-loaded."""
        if self.session_affinity and req.session is not None:
            rid = self._sessions.get(req.session)
            if rid is not None:
                h = self._handle(rid)
                if (h is not None and self._role(h) != "prefill"
                        and self._placeable(h)):
                    return h
        return self._least_loaded(
            h for h in self.supervisor.handles
            if self._role(h) != "prefill" and self._placeable(h))

    def _pick_prefill_replica(self):
        return self._least_loaded(
            h for h in self.supervisor.handles
            if self._role(h) == "prefill" and self._placeable(h))

    def _any_prefill_healthy(self):
        return any(h.alive and not h.retired
                   for h in self.supervisor.handles
                   if self._role(h) == "prefill")

    # -- dispatch helpers -----------------------------------------------
    def _replay_prompt(self, req):
        """Original prompt + everything already emitted — the greedy
        continuation from here is bit-identical."""
        return np.concatenate(
            [req.prompt, np.asarray(req.emitted, np.int32)]).tolist()

    def _send_checked(self, h, payload):
        try:
            _fi.fire("serve.dispatch")
        except Exception:
            return False
        return h.send(payload)

    def _dispatch_failed(self, req):
        """Requeue after a failed dispatch (dead pipe or injected
        fault): the bumped generation invalidates the half-delivered
        copy even if it arrived."""
        req.state = QUEUED
        req.replica = None
        req.redispatches += 1
        self._queue.appendleft(req)
        _M_REDISPATCH.inc(instance=self._name)

    def _note_session(self, req, h):
        if self.session_affinity and req.session is not None:
            # LRU-bounded: one entry per session key forever would
            # grow without bound on a long-lived server (the replica
            # worker bounds its gid bookkeeping the same way)
            self._sessions.pop(req.session, None)
            self._sessions[req.session] = h.id
            while len(self._sessions) > self.MAX_SESSIONS:
                self._sessions.pop(next(iter(self._sessions)))

    def _dispatch_submit(self, req, h):
        """Colocated dispatch: the replica prefills AND decodes."""
        self._queue.remove(req)
        req.generation += 1
        req.replica = h.id
        req.state = PLACED
        payload = {
            "op": "submit", "gid": req.gid, "gen": req.generation,
            "prompt": self._replay_prompt(req),
            "max_new": req.remaining, "eos": req.eos,
            "deadline": req.deadline, "tenant": req.tenant,
            "tier": req.tier,
        }
        if not self._send_checked(h, payload):
            self._dispatch_failed(req)
            return False
        self._inflight[h.id].add(req.gid)
        self._note_session(req, h)
        return True

    def _dispatch_prefill(self, req, h):
        """Stage 1: the prefill worker computes the pages and streams
        them back as CRC-framed kvpage events. A fresh handoff id fences
        the transfer — frames from any earlier assignment are void."""
        self._queue.remove(req)
        req.generation += 1
        req.hid += 1
        req.replica = h.id
        req.state = PREFILLING
        req.frames = {}
        payload = {
            "op": "prefill", "gid": req.gid, "gen": req.generation,
            "hid": req.hid, "prompt": self._replay_prompt(req),
            "max_new": req.remaining, "eos": req.eos,
            "deadline": req.deadline, "tenant": req.tenant,
            "tier": req.tier,
        }
        if not self._send_checked(h, payload):
            self._dispatch_failed(req)
            return False
        self._inflight[h.id].add(req.gid)
        return True

    def _dispatch_pages(self, req, h):
        """Stage 2: ship the CRC-verified pages down to the decode
        worker, then the submit that imports them. The decode prompt is
        prompt + emitted (exactly the prefill's first token at this
        point), the budget the remainder, and the deadline THE deadline
        — carried unchanged across the handoff."""
        self._queue.remove(req)
        req.generation += 1
        frames = req.pages["frames"]
        ok = True
        for seq, (data, crc) in enumerate(frames):
            # forwarded VERBATIM: the encoded form and CRC are the ones
            # the prefill worker produced and the router verified
            ok = h.send({"op": "kvpage", "gid": req.gid, "seq": seq,
                         "total": len(frames), "crc": crc, "data": data})
            if not ok:
                break
        if ok:
            ok = self._send_checked(h, {
                "op": "submit_pages", "gid": req.gid,
                "gen": req.generation,
                "prompt": self._replay_prompt(req),
                "max_new": req.remaining, "eos": req.eos,
                "deadline": req.deadline, "frames": len(frames),
                "crc": req.pages["crc"], "tenant": req.tenant,
                "tier": req.tier,
            })
        if not ok:
            # dead pipe: the verified pages stay buffered — the retry
            # ships the SAME pages to another decode replica next tick
            # (emitted has not advanced, so they are still exact)
            self._dispatch_failed(req)
            return False
        req.replica = h.id
        req.state = PLACED
        self._inflight[h.id].add(req.gid)
        self._note_session(req, h)
        return True

    def _place_stage2_behind_head(self):
        """Place pages-verified requests sitting BEHIND a
        backpressure-blocked stage-1 head. Stage-2 dispatch only ever
        DRAINS the transfer buffer, so letting it overtake cannot starve
        the head — it is what unblocks it. Without this, a stage-1
        replay requeued in front of a pages-ready request deadlocks the
        whole queue: the head waits on the pending-handoff count that
        only the request behind it can reduce."""
        placed = 0
        for req in [r for r in self._queue if r.pages is not None]:
            h = self._pick_replica(req)
            if h is None or not self._dispatch_pages(req, h):
                break
            placed += 1
        return placed

    def _place(self):
        placed = 0
        split = self.split
        deferred = []
        while self._queue:
            req = self._queue[0]
            if req.audit is not None:
                # integrity-audit replay: place on any decode-capable
                # replica NOT in the exclusion set (colocated even on
                # a split fleet — ONE replica must own the whole
                # replay or mismatch attribution is meaningless).
                # Unplaceable right now (every candidate excluded or
                # busy) -> defer past this tick: background audits
                # never wedge the head of the line for real traffic.
                h = self._pick_audit_replica(req)
                if h is None:
                    deferred.append(self._queue.popleft())
                    continue
                if not self._dispatch_submit(req, h):
                    break
                req.audit["auditor"] = h.id
                req.audit["auditor_inc"] = h.incarnation
                placed += 1
                continue
            if split and req.pages is not None:
                # stage 2: pages verified, awaiting a decode worker
                h = self._pick_replica(req)
                if h is None or not self._dispatch_pages(req, h):
                    break
                placed += 1
                continue
            if split:
                # stage 1: prefill placement. Backpressure: when the
                # transfer channel stalls (handoffs pile up buffered),
                # PAUSE new prefills — requests stay queued, and the
                # bounded admission queue sheds with a typed error
                # instead of growing silently.
                if self._pending_handoffs() >= self.max_pending_handoffs:
                    placed += self._place_stage2_behind_head()
                    break
                h = self._pick_prefill_replica()
                if h is None and not self._any_prefill_healthy():
                    # no healthy prefill worker at all: degrade
                    # gracefully to colocated prefill on the decode
                    # side, once-warned — serving beats stalling
                    h = self._pick_replica(req)
                    if h is None:
                        break
                    if not self._degraded_warned:
                        self._degraded_warned = True
                        warnings.warn(
                            f"{self._name}: no healthy prefill worker; "
                            "degrading to colocated prefill on decode "
                            "replicas until one rejoins",
                            RuntimeWarning)
                    if not self._dispatch_submit(req, h):
                        break
                    placed += 1
                    continue
                if h is None or not self._dispatch_prefill(req, h):
                    break
                placed += 1
                continue
            # colocated fleet
            h = self._pick_replica(req)
            if h is None or not self._dispatch_submit(req, h):
                # one retry per tick on a failed dispatch; if the pipe
                # is really dead the supervisor's next check() reports
                # the death and the replica leaves the placeable set
                break
            placed += 1
        if deferred:
            self._queue.extend(deferred)
        return placed

    # ------------------------------------------------------------------
    # graceful drain (part c)
    # ------------------------------------------------------------------
    def drain(self, replica_id, then="resume", ckpt_root=None, wait=False,
              timeout=120.0):
        """Stop placing requests on ``replica_id``; once its in-flight
        requests finish, run ``then``:

        * ``"resume"`` — just rejoin the placeable set;
        * ``"reload"`` — hot-swap weights from ``ckpt_root`` (default:
          the fleet's checkpoint root) via the worker's
          ``reload_weights``, then rejoin: the zero-drop rolling-update
          primitive;
        * ``"retire"`` — shut the replica down permanently.

        ``wait=True`` pumps :meth:`step` until the drain completes."""
        if then not in ("resume", "reload", "retire"):
            raise ValueError(f"unknown drain action {then!r}")
        if self._handle(replica_id) is None:
            raise ValueError(f"unknown replica {replica_id}")
        if then == "reload" and not (ckpt_root or self._ckpt_root):
            raise ValueError("drain(then='reload') needs ckpt_root= "
                             "(none configured on the fleet)")
        self._draining[replica_id] = {
            "state": "draining", "then": then,
            "root": ckpt_root or self._ckpt_root}
        _G_DRAINING.set(len(self._draining), instance=self._name)
        if wait:
            deadline = time.time() + float(timeout)
            backoff = _IdleBackoff(*self.idle_backoff)
            while replica_id in self._draining:
                if self.step():
                    backoff.reset()
                else:
                    backoff.idle()
                if time.time() > deadline:
                    raise TimeoutError(
                        f"drain of replica {replica_id} timed out")

    def _advance_drains(self):
        for rid, d in list(self._draining.items()):
            if d["state"] != "draining" or self._inflight.get(rid):
                continue
            if d["then"] == "retire":
                self.supervisor.retire(rid)
                self._finish_drain(rid)
            elif d["then"] == "reload":
                h = self._handle(rid)
                if h is None or not h.send({"op": "reload",
                                            "root": d["root"]}):
                    self._draining.pop(rid, None)  # died; recovery owns it
                else:
                    d["state"] = "reloading"
            else:  # resume
                self._finish_drain(rid)

    def _finish_drain(self, replica_id):
        self._draining.pop(replica_id, None)
        self.drains_completed += 1
        _G_DRAINING.set(len(self._draining), instance=self._name)

    # ------------------------------------------------------------------
    # introspection + teardown
    # ------------------------------------------------------------------
    def metrics(self):
        """Fleet-owned observability snapshot (the ``LLMEngine.metrics``
        discipline): registry-backed counters/gauges for THIS fleet."""
        inst = self._name
        from .supervisor import _G_LIVE, _M_RESTARTS

        # supervisor-owned series live under the SUPERVISOR's instance
        # label — identical to ours when we built it, but an injected
        # supervisor keeps its own name
        sup_inst = getattr(self.supervisor, "instance", inst)
        return {
            "instance": inst,
            "replicas_live": _G_LIVE.value(instance=sup_inst),
            "replica_restarts": int(_M_RESTARTS.value(instance=sup_inst)),
            "redispatches": int(_M_REDISPATCH.value(instance=inst)),
            "requests_shed": int(_M_SHED.value(instance=inst)),
            "deadline_expired": int(_M_TIMEOUTS.value(instance=inst)),
            "queue_depth": _G_QUEUE.value(instance=inst),
            "replicas_draining": _G_DRAINING.value(instance=inst),
            "drains_completed": self.drains_completed,
            # disaggregated handoff
            "kv_pages_transferred": int(_M_KV_PAGES.value(instance=inst)),
            "kv_transfer_retries": int(
                _M_KV_RETRIES.value(instance=inst)),
            "prefill_handoffs": int(_M_HANDOFFS.value(instance=inst)),
            "handoff_failovers": int(_M_FAILOVERS.value(instance=inst)),
            # multi-tenant QoS + autoscale
            "quota_rejections": int(
                _M_QUOTA_REJECTED.value(instance=inst)),
            "deadline_infeasible": int(
                _M_INFEASIBLE.value(instance=inst)),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            # serving integrity sentinel
            "audits_run": int(_M_AUDITS.value(instance=inst)),
            "audit_mismatches": int(
                _M_AUDIT_MISMATCH.value(instance=inst)),
            "replicas_quarantined": int(
                _M_QUARANTINED.value(instance=inst)),
        }

    def stats(self, timeout=10.0):
        """One-call fleet integrity/ops snapshot: the router's own
        :meth:`metrics` plus every live replica's synchronous ``stats``
        RPC (integrity counters included — pages verified/rejected,
        weight audits run/failed)."""
        out = {"fleet": self.metrics(), "replicas": {}}
        for h in self.supervisor.handles:
            if h.alive and not h.retired:
                out["replicas"][h.id] = self.replica_stats(
                    h.id, timeout=timeout)
        return out

    def ttft_seconds(self):
        """Per-request submit→first-token latencies (finished requests
        that produced at least one token) — the drill's p99 source."""
        return [r.t_first - r.t_submit for r in self._reqs.values()
                if r.t_first is not None]

    def reset_replica_metrics(self):
        """Ask every live replica to reset its engine-owned metric
        series (the bench window discipline: warm-phase latency
        observations must not pollute a timed window's percentiles)."""
        for h in self.supervisor.handles:
            if h.alive and not h.retired:
                h.send({"op": "reset_metrics"})

    def replica_stats(self, replica_id, timeout=10.0):
        """Synchronous ``stats`` RPC to one replica (allocator cleanliness
        assertions in drills/tests). Every non-stats event drained while
        waiting is routed through the normal pump — ``events()`` is
        destructive, so returning mid-batch would drop live tokens."""
        h = self._handle(replica_id)
        if h is None or not h.send({"op": "stats"}):
            return None
        deadline = time.time() + timeout
        backoff = _IdleBackoff(*self.idle_backoff)
        while time.time() < deadline:
            stats = None
            evs = h.events()
            for ev in evs:
                if ev.get("e") == "stats" and stats is None:
                    stats = ev
                else:
                    self._handle_event(h, ev)
            if stats is not None:
                return stats
            if evs:
                backoff.reset()
            else:
                backoff.idle()
        return None

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.supervisor.shutdown()
        for m in (_M_REDISPATCH, _M_SHED, _M_TIMEOUTS, _G_QUEUE,
                  _G_DRAINING, _M_KV_PAGES, _M_KV_RETRIES, _M_HANDOFFS,
                  _M_FAILOVERS, _M_QUOTA_REJECTED, _M_INFEASIBLE,
                  _M_AUDITS, _M_AUDIT_MISMATCH, _M_QUARANTINED):
            m.remove(instance=self._name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
