"""The serving front door: session affinity, admission control, load
shedding, and prefill-tier scaling over N decode replicas.

One batcher was the serving ceiling (ROADMAP item 2); the router makes
the decode tier horizontal.  It owns a prefill tier — one engine, or a
pool of :class:`~vtpu_torch.serving.disagg.PrefillEngine` replicas it scales
with load (prefill is throughput work — bursts queue here, never in a
decode engine's token cadence) — and N decode replicas, and drives the
handoff between them:

- **Session affinity**: sessions hash onto replicas via the SAME
  consistent-hash ring the sharded scheduler extender uses
  (:class:`vtpu_torch.scheduler.shard.HashRing`) — a drained replica only
  remaps its own sessions.  A session seen once is PINNED: all its
  requests land on the same replica (its K/V prefixes and transcript
  live there), until the session's replica is drained, at which point
  *new* sessions (and new sessions only) re-hash — in-flight sessions
  finish where they are.
- **Admission control**: each submit consults the target replica's
  live ``slots_active_ratio`` and queue depth (claimed handles waiting
  for slots + this router's prefill backlog bound for it).  A replica
  past ``max_backlog`` sheds with a typed :class:`RouterReject`
  (HTTP 429 semantics — the caller retries elsewhere/later; nothing
  is silently dropped).
- **Health**: replicas (decode AND prefill) answer ``ping()``.
  ``fail_threshold`` consecutive failures drain a replica — removed
  from the ring / submission rotation while in-flight work finishes —
  and a successful ping restores it; transitions land in the event
  journal (``ReplicaDrained`` / ``ReplicaRestored``) and the
  ``vtpu_router_*`` metric families (docs/observability.md).
- **Prefill scaling**: with more than one prefill replica, the router
  watches its own backlog ledger plus the decode tier's
  ``slots_active_ratio`` and drains/restores prefill replicas through
  the same machinery — a deep backlog (or decode slots starving while
  prefill work queues) restores a scaled-down replica; a drained
  backlog scales one down.  A scaled-down prefill finishes its queued
  work in place; only NEW submissions skip it.
- **Wire backpressure**: a decode replica reached over the wire
  transport (:class:`vtpu_torch.serving.transport.WireReplica`) whose pool
  cannot pre-lease a single destination block raises
  :class:`~vtpu_torch.serving.transport.ReplicaSaturatedError` at handoff.
  The router PARKS the finished prefill (the handle stays adoptable)
  and retries on later pumps — credit-based flow control propagates as
  admission backpressure, never as a decode-side OOM.

The port's copy of ``vtpu/serving/router.py`` (the port imports nothing
of vtpu).  It drives the port's ``PrefillEngine``/``DecodeEngine`` and
``WireReplica`` through the same duck-typed surface, and catches the
port's own ``KVHandoffError``, ``ReplicaSaturatedError`` and migration
errors: a JAX engine's exceptions reach it as plain exceptions (a
replica failure, not backpressure), so each package's Router serves its
own package's engines.  Its journal events, ``vtpu_router_*`` families
and ledger records are the port's (``vtpu_torch.obs``,
``vtpu_torch.serving.reqtrace``); it has no lock of its own.
``vtpu_torch/bench/serving_disagg.py`` measures it.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Dict, List, Optional

from vtpu_torch import obs
from vtpu_torch.obs.events import EventType, emit
from vtpu_torch.scheduler.shard import HashRing
from vtpu_torch.serving.kvpool import KVHandoffError
from vtpu_torch.serving.migrate import (
    MigrationError,
    SessionGoneError,
    SessionMover,
)
from vtpu_torch.serving.prefix import PrefixIndex, chain_digests
from vtpu_torch.serving.reqtrace import LEDGER
from vtpu_torch.serving.transport import ReplicaSaturatedError

log = logging.getLogger(__name__)

__all__ = ["Router", "RouterReject"]

_REG = obs.registry("serving")

_REQS_TOTAL = _REG.counter(
    "vtpu_router_requests_total",
    "Requests entering the front door by outcome (routed / shed)",
)
_SHED_TOTAL = _REG.counter(
    "vtpu_router_sheds_total",
    "Requests shed by the admission controller, by typed reason",
)
_HEALTHY_INFO = _REG.gauge(
    "vtpu_router_replica_healthy_info",
    "1 while the labelled decode replica is in the ring, 0 while drained",
)
_TRANSITIONS = _REG.counter(
    "vtpu_router_replica_transitions_total",
    "Replica transitions (to=drained / restored / prefill_drained / "
    "prefill_restored — the prefill forms cover both health drains and "
    "backlog-driven scaling)",
)
_BACKLOG = _REG.gauge(
    "vtpu_router_backlog_total",
    "Requests admitted but not yet adopted by a decode replica "
    "(prefill queue + in-flight handoffs), by replica",
)
_PREFILL_ACTIVE = _REG.gauge(
    "vtpu_router_prefill_active_total",
    "Prefill replicas currently accepting new submissions (healthy and "
    "not scaled down)",
)
_PINNED = _REG.gauge(
    "vtpu_router_sessions_pinned_total",
    "Sessions currently pinned to the labelled decode replica (session "
    "affinity); the session mover targets the least-pinned "
    "credit-holding healthy replica",
)


class RouterReject(Exception):
    """Typed load-shed rejection (HTTP 429 semantics).  ``reason`` is
    machine-readable; the request was NOT admitted and the caller may
    retry later or elsewhere."""

    status = 429

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(detail or reason)
        self.reason = reason


class Router:
    """Front door over a prefill tier and N decode replicas.

    ``prefill`` is one engine or a dict of prefill replica id → engine
    (the scalable tier); ``replicas`` maps replica id → decode engine
    (anything with ``submit_handle`` / ``step`` / ``stats`` / ``ping``).
    The caller drives :meth:`pump` (one cooperative round) or
    :meth:`drain` (run to completion)."""

    def __init__(
        self,
        prefill,
        replicas: Dict[str, object],
        *,
        max_backlog: Optional[int] = None,
        fail_threshold: int = 3,
        ping_interval_s: float = 0.0,
        prefill_scale_high: int = 8,
        prefill_scale_low: int = 2,
        prefill_min_active: int = 1,
        prefill_scale_cooldown: int = 2,
        clock=time.monotonic,
        migrate_on_drain: bool = True,
        mover: Optional[SessionMover] = None,
    ) -> None:
        if not replicas:
            raise ValueError("Router needs at least one decode replica")
        self.prefills: Dict[str, object] = (
            dict(prefill) if isinstance(prefill, dict)
            else {"p0": prefill}
        )
        if not self.prefills:
            raise ValueError("Router needs at least one prefill engine")
        self.replicas = dict(replicas)
        for pf in self.prefills.values():
            host = getattr(pf, "_host", None)
            if host is not None and (
                len(self.prefills) > 1
                or len(self.replicas) > 1
                or not any(eng is host for eng in self.replicas.values())
            ):
                # a shared-pool prefill writes straight into its host
                # decode engine's pool; no other replica can adopt those
                # handles (there is no source pool to copy from)
                raise ValueError(
                    "a shared-pool (co-located) prefill serves exactly "
                    "its host decode engine — construct the Router with "
                    "that single prefill + single replica, or give the "
                    "prefill its own pool for multi-replica topologies"
                )
        # shed when a replica's uncollected work (active slots + claimed
        # handles waiting + our own prefill backlog for it) reaches
        # max_batch + max_backlog; default backlog = 2× the largest
        # replica's slot count (an explicit 0 = shed the moment every
        # slot is taken)
        self.max_backlog = max_backlog if max_backlog is not None else (
            2 * max(int(r.stats().get("max_batch", 1))
                    for r in replicas.values())
        )
        self.fail_threshold = max(1, fail_threshold)
        self.ping_interval_s = ping_interval_s
        self.prefill_scale_high = max(1, prefill_scale_high)
        self.prefill_scale_low = max(0, prefill_scale_low)
        self.prefill_min_active = max(1, min(prefill_min_active,
                                             len(self.prefills)))
        self.prefill_scale_cooldown = max(0, prefill_scale_cooldown)
        self._clock = clock
        self._last_ping = 0.0
        self._healthy = set(self.replicas)
        self._fails: Dict[str, int] = {rid: 0 for rid in self.replicas}
        self._pfails: Dict[str, int] = {pid: 0 for pid in self.prefills}
        self._prefill_down: set = set()        # scaled down (healthy)
        self._prefill_unhealthy: set = set()   # failed pings
        self._scale_cooldown = 0
        self._ring = HashRing(sorted(self._healthy))
        # session → pinned replica, LRU-bounded: a front door sees an
        # unbounded stream of session ids and a pin is only best-effort
        # affinity — evicting the coldest pin just re-hashes that
        # session (same defensive cap discipline as HashRing._memo)
        self._sessions: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        self._session_cap = 65536
        # per-replica pinned-session census (vtpu_router_sessions_pinned):
        # maintained with the pin map, read by the session mover's
        # least-pinned target selection and by stats()
        self._pinned: "collections.Counter[str]" = collections.Counter()
        # rid → session, for moving a migrated rid's pin and replaying
        # its in-flight requests on the target (bounded with the pins)
        self._rid_session: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        # live session migration (vtpu_torch/serving/migrate.py): drains and
        # evict requests move pinned sessions to healthy replicas
        # instead of stranding them; finish-in-place stays the fallback
        self._mover = (mover if mover is not None
                       else SessionMover() if migrate_on_drain else None)
        self._evicted: set = set()   # never ping-restored
        self._target: Dict[str, str] = {}       # rid → decode replica id
        self._rid_prefill: Dict[str, str] = {}  # rid → prefill id (queued)
        # cluster-wide prefix cache, router half: prompts digest into
        # chained block hashes and the PrefixIndex routes each request
        # to the prefill replica already holding its longest live
        # prefix (verified against that replica's pool registry — a
        # pool-evicted hint is pruned, not followed).  Active only when
        # a prefill replica opted into its pool registry.
        self._prefix_block = 0
        for pf in self.prefills.values():
            if getattr(pf, "prefix_cache", False):
                self._prefix_block = int(getattr(pf, "block_size", 0))
                break
        self._prefix_index = PrefixIndex() if self._prefix_block else None
        self.prefix_routed = 0
        self._cancelled: set = set()            # rids released pre-handoff
        # saturated wire handoffs waiting for receiver credits:
        # (replica id, PrefillResult, source engine)
        self._parked: collections.deque = collections.deque()
        self._pending: Dict[str, int] = {rid: 0 for rid in self.replicas}
        self.shed = 0
        for rid in self.replicas:
            _HEALTHY_INFO.set(1.0, replica=rid)
            _PINNED.set(0.0, replica=rid)
        _PREFILL_ACTIVE.set(float(len(self._active_prefills())))

    # -- compat ---------------------------------------------------------
    @property
    def prefill(self):
        """The primary prefill engine (single-prefill topologies)."""
        return next(iter(self.prefills.values()))

    # -- metric hygiene --------------------------------------------------
    def _set_pinned_gauge(self, rid: str) -> None:
        """``vtpu_router_sessions_pinned_total`` for one replica.  An
        evicted replica is leaving for good: its series is PRUNED from
        the exposition, not left at a stale last value (Prometheus
        treats the disappearance as the end of the series)."""
        if rid in self._evicted:
            _PINNED.remove(replica=rid)
        else:
            _PINNED.set(float(self._pinned.get(rid, 0)), replica=rid)

    def _set_backlog_gauge(self, replica: str) -> None:
        """``vtpu_router_backlog_total`` for one replica — pruned once an
        evicted replica's in-flight work drains to zero (it may still be
        finishing handoffs admitted before the evict)."""
        if replica in self._evicted and not self._pending.get(replica, 0):
            _BACKLOG.remove(replica=replica)
        else:
            _BACKLOG.set(self._pending.get(replica, 0), replica=replica)

    # -- routing --------------------------------------------------------
    @staticmethod
    def _safe_stats(eng) -> dict:
        """stats() from a replica that may be mid-death: a raising
        replica reports nothing (the ping loop owns marking it
        unhealthy) instead of wedging the whole router."""
        try:
            return eng.stats()
        except Exception:  # noqa: BLE001 — dead replica, health owns it
            return {}

    def _active_prefills(self) -> List[str]:
        return sorted(
            set(self.prefills) - self._prefill_down
            - self._prefill_unhealthy
        )

    def _route(self, session: str) -> str:
        pinned = self._sessions.get(session)
        if pinned is not None and pinned in self._evicted:
            # an evict-requested replica is LEAVING — unlike a health
            # drain (which may restore), routing new turns there would
            # hand work to a pod the reconciler is about to delete.
            # Drop the stale pin (its live slots already migrated; an
            # idle session has nothing to move) and re-pin below.
            self._sessions.pop(session, None)
            self._pinned[pinned] = max(0, self._pinned[pinned] - 1)
            self._set_pinned_gauge(pinned)
            pinned = None
        if pinned is not None:
            # in-flight sessions finish where they are, even on a
            # drained replica (it still answers; it just takes no new
            # sessions); the replica set itself is fixed for the
            # router's lifetime
            self._sessions.move_to_end(session)
            return pinned
        if not self._healthy:
            raise RouterReject(
                "no_healthy_replica",
                "every decode replica is drained",
            )
        rid = self._ring.owner(session)
        self._sessions[session] = rid
        self._pinned[rid] += 1
        self._set_pinned_gauge(rid)
        while len(self._sessions) > self._session_cap:
            _sess, old = self._sessions.popitem(last=False)
            self._pinned[old] = max(0, self._pinned[old] - 1)
            self._set_pinned_gauge(old)
        return rid

    def _pick_prefill(self, chain=()) -> str:
        active = self._active_prefills()
        if not active:
            raise RouterReject(
                "no_healthy_prefill",
                "every prefill replica is drained",
            )
        # prefix affinity first: a replica whose pool still holds the
        # prompt's longest registered prefix skips that much recompute,
        # which beats a shorter queue (the index verifies liveness
        # against the pool registry before routing on a hint)
        if chain and self._prefix_index is not None:
            pid, _depth = self._prefix_index.route(
                chain, {p: self.prefills[p] for p in active}
            )
            if pid is not None:
                self.prefix_routed += 1
                return pid
        # least-queued active prefill, id tiebreak for determinism; a
        # replica whose stats() raises (died since its last ping) is
        # skipped rather than picked-as-empty
        cands = []
        for pid in active:
            try:
                q = int(self.prefills[pid].stats().get("queued", 0))
            except Exception:  # noqa: BLE001 — health owns the drain
                continue
            cands.append((q, pid))
        if not cands:
            raise RouterReject(
                "no_healthy_prefill",
                "every prefill replica is drained or unreachable",
            )
        return min(cands)[1]

    def rehydrate_prefix_index(self) -> int:
        """Restart path of the K/V memory hierarchy (docs/serving.md
        §Memory hierarchy): re-seed the PrefixIndex from every prefill
        replica's pool — registered device runs plus host-tier spilled
        runs, including those a replica just rehydrated from its
        persistence journal (vtpu_torch/serving/kvpersist.py).  Entries are
        recorded as hints; ``route`` verifies depth against the pool
        before following one, so a stale chain is pruned, never
        trusted.  Returns the number of chains recorded."""
        if self._prefix_index is None:
            return 0
        n = 0
        for pid, pf in self.prefills.items():
            pool = getattr(pf, "pool", None)
            chains = getattr(pool, "known_chains", None)
            if (chains is None or getattr(pf, "block_size", 0)
                    != self._prefix_block):
                continue  # foreign granularity never seeds hints
            for chain in chains():
                if chain:
                    self._prefix_index.record(list(chain), pid)
                    n += 1
        return n

    def submit(self, session: str, rid: str, prompt, num_new: int) -> str:
        """Admit one request: pick the session's replica, check its
        live load (active slots + handles claimed but not yet in a slot
        + our own uncollected prefill backlog for it), and queue the
        prefill on the least-loaded active prefill replica.  Returns
        the chosen decode replica id; raises :class:`RouterReject` on
        shed."""
        chain: list = []
        try:
            replica = self._route(session)
            # a replica dying between pings must not crash admission:
            # an empty stats doc admits, and the handoff's fallback leg
            # (or the next ping) owns the failure
            st = self._safe_stats(self.replicas[replica])
            load = (int(st.get("active_slots", 0))
                    + int(st.get("queued", 0))
                    + self._pending.get(replica, 0))
            limit = int(st.get("max_batch", 1)) + self.max_backlog
            if load >= limit:
                raise RouterReject(
                    "replica_saturated",
                    f"replica {replica} at {load} (≥ {limit})",
                )
            # digest only past the cheap reject checks — a shed request
            # never pays sha256-per-block
            chain = (chain_digests([int(t) for t in prompt],
                                   self._prefix_block)
                     if self._prefix_index is not None else [])
            pid = self._pick_prefill(chain)
        except RouterReject as e:
            self.shed += 1
            _REQS_TOTAL.inc(outcome="shed")
            _SHED_TOTAL.inc(reason=e.reason)
            raise
        # admission passed: mint the request trace + attribution record
        # (no-op while tracing is off) BEFORE the prefill submit so the
        # engine's dispatch marks land on an existing record
        LEDGER.admit(rid, session, prompt_tokens=len(prompt))
        if (chain
                and getattr(self.prefills[pid], "prefix_cache", False)
                and getattr(self.prefills[pid], "block_size", 0)
                == self._prefix_block):
            # the chain is only valid at the granularity it was
            # digested at — a replica with a different kv_block_size
            # computes its own (mixed-granularity digests never match
            # each other, so routing hints stay safe either way)
            # hand the digest chain down so the engine doesn't re-hash
            # the prompt, and record optimistically: the replica
            # registers the run once its prefill enqueues; until then a
            # route on this hint verifies against the pool and just
            # misses (the unverified hint is KEPT, not followed)
            self.prefills[pid].submit(rid, prompt, num_new, chain=chain)
            self._prefix_index.record(chain, pid)
        else:
            self.prefills[pid].submit(rid, prompt, num_new)
        self._rid_prefill[rid] = pid
        self._target[rid] = replica
        self._rid_session[rid] = session
        while len(self._rid_session) > self._session_cap:
            self._rid_session.popitem(last=False)
        self._pending[replica] = self._pending.get(replica, 0) + 1
        _REQS_TOTAL.inc(outcome="routed")
        self._set_backlog_gauge(replica)
        return replica

    def cancel(self, rid: str) -> bool:
        """Release a routed request wherever it currently lives: the
        prefill queue (dropped before it runs), the parked-handoff
        queue (handle released), or a decode replica's pending-adoption
        queue (``purge_pending`` frees the claimed blocks so a
        cancelled session can't consume a fused-adoption slot).
        Returns True when something was cancelled."""
        if rid in self._target:
            pid = self._rid_prefill.get(rid)
            eng = self.prefills.get(pid) if pid is not None else None
            purge = getattr(eng, "purge", None)
            purged = False
            if purge is not None:
                try:
                    purged = bool(purge(rid))
                except Exception:  # noqa: BLE001 — dead engine: fall
                    # through to the release-on-arrival path
                    log.debug("router: purge on prefill %s failed", pid,
                              exc_info=True)
            if purged:
                self._rid_prefill.pop(rid, None)
                self._clear_ledger(rid)
                LEDGER.finish(rid, ok=False, error="cancelled")
                return True
            # already inside the engine's admission round (or the
            # engine cannot purge / is unreachable): release the result
            # on arrival
            self._cancelled.add(rid)
            LEDGER.finish(rid, ok=False, error="cancelled")
            return True
        for i, (target, res, _src) in enumerate(self._parked):
            if res.rid == rid:
                del self._parked[i]
                self._dec_pending(target)
                self._release_result(res)
                LEDGER.finish(rid, ok=False, error="cancelled")
                return True
        for rep_id, eng in self.replicas.items():
            purge = getattr(eng, "purge_pending", None)
            if purge is None:
                continue
            try:
                if purge(rid):
                    LEDGER.finish(rid, ok=False, error="cancelled")
                    return True
            except Exception:  # noqa: BLE001 — one dead replica must
                # not stop the walk reaching a live replica's entry
                log.debug("router: purge_pending on %s failed", rep_id,
                          exc_info=True)
        return False

    # -- health ---------------------------------------------------------
    def check_health(self) -> None:
        """Ping every replica (decode and prefill); drain after
        ``fail_threshold`` consecutive failures, restore on the first
        success."""
        self._last_ping = self._clock()
        for rid, eng in self.replicas.items():
            try:
                ok = bool(eng.ping())
            except Exception:  # noqa: BLE001 — a dead replica is a failed ping
                ok = False
            if ok:
                self._fails[rid] = 0
                if rid not in self._healthy and rid not in self._evicted:
                    # an evict-requested replica is leaving for good:
                    # answering pings must not put it back in the ring
                    self._restore(rid)
            else:
                self._fails[rid] += 1
                if (rid in self._healthy
                        and self._fails[rid] >= self.fail_threshold):
                    self._drain(rid)
        for pid, eng in self.prefills.items():
            ping = getattr(eng, "ping", None)
            if ping is None:
                continue  # an in-process engine with no probe is alive
            try:
                ok = bool(ping())
            except Exception:  # noqa: BLE001
                ok = False
            if ok:
                self._pfails[pid] = 0
                if pid in self._prefill_unhealthy:
                    self._prefill_unhealthy.discard(pid)
                    self._prefill_transition(pid, "prefill_restored",
                                             reason="ping")
            else:
                self._pfails[pid] += 1
                if (pid not in self._prefill_unhealthy
                        and self._pfails[pid] >= self.fail_threshold):
                    self._prefill_unhealthy.add(pid)
                    self._prefill_transition(pid, "prefill_drained",
                                             reason="ping")
                    self._shed_prefill_ledger(pid)
                    if self._prefix_index is not None:
                        # hints to a dead replica's pool are useless
                        # until it restores — and a restored process
                        # re-earns them on its next routed submits
                        self._prefix_index.forget_replica(pid)

    def _shed_prefill_ledger(self, pid: str) -> None:
        """A health-drained prefill's queued rids may never produce
        results — release their admission-ledger entries so the target
        decode replicas' capacity is not pinned by ghosts.  The
        rid→prefill map is KEPT: if the engine recovers and emits a
        late result, pump finds no ledger entry (no double decrement),
        re-routes over the healthy ring, and the mapping still names
        the right pool for a release; a cancelled/shed late result
        releases against the right engine."""
        for rid, owner in self._rid_prefill.items():
            if owner == pid and rid in self._target:
                self._clear_ledger(rid)

    def _drain(self, rid: str) -> None:
        self._healthy.discard(rid)
        self._rebuild_ring()
        _HEALTHY_INFO.set(0.0, replica=rid)
        _TRANSITIONS.inc(replica=rid, to="drained")
        emit(EventType.REPLICA_DRAINED, "router", node=rid,
             consecutive_failures=self._fails[rid])
        log.warning("router: replica %s drained after %d failed pings",
                    rid, self._fails[rid])
        # a drain used to strand pinned sessions finishing in place;
        # with the mover they migrate to healthy replicas token-exactly
        # (finish-in-place stays the per-session fallback)
        self._migrate_from(rid, reason="health-drain")

    def request_evict(self, replica_id: str,
                      reason: str = "evict-requested") -> int:
        """Deployment hook for the arbiter's ``vtpu.io/evict-requested``
        annotation (``types.annotations.EVICT_REQUESTED``): the replica
        is leaving — drain it NOW (pings can never restore it) and
        migrate its pinned sessions to healthy replicas so the eviction
        strands no work.  Returns the number of sessions migrated."""
        if replica_id not in self.replicas:
            raise KeyError(f"unknown replica {replica_id!r}")
        self._evicted.add(replica_id)
        if replica_id in self._healthy:
            self._healthy.discard(replica_id)
            self._rebuild_ring()
            _TRANSITIONS.inc(replica=replica_id, to="drained")
            emit(EventType.REPLICA_DRAINED, "router", node=replica_id,
                 reason=reason)
            log.info("router: replica %s drained (%s)", replica_id,
                     reason)
        moved = self._migrate_from(replica_id, reason=reason)
        # the replica is leaving for good: prune its replica-labelled
        # series (healthy_info / pinned / drained backlog) instead of
        # exporting a dead replica's gauges forever — a health drain, by
        # contrast, keeps them (it may restore)
        _HEALTHY_INFO.remove(replica=replica_id)
        self._set_pinned_gauge(replica_id)
        self._set_backlog_gauge(replica_id)
        return moved

    # -- live session migration (vtpu_torch/serving/migrate.py) ---------------
    def _migration_targets(self, exclude: str) -> List:
        """Candidate targets ordered least-pinned first, restricted to
        credit-holding (≥ 1 free pool block) healthy replicas — the
        mover OPENs in this order and the receiver's own credit grant
        has the final word."""
        ranked = []
        for tid in sorted(self._healthy - {exclude}):
            st = self._safe_stats(self.replicas[tid])
            if int(st.get("free", 0)) < 1:
                continue  # pool can't pre-lease a single block
            ranked.append((self._pinned.get(tid, 0), tid))
        return [(tid, self.replicas[tid]) for _n, tid in sorted(ranked)]

    def _migrate_from(self, source_id: str, reason: str) -> int:
        """Mass-migrate every exportable pinned session off a draining
        or evict-requested replica.  Per-session failures fall back to
        finish-in-place (the mover restores the session on the source)
        and never stop the sweep; pins move atomically with each
        successful move, and in-flight requests re-aim at the target."""
        if self._mover is None:
            return 0
        src_rep = self.replicas[source_id]
        moved = 0
        for rid in self._mover.exportable(src_rep):
            try:
                report = self._mover.move(
                    rid, src_rep, self._migration_targets(source_id)
                )
            except SessionGoneError:
                continue  # finished during the export drain
            except MigrationError as e:
                emit(EventType.SESSION_MIGRATION_FAILED, "router",
                     node=source_id, rid=rid, phase=e.phase,
                     restored=e.restored, reason=reason)
                log.warning(
                    "router: migration of %s off %s failed in phase "
                    "%s (%s); %s", rid, source_id, e.phase, e,
                    "finishing in place" if e.restored
                    else "NOT restored",
                )
                continue
            except Exception:  # noqa: BLE001 — the mover's contract is
                # typed failure, but one surprise must not abort the
                # sweep (and with it the whole pump) for the sessions
                # still waiting to move
                emit(EventType.SESSION_MIGRATION_FAILED, "router",
                     node=source_id, rid=rid, phase="unknown",
                     restored=False, reason=reason)
                log.exception("router: migration of %s off %s raised "
                              "untyped", rid, source_id)
                continue
            moved += 1
            emit(EventType.SESSION_MIGRATED, "router", node=source_id,
                 rid=rid, target=report.target,
                 blocks_shipped=report.blocks_shipped,
                 blocks_skipped=report.blocks_skipped, reason=reason)
            sess = self._rid_session.get(rid)
            if sess is not None and self._sessions.get(sess) == source_id:
                # the pin moves with the session — atomically from the
                # router's perspective: every later submit for this
                # session routes to the target
                self._sessions[sess] = report.target
                self._pinned[source_id] = max(
                    0, self._pinned[source_id] - 1)
                self._pinned[report.target] += 1
                self._set_pinned_gauge(source_id)
                self._set_pinned_gauge(report.target)
        self._retarget_inflight(source_id)
        return moved

    def _retarget_inflight(self, source_id: str) -> None:
        """Requests admitted but not yet delivered (queued prefills,
        parked handoffs) whose session moved: park them on the NEW pin
        so the finished prefill replays on the target instead of
        delivering into the drain."""
        def new_pin(rid: str) -> Optional[str]:
            sess = self._rid_session.get(rid)
            new = self._sessions.get(sess) if sess is not None else None
            if new is None or new == source_id or new not in self._healthy:
                return None
            return new

        for rid, tgt in list(self._target.items()):
            if tgt != source_id:
                continue
            new = new_pin(rid)
            if new is None:
                continue
            self._target[rid] = new
            self._dec_pending(source_id)
            self._pending[new] = self._pending.get(new, 0) + 1
            self._set_backlog_gauge(new)
        for i, (tgt, res, src) in enumerate(self._parked):
            if tgt != source_id:
                continue
            new = new_pin(res.rid)
            if new is None:
                continue
            self._parked[i] = (new, res, src)
            self._dec_pending(source_id)
            self._pending[new] = self._pending.get(new, 0) + 1
            self._set_backlog_gauge(new)

    def _restore(self, rid: str) -> None:
        self._healthy.add(rid)
        self._rebuild_ring()
        _HEALTHY_INFO.set(1.0, replica=rid)
        _TRANSITIONS.inc(replica=rid, to="restored")
        emit(EventType.REPLICA_RESTORED, "router", node=rid)
        log.info("router: replica %s restored", rid)

    def _prefill_transition(self, pid: str, to: str, reason: str) -> None:
        _TRANSITIONS.inc(replica=pid, to=to)
        _PREFILL_ACTIVE.set(float(len(self._active_prefills())))
        ev = (EventType.REPLICA_DRAINED if to.endswith("drained")
              else EventType.REPLICA_RESTORED)
        emit(ev, "router", node=pid, role="prefill", reason=reason)
        log.info("router: prefill %s → %s (%s)", pid, to, reason)

    def _rebuild_ring(self) -> None:
        # new sessions re-hash over the healthy set; pinned sessions on
        # a drained replica keep finishing there (session affinity is
        # the point — their K/V lives on that replica), so the pin map
        # is NOT touched here
        self._ring = (HashRing(sorted(self._healthy))
                      if self._healthy else None)

    def _route_fallback(self, rid_req: str,
                        exclude: Optional[str] = None) -> Optional[str]:
        """A handoff whose target stopped accepting re-hashes over the
        healthy set minus the replica that just failed (the prefill K/V
        is replica-agnostic — only the session pin is lost)."""
        cands = sorted(self._healthy - ({exclude} if exclude else set()))
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        return HashRing(cands).owner(rid_req)

    # -- prefill scaling -------------------------------------------------
    def _scale_prefills(self) -> None:
        """Backlog-driven drain/restore of prefill replicas.  Restore a
        scaled-down replica when the backlog per active prefill runs
        deep — or when decode slots starve (low ``slots_active_ratio``)
        while prefill work queues, the signature of an underpowered
        prefill tier.  Scale one down when the backlog per active
        prefill drains below the low watermark."""
        if len(self.prefills) <= 1:
            return
        if self._scale_cooldown > 0:
            self._scale_cooldown -= 1
            return
        eligible = set(self.prefills) - self._prefill_unhealthy
        active = sorted(eligible - self._prefill_down)
        if not active:
            return
        # parked handoffs are EXCLUDED on purpose: they are blocked on
        # decode-pool credits, so more prefill capacity cannot shrink
        # them — counting them here restored prefill replicas exactly
        # when the bottleneck was decode
        backlog = sum(
            int(self._safe_stats(eng).get("queued", 0))
            for eng in self.prefills.values()
        )
        ratios = []
        for eng in self.replicas.values():
            st = self._safe_stats(eng)
            if not st:
                continue
            r = st.get("slots_active_ratio")
            if r is None:
                r = (int(st.get("active_slots", 0))
                     / max(1, int(st.get("max_batch", 1))))
            ratios.append(float(r))
        mean_ratio = sum(ratios) / len(ratios) if ratios else 0.0
        per = backlog / max(1, len(active))
        starved = backlog > 0 and mean_ratio < 0.5
        down_eligible = sorted(self._prefill_down & eligible)
        if down_eligible and (per > self.prefill_scale_high
                              or (starved and per > self.prefill_scale_low)):
            pid = down_eligible[0]
            self._prefill_down.discard(pid)
            self._prefill_transition(pid, "prefill_restored",
                                     reason="backlog")
            self._scale_cooldown = self.prefill_scale_cooldown
        elif (per < self.prefill_scale_low
                and len(active) > self.prefill_min_active):
            pid = active[-1]
            self._prefill_down.add(pid)
            self._prefill_transition(pid, "prefill_drained",
                                     reason="backlog")
            self._scale_cooldown = self.prefill_scale_cooldown

    # -- drive ----------------------------------------------------------
    def _dec_pending(self, replica: str) -> None:
        self._pending[replica] = max(0, self._pending.get(replica, 1) - 1)
        self._set_backlog_gauge(replica)

    def _clear_ledger(self, rid: str) -> None:
        orig = self._target.pop(rid, None)
        if orig is not None:
            self._dec_pending(orig)

    def _release_result(self, res) -> None:
        """Abandon a finished prefill: free its handle's blocks in the
        source pool instead of leaking them."""
        pid = self._rid_prefill.pop(res.rid, None)
        eng = self.prefills.get(pid) if pid is not None else self.prefill
        LEDGER.finish(res.rid, ok=False, error="shed")
        try:
            eng.pool.release_handle(res.handle)
        except KVHandoffError:
            log.warning(
                "router: handle for %s already claimed by a failed "
                "replica; its blocks follow that replica's queue",
                res.rid,
            )

    def pump(self) -> int:
        """One cooperative round: health (if due), prefill scaling,
        parked-handoff retries, one step per prefill replica with work,
        adopt every finished prefill into its replica, one decode step
        per replica.  Returns the number of handoffs performed."""
        if (self.ping_interval_s
                and self._clock() - self._last_ping >= self.ping_interval_s):
            self.check_health()
        self._scale_prefills()
        handoffs = 0
        # deliveries are batched per replica: every handle lands with
        # admit=False and the replica admits ONCE after the batch — one
        # fused adoption group instead of one device program per handle
        touched: set = set()

        def deliver(rep_id: str, res, src) -> None:
            eng = self.replicas[rep_id]
            kw = {}
            chain = getattr(res, "chain", ())
            if chain and getattr(eng, "accepts_chain", False):
                # decode-side prefix adoption: the replica registers
                # the adopted prefix in its own pool so later handoffs
                # and session migrations of sibling prompts go
                # suffix-only (granularity re-checked engine-side)
                kw["chain"] = list(chain)
            if hasattr(eng, "admit_pending"):
                eng.submit_handle(
                    res.rid, res.handle, res.first_token, res.num_new,
                    source=src, submitted=res.submitted, admit=False,
                    **kw,
                )
                touched.add(rep_id)
            else:
                eng.submit_handle(
                    res.rid, res.handle, res.first_token, res.num_new,
                    source=src, submitted=res.submitted, **kw,
                )

        # saturated wire handoffs first: their credits may have freed
        for _ in range(len(self._parked)):
            target, res, src = self._parked.popleft()
            if res.rid in self._cancelled:
                self._cancelled.discard(res.rid)
                self._dec_pending(target)
                self._release_result(res)
                continue
            try:
                deliver(target, res, src)
            except ReplicaSaturatedError:
                self._parked.append((target, res, src))
                continue
            except Exception:  # noqa: BLE001 — replica died while parked
                log.exception("router: parked handoff to %s failed",
                              target)
                self._dec_pending(target)
                delivered = self._dispatch_failed(res, src, target,
                                                  deliver)
                if delivered:  # fallback took it: the rid is handed off
                    self._rid_prefill.pop(res.rid, None)
                handoffs += delivered
                continue
            self._dec_pending(target)
            self._rid_prefill.pop(res.rid, None)
            handoffs += 1

        for pid in sorted(self.prefills):
            eng = self.prefills[pid]
            if (pid not in self._active_prefills()
                    and not int(self._safe_stats(eng).get("queued", 0))):
                continue  # drained AND empty (or dead): nothing to finish
            src = None if getattr(eng, "_host", None) is not None else eng
            try:
                results = eng.step()
            except Exception:  # noqa: BLE001 — a dead prefill fails pings next
                log.exception("router: prefill %s step failed", pid)
                continue
            for res in results:
                orig = self._target.pop(res.rid, None)
                if orig is not None:  # the uncollected-backlog entry
                    self._dec_pending(orig)
                if res.rid in self._cancelled:
                    self._cancelled.discard(res.rid)
                    self._release_result(res)
                    continue
                target = orig if orig in self.replicas \
                    else self._route_fallback(res.rid)
                delivered = False
                if target is not None:
                    try:
                        deliver(target, res, src)
                        delivered = True
                    except ReplicaSaturatedError:
                        # credit backpressure, not failure: the handle
                        # stays adoptable; park and retry as the decode
                        # pool frees.  The ledger entry stays so the
                        # admission controller keeps counting it.
                        self._parked.append((target, res, src))
                        self._pending[target] = (
                            self._pending.get(target, 0) + 1
                        )
                        self._set_backlog_gauge(target)
                        continue
                    except Exception:  # noqa: BLE001 — died mid-handoff
                        log.exception("router: handoff to %s failed",
                                      target)
                        delivered = bool(self._dispatch_failed(
                            res, src, target, deliver
                        ))
                        if delivered:
                            handoffs += 1
                            self._rid_prefill.pop(res.rid, None)
                        continue
                if delivered:
                    handoffs += 1
                    self._rid_prefill.pop(res.rid, None)
                else:
                    # _release_result owns the _rid_prefill pop: it must
                    # see the rid→prefill mapping to release the handle
                    # against the RIGHT engine's pool (popping first
                    # made a multi-prefill shed release against the
                    # primary prefill and leak the real pool's blocks)
                    self._release_result(res)
                    self.shed += 1
                    _SHED_TOTAL.inc(reason=("no_healthy_replica"
                                            if target is None
                                            else "handoff_failed"))
        for rep_id in touched:
            try:
                self.replicas[rep_id].admit_pending()
            except Exception:  # noqa: BLE001 — one replica must not
                # abort the round; its claimed handles stay queued and
                # a failing replica stops answering pings soon after
                log.exception("router: admit_pending on %s failed", rep_id)
        for rid, eng in self.replicas.items():
            try:
                eng.step()
            except Exception:  # noqa: BLE001 — a dead replica fails pings next
                log.debug("router: replica %s step failed", rid,
                          exc_info=True)
        return handoffs

    def _dispatch_failed(self, res, src, failed_target, deliver) -> int:
        """Fallback leg of a failed handoff: re-route to another healthy
        replica, or abandon the prefill (blocks freed, loss accounted)."""
        fb = self._route_fallback(res.rid, exclude=failed_target)
        if fb is not None:
            try:
                deliver(fb, res, src)
                return 1
            except Exception:  # noqa: BLE001
                log.exception("router: fallback handoff to %s failed", fb)
        self._release_result(res)
        self.shed += 1
        _SHED_TOTAL.inc(reason=("no_healthy_replica" if fb is None
                                else "handoff_failed"))
        return 0

    def idle(self) -> bool:
        """True when nothing is queued or in flight anywhere."""
        if self._parked:
            return False
        for eng in self.prefills.values():
            if self._safe_stats(eng).get("queued", 0):
                return False
        for eng in self.replicas.values():
            st = self._safe_stats(eng)
            if (st.get("active_slots", 0) or st.get("queued", 0)
                    or st.get("inflight_windows", 0)
                    or st.get("prefilling_slots", 0)
                    or st.get("wire_senders", 0)):
                return False
        return True

    def drain(self, max_rounds: int = 100000) -> Dict[str, List[int]]:
        """Pump until idle; returns the merged per-rid transcripts."""
        rounds = 0
        while not self.idle():
            self.pump()
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("router drain did not converge")
        return self.results()

    def results(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for eng in self.replicas.values():
            flush = getattr(eng, "_flush_first_tokens", None)
            if flush is not None:
                flush()
            out.update(eng.out)
        return out

    def stats(self) -> dict:
        return {
            "replicas": sorted(self.replicas),
            "healthy": sorted(self._healthy),
            "sessions": len(self._sessions),
            "shed": self.shed,
            "prefills": sorted(self.prefills),
            "prefill_active": self._active_prefills(),
            "prefill_queued": sum(
                int(self._safe_stats(eng).get("queued", 0))
                for eng in self.prefills.values()
            ),
            "parked_handoffs": len(self._parked),
            "pending_handoffs": dict(self._pending),
            "prefix_index_entries": (len(self._prefix_index)
                                     if self._prefix_index is not None
                                     else 0),
            "prefix_routed": self.prefix_routed,
            "sessions_pinned": {rid: int(self._pinned.get(rid, 0))
                                for rid in sorted(self.replicas)},
            "evicted": sorted(self._evicted),
        }
