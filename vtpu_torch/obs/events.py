"""Typed, bounded, cross-component event journal.

The port's copy of ``vtpu/obs/events.py``: the same event vocabulary
(``EventType``), record shape and counters, in a journal of its own.
Locks are plain ``threading.Lock`` objects (the JAX package's
``make_lock`` is one too unless its lock witness is switched on).

Tracing (PR 2) answers "how long did each leg take" and the decision log
(PR 4) answers "why this node" — but neither leaves a durable record of
*what happened* to a pod or a node: a booking, an Allocate, a region
attach, a GC, a drift verdict.  This journal is that record: a process-
wide capped ring (``VTPU_EVENT_LOG_CAP``, default 2048) of typed events,
optionally mirrored to a JSONL file (``VTPU_EVENT_JSONL``) for post-
mortems that outlive the process.

Every event carries a registered type (``EVENT_TYPES`` — emit() rejects
unknown ones so the catalog in docs/observability.md stays complete,
enforced by ``make obs-lint``), the emitting component, the subject pod
uid / node, a wall timestamp, and the active trace context when the
emitter runs inside a span (trace id = pod UID, so ``/events?pod=`` and
``/timeline?pod=`` join on the same key).

Counting rides the shared metrics layer: each emit increments
``vtpu_events_total{component=,type=}`` in the cross-cutting ``obs``
registry (rendered by every /metrics listener after its own families —
one registry, because a listener that concatenates two component
registries must never see the same family twice).

Query surface: ``GET /events?pod=&type=&since=&n=`` on every debug
listener (vtpu/obs/http.py), merged into ``/timeline`` responses, and
exported into the Chrome trace as instant events so journal marks render
between the spans.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Deque, List, Optional

from vtpu_torch.obs.jsonl import RotatingJsonlSink
from vtpu_torch.obs.registry import registry
from vtpu_torch.utils import trace
from vtpu_torch.utils.envs import env_int, env_str

log = logging.getLogger(__name__)

ENV_CAP = "VTPU_EVENT_LOG_CAP"
ENV_JSONL = "VTPU_EVENT_JSONL"
DEFAULT_CAP = 2048


class EventType:
    """The registered event vocabulary.  Every name here must be
    documented in docs/observability.md — ``make obs-lint`` fails on a
    type missing from the catalog."""

    # scheduler
    POD_FILTERED = "PodFiltered"        # filter decided (node chosen or no-fit)
    POD_BOUND = "PodBound"              # bind succeeded
    BIND_FAILED = "BindFailed"          # bind failed; booking rolled back
    NODE_REGISTERED = "NodeRegistered"  # registry gained/changed a node's devices
    NODE_EXPELLED = "NodeExpelled"      # a node's devices left the registry
    NODE_STALE = "NodeStale"            # handshake/heartbeat past its deadline
    # gang scheduling (vtpu/scheduler/gang.py two-phase protocol)
    GANG_RESERVED = "GangReserved"      # phase 1: every member node CAS-booked
    GANG_BOUND = "GangBound"            # phase 2: every member's assignment patched
    GANG_ABORTED = "GangAborted"        # any member failed; all reservations rolled back
    # plugin
    ALLOCATE_SERVED = "AllocateServed"  # kubelet Allocate answered with devices
    ALLOCATE_FAILED = "AllocateFailed"  # Allocate unwound the handshake
    DEVICE_POLL_FAILED = "DevicePollFailed"  # provider health poll broke (streak start)
    # monitor
    REGION_ATTACHED = "RegionAttached"  # pathmonitor started tracking a region
    REGION_GC = "RegionGC"              # stale container dir garbage-collected
    # tiered preemption (monitor arbiter ↔ scheduler reconciler)
    THROTTLE_CHANGED = "ThrottleChanged"  # arbiter moved a region's throttle ladder
    EVICT_REQUESTED = "EvictRequested"    # contention outlasted VTPU_EVICT_AFTER_S
    POD_EVICTED = "PodEvicted"            # scheduler deleted the best-effort pod
    # auditor
    DRIFT_DETECTED = "DriftDetected"    # reconciliation found booked/measured skew
    # serving router
    REPLICA_DRAINED = "ReplicaDrained"    # decode replica failed health pings; out of the ring
    REPLICA_RESTORED = "ReplicaRestored"  # drained replica answers again; back in the ring
    # live session migration (vtpu/serving/migrate.py)
    SESSION_MIGRATED = "SessionMigrated"  # a pinned session moved replicas token-exactly
    SESSION_MIGRATION_FAILED = "SessionMigrationFailed"  # a move failed typed (restored on the source, or ambiguous)
    # co-location bridge (vtpu/serving/colo.py)
    EVICT_MIGRATED = "EvictMigrated"  # an evict-requested annotation became Router.request_evict; the replica's sessions migrated
    # flight recorder (vtpu/obs/incident.py)
    INCIDENT_RECORDED = "IncidentRecorded"  # a trigger fired and a bundle was written under VTPU_INCIDENT_DIR


EVENT_TYPES = frozenset(
    v for k, v in vars(EventType).items() if not k.startswith("_")
)


class EventJournal:
    """Capped ring of typed events + optional JSONL mirror."""

    def __init__(
        self,
        cap: Optional[int] = None,
        jsonl_path: Optional[str] = None,
        wallclock=time.time,
    ) -> None:
        if cap is None:
            cap = env_int(ENV_CAP, DEFAULT_CAP)
        self.cap = max(1, cap)
        self.jsonl_path = (
            jsonl_path
            if jsonl_path is not None
            else env_str(ENV_JSONL)
        ) or None
        self._wallclock = wallclock
        self._lock = threading.Lock()
        self._dq: Deque[dict] = collections.deque(maxlen=self.cap)
        self._seq = 0
        # the sink has its own lock so emitters on the scheduler's hot
        # path never queue behind another thread's disk flush on the
        # ring lock; under contention file lines may land out of seq
        # order — every record carries "seq", consumers sort on it.
        # Rotation (VTPU_EVENT_JSONL_MAX_BYTES, keep-one-previous) and
        # the first-OSError disable live in the shared RotatingJsonlSink.
        self._sink: Optional[RotatingJsonlSink] = (
            RotatingJsonlSink(self.jsonl_path, lock_name="obs.events_sink")
            if self.jsonl_path else None
        )

    # -- emit -----------------------------------------------------------
    def emit(
        self,
        type: str,
        component: str,
        pod: str = "",
        node: str = "",
        **fields: object,
    ) -> dict:
        """Record one event.  ``type`` must be a registered EventType;
        ``pod`` is the pod UID when the event concerns one.  The active
        trace context (if any) is captured so journal entries join the
        span feed.  Never raises past the type check — a broken sink or
        counter must not break the emitting hot path."""
        if type not in EVENT_TYPES:
            raise ValueError(f"unregistered event type: {type!r}")
        with self._lock:
            self._seq += 1
            rec = {
                "seq": self._seq,
                "ts": self._wallclock(),
                "type": type,
                "component": component,
            }
            if pod:
                rec["pod"] = pod
            if node:
                rec["node"] = node
            ctx = trace.current_context()
            if ctx:
                rec["trace"] = ctx
            rec.update(fields)
            overwrote = len(self._dq) == self.cap
            self._dq.append(rec)
        if overwrote:
            # the ring silently dropped its oldest event — count it so a
            # post-mortem knows when VTPU_EVENT_LOG_CAP was too small
            try:
                registry("obs").counter(
                    "vtpu_events_overwritten_total",
                    "Events evicted from the capped ring by newer emits "
                    "(the window was smaller than the incident)",
                ).inc()
            except Exception:  # noqa: BLE001
                log.debug("overwrite counter failed", exc_info=True)
        if self._sink is not None:
            self._sink.write(rec)  # disk I/O stays off the ring lock
        for fn in list(_listeners):
            # on-record taps (the outcome joiner's disposition feed) run
            # off the ring lock and must never break the emitting path
            try:
                fn(rec)
            except Exception:  # noqa: BLE001
                log.debug("event listener failed", exc_info=True)
        try:
            registry("obs").counter(
                "vtpu_events_total",
                "Journal events emitted by component and type (the ring "
                "itself is capped by VTPU_EVENT_LOG_CAP)",
            ).inc(component=component, type=type)
        except Exception:  # noqa: BLE001 — counting must not break emitters
            log.debug("event counter failed", exc_info=True)
        return rec

    # -- query (GET /events) --------------------------------------------
    def query(
        self,
        pod: Optional[str] = None,
        type: Optional[str] = None,
        since: Optional[float] = None,
        n: int = 100,
    ) -> List[dict]:
        """Newest-last matching events.  Filters apply before the count
        cut (like /spans?name=): ``pod`` matches the pod uid, ``type``
        the event type, ``since`` keeps events with ts >= since."""
        with self._lock:
            recs = list(self._dq)
        if pod:
            recs = [r for r in recs if r.get("pod") == pod]
        if type:
            recs = [r for r in recs if r.get("type") == type]
        if since is not None:
            recs = [r for r in recs if r.get("ts", 0) >= since]
        n = max(0, n)
        return recs[-n:] if n else []

    def events_body(self, params: dict) -> bytes:
        """Body for ``GET /events?pod=&type=&since=&n=&format=``.

        Default is one JSON document; ``format=jsonl`` yields one record
        per line (NDJSON) so external scrapers can tail the surface with
        the same parser they use on the VTPU_EVENT_JSONL mirror."""
        try:
            n = int(params.get("n", 100))
        except ValueError:
            n = 100
        since: Optional[float] = None
        if params.get("since"):
            try:
                since = float(params["since"])
            except ValueError:
                since = None
        recs = self.query(
            pod=params.get("pod") or None,
            type=params.get("type") or None,
            since=since,
            n=n,
        )
        if params.get("format") == "jsonl":
            return b"".join(
                json.dumps(r, default=str).encode() + b"\n" for r in recs
            )
        return json.dumps(
            {"events": recs, "count": len(recs)}, default=str
        ).encode()

    # -- Chrome trace merge ---------------------------------------------
    def chrome_events(self) -> List[dict]:
        """Instant events (ph="i", global scope) so journal marks render
        between the spans in chrome://tracing / Perfetto."""
        with self._lock:
            recs = list(self._dq)
        out = []
        for r in recs:
            args = {
                k: v for k, v in r.items() if k not in ("ts", "type")
            }
            out.append({
                "name": r["type"],
                "ph": "i",
                "s": "g",
                "ts": round(float(r["ts"]) * 1e6, 3),
                "pid": os.getpid(),
                "cat": "vtpu-event",
                "args": args,
            })
        return out

    def snapshot(self) -> List[dict]:
        """The full ring, oldest-first — the incident bundler's freeze."""
        with self._lock:
            return list(self._dq)

    @property
    def _sink_dead(self) -> bool:
        return self._sink is not None and self._sink.dead

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


#: module-level on-record listeners, invoked by every journal's emit()
#: AFTER the ring/sink writes — module-level (not per-instance) so a
#: configure() swap never drops a registered tap (the outcome joiner)
_listeners: List = []


def add_listener(fn) -> None:
    """Register an on-record callback ``fn(rec)`` — idempotent."""
    if fn not in _listeners:
        _listeners.append(fn)


def remove_listener(fn) -> None:
    try:
        _listeners.remove(fn)
    except ValueError:
        pass


_journal: Optional[EventJournal] = None
_journal_lock = threading.Lock()


def journal() -> EventJournal:
    """The process-wide journal (created on first use from the env)."""
    global _journal
    with _journal_lock:
        if _journal is None:
            _journal = EventJournal()
        return _journal


def configure(
    cap: Optional[int] = None, jsonl_path: Optional[str] = None
) -> EventJournal:
    """Replace the process journal (entrypoints with explicit flags, and
    tests that need a private cap/sink).  The old journal's sink is
    closed; its ring is dropped."""
    global _journal
    with _journal_lock:
        if _journal is not None:
            _journal.close()
        _journal = EventJournal(cap=cap, jsonl_path=jsonl_path)
        return _journal


def emit(
    type: str, component: str, pod: str = "", node: str = "", **fields
) -> dict:
    """Module-level convenience: ``journal().emit(...)``."""
    return journal().emit(type, component, pod=pod, node=node, **fields)
