"""Per-request latency attribution for the disaggregated serving plane.

The port's copy of ``vtpu/serving/reqtrace.py``: the same marks,
stages and record documents, in a ledger of its own (``LEDGER``) gated
on the port's trace switch.  The port's engines mark this ledger and the
JAX package's engines mark theirs, so a topology that mixes the two
packages gives partial records, never wrong ones.
Locks are plain ``threading.Lock`` objects (the JAX package's
``make_lock`` is one too unless its lock witness is switched on).

Aggregate histograms say TTFT p99 regressed; this ledger says *which
stage* of *which request* ate the time.  One record per admitted request
tracks a telescoping chain of boundary timestamps — submit →
prefill_start → prefill_done → handoff_done → adopted → first_token —
and the named stages are the consecutive deltas:

    router_queue     submit → prefill dispatch (admission + queue wait)
    prefill_compute  fused prefill dispatch → PrefillResult emitted
    wire_transfer    result emitted → wire FIN / handle enqueued
    adoption         handoff done → K/V bound into a decode slot
    decode_window    adoption → first token published

Because each stage is a delta between consecutive marks (a missing mark
collapses to a zero-width stage), the five stages sum EXACTLY to the
measured TTFT — attribution that cannot drift from the headline number.
Two more stages accumulate outside the telescope (they can recur, and
recur after the first token): ``migration_pause`` (SessionMover legs)
and ``spill_onload`` (host-tier K/V onload on the admission path).

Everything is gated on the one trace switch (``VTPU_TRACE`` /
``trace.tracing()``) so the tracing-off hot path stays a no-op — the
same discipline as ``VTPU_FLIGHT_SAMPLE_S``.  With tracing on, each
request also owns a span tree rooted at the ``request`` span (trace id =
rid) served by ``GET /timeline?rid=`` and the Chrome export; completed
attribution records ring-buffer in memory (``VTPU_REQUEST_LEDGER_CAP``),
serve ``GET /requests?rid=``, and mirror to the rotating JSONL sink
(``VTPU_REQUEST_JSONL``) as the training dataset for the learned cost
model (ROADMAP item 2).

The module is JAX-free and process-local: a decode replica reached over
the wire keeps its own marks; the sender-side ledger still closes its
record from the wire FIN callback, so single-process topologies (and the
loopback test lane) get full telescopes while cross-process receivers
degrade to partial records rather than wrong ones.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional

from vtpu_torch import obs
from vtpu_torch.obs.jsonl import RotatingJsonlSink
from vtpu_torch.utils import trace
from vtpu_torch.utils.envs import env_int, env_str

__all__ = [
    "LEDGER",
    "STAGES",
    "RequestLedger",
    "add_completion_listener",
    "remove_completion_listener",
    "requests_body",
]

log = logging.getLogger(__name__)

#: module-level completion taps, invoked by finish() with the finished
#: attribution doc — module-level so they survive ledger swaps in tests
#: (the outcome joiner's request-level TTFT/ITL join registers here)
_completion_listeners: List = []


def add_completion_listener(fn) -> None:
    """Register an on-completion callback ``fn(doc)`` — idempotent."""
    if fn not in _completion_listeners:
        _completion_listeners.append(fn)


def remove_completion_listener(fn) -> None:
    try:
        _completion_listeners.remove(fn)
    except ValueError:
        pass


_REG = obs.registry("serving")

STAGE_HIST = _REG.histogram(
    "vtpu_request_stage_seconds",
    "Per-request latency attributed to one named serving stage "
    "(router_queue / prefill_compute / wire_transfer / adoption / "
    "decode_window sum exactly to TTFT; migration_pause / spill_onload "
    "accumulate outside the telescope)",
)
TTFT_HIST = _REG.histogram(
    "vtpu_request_ttft_seconds",
    "End-to-end time to first token per request (router admission → "
    "first token published), recorded only while tracing is on",
)
ITL_HIST = _REG.histogram(
    "vtpu_request_itl_seconds",
    "Inter-token latency: gap between consecutive published tokens of "
    "one request, recorded only while tracing is on",
)
TENANT_TOKENS = _REG.counter(
    "vtpu_tenant_tokens_total",
    "Tokens accounted per tenant (session-id prefix) by kind "
    "(prompt / generated)",
)
TENANT_WIRE_BYTES = _REG.counter(
    "vtpu_tenant_wire_bytes_total",
    "K/V wire payload bytes shipped on behalf of each tenant "
    "(sender-side accounting)",
)

ENV_LEDGER_CAP = "VTPU_REQUEST_LEDGER_CAP"
ENV_JSONL = "VTPU_REQUEST_JSONL"

#: The complete stage vocabulary (docs/observability.md §Request tracing)
STAGES = (
    "router_queue",
    "prefill_compute",
    "wire_transfer",
    "adoption",
    "decode_window",
    "migration_pause",
    "spill_onload",
)

# TTFT telescope: stage name → the mark that CLOSES it; each duration is
# the delta from the previous present mark, so the five stages tile
# [submit, first_token] with no gaps and no overlaps
_TELESCOPE = (
    ("router_queue", "prefill_start"),
    ("prefill_compute", "prefill_done"),
    ("wire_transfer", "handoff_done"),
    ("adoption", "adopted"),
    ("decode_window", "first_token"),
)


def tenant_of(session: str) -> str:
    """Tenant = the session id's ``/``-prefix (``acme/chat-7`` → ``acme``);
    sessions without one account under ``default``."""
    if session and "/" in session:
        return session.split("/", 1)[0]
    return "default"


class _Record:
    __slots__ = (
        "rid", "session", "tenant", "ctx", "span", "marks", "pauses",
        "ttft_s", "tokens_out", "last_token_at", "itl_sum", "itl_n",
        "done", "ok", "error", "wall_start", "seq",
    )

    def __init__(self, rid: str, session: str, tenant: str,
                 ctx: Optional[str], span: dict, now: float) -> None:
        self.rid = rid
        self.session = session
        self.tenant = tenant
        self.ctx = ctx
        self.span = span
        self.marks: Dict[str, float] = {"submit": now}
        self.pauses: Dict[str, float] = {}
        self.ttft_s: Optional[float] = None
        self.tokens_out = 0
        self.last_token_at: Optional[float] = None
        self.itl_sum = 0.0
        self.itl_n = 0
        self.done = False
        self.ok = True
        self.error: Optional[str] = None
        self.wall_start = time.time()
        # monotonic completion sequence (assigned by finish()): the
        # JSONL mirror's ordering key — offsets break across rotation,
        # seq survives it (same contract as the decision/event journals)
        self.seq: Optional[int] = None

    def stages(self) -> Dict[str, float]:
        """The telescope deltas up to the latest present mark, plus the
        accumulated pauses.  Stages whose closing mark is missing (still
        in flight, or a hop on another process) are zero-width; marks
        landing AFTER the first token (speculative adoption publishes
        before the wire FIN binds) clamp to it, so the five telescope
        stages always sum exactly to TTFT."""
        out: Dict[str, float] = {}
        tfirst = self.marks.get("first_token")
        prev = self.marks["submit"]
        for stage, mark in _TELESCOPE:
            t = self.marks.get(mark, prev)
            if tfirst is not None:
                t = min(t, tfirst)
            out[stage] = max(0.0, t - prev)
            prev = max(prev, t)
        for stage, dur in self.pauses.items():
            out[stage] = out.get(stage, 0.0) + dur
        return out

    def doc(self) -> dict:
        return {
            "seq": self.seq,
            "rid": self.rid,
            "session": self.session,
            "tenant": self.tenant,
            "trace": self.ctx,
            "ts": self.wall_start,
            "ttft_s": self.ttft_s,
            "stages": {k: round(v, 9) for k, v in self.stages().items()},
            "tokens_out": self.tokens_out,
            "itl_mean_s": (self.itl_sum / self.itl_n
                           if self.itl_n else None),
            "itl_n": self.itl_n,
            "done": self.done,
            "ok": self.ok,
            "error": self.error,
        }


class RequestLedger:
    """rid-keyed attribution records.  Every mutator is a no-op while
    tracing is off; the hot-path contract is one ``trace.tracing()``
    check (callers on per-token paths pre-check it themselves)."""

    def __init__(self, cap: Optional[int] = None) -> None:
        self.cap = cap if cap is not None else max(
            16, env_int(ENV_LEDGER_CAP, 512))
        self._lock = threading.Lock()
        self._active: "collections.OrderedDict[str, _Record]" = (
            collections.OrderedDict()
        )
        self._completed: "collections.deque" = collections.deque(
            maxlen=self.cap)
        self._jsonl: Optional[RotatingJsonlSink] = None
        self._jsonl_checked = False
        self.dropped = 0
        self._seq = 0  # completion sequence (see _Record.seq)

    # -- sink -----------------------------------------------------------
    def _sink(self) -> Optional[RotatingJsonlSink]:
        if not self._jsonl_checked:
            self._jsonl_checked = True
            path = env_str(ENV_JSONL)
            if path:
                self._jsonl = RotatingJsonlSink(
                    path, lock_name="serving.reqtrace_jsonl")
        return self._jsonl

    # -- lifecycle ------------------------------------------------------
    def admit(self, rid: str, session: str = "",
              prompt_tokens: int = 0) -> Optional[str]:
        """Open a record (and the root ``request`` span) at router
        admission.  Returns the trace-context token children join with,
        or None while tracing is off."""
        if not trace.tracing():
            return None
        tenant = tenant_of(session)
        sp = trace.start_span("request", trace_id=rid, rid=rid,
                              session=session, tenant=tenant)
        rec = _Record(rid, session, tenant, trace.context_of(sp), sp,
                      time.perf_counter())
        with self._lock:
            self._active[rid] = rec
            self._active.move_to_end(rid)
            while len(self._active) > 4 * self.cap:
                self._active.popitem(last=False)
                self.dropped += 1
        if prompt_tokens:
            TENANT_TOKENS.inc(prompt_tokens, tenant=tenant, kind="prompt")
        return rec.ctx

    def ensure(self, rid: str) -> None:
        """Open a record for a request that skipped the router (the
        direct-submit bench/test topologies) — idempotent."""
        if not trace.tracing():
            return
        with self._lock:
            if rid in self._active:
                return
        self.admit(rid)

    def ctx(self, rid: str) -> Optional[str]:
        """Trace-context token for a rid's children, or None."""
        with self._lock:
            rec = self._active.get(rid)
        return rec.ctx if rec is not None else None

    def mark(self, rid: str, mark: str, t: Optional[float] = None) -> None:
        """Stamp one boundary timestamp; first write wins (retried hops
        must not move a boundary that already passed)."""
        if not trace.tracing():
            return
        with self._lock:
            rec = self._active.get(rid)
            if rec is not None:
                rec.marks.setdefault(
                    mark, t if t is not None else time.perf_counter())

    def pause(self, rid: str, stage: str, dur_s: float) -> None:
        """Accumulate a non-telescope stage (migration_pause /
        spill_onload) — observed immediately so mid-decode pauses are
        counted even if the record never finishes."""
        if not trace.tracing() or dur_s < 0:
            return
        STAGE_HIST.observe(dur_s, stage=stage)
        with self._lock:
            rec = self._active.get(rid)
            if rec is not None:
                rec.pauses[stage] = rec.pauses.get(stage, 0.0) + dur_s

    def first_token(self, rid: str, t: Optional[float] = None) -> None:
        """First token published: close the telescope.  Idempotent (the
        speculative-adoption publish and the harvest publish can race —
        the first call wins and defines TTFT)."""
        if not trace.tracing():
            return
        now = t if t is not None else time.perf_counter()
        with self._lock:
            rec = self._active.get(rid)
            if rec is None or "first_token" in rec.marks:
                return
            rec.marks["first_token"] = now
            rec.ttft_s = max(0.0, now - rec.marks["submit"])
            rec.last_token_at = now
            rec.tokens_out += 1
            stages = rec.stages()
            tenant = rec.tenant
            ttft = rec.ttft_s
        TTFT_HIST.observe(ttft)
        for stage, _mark in _TELESCOPE:
            STAGE_HIST.observe(stages[stage], stage=stage)
        TENANT_TOKENS.inc(1, tenant=tenant, kind="generated")

    def token(self, rid: str, t: Optional[float] = None) -> None:
        """One more token published (callers pre-check
        ``trace.tracing()`` — this sits on the per-token decode path)."""
        now = t if t is not None else time.perf_counter()
        gap = None
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                return
            if rec.last_token_at is None:
                # first token arrived through a path that skipped
                # first_token() — treat this as it
                rec.marks.setdefault("first_token", now)
            else:
                gap = max(0.0, now - rec.last_token_at)
                rec.itl_sum += gap
                rec.itl_n += 1
            rec.last_token_at = now
            rec.tokens_out += 1
            tenant = rec.tenant
        if gap is not None:
            ITL_HIST.observe(gap)
        TENANT_TOKENS.inc(1, tenant=tenant, kind="generated")

    def wire_bytes(self, rid: str, n: int) -> None:
        """Sender-side wire-byte accounting against the rid's tenant."""
        if not trace.tracing() or n <= 0:
            return
        with self._lock:
            rec = self._active.get(rid)
        if rec is not None:
            TENANT_WIRE_BYTES.inc(n, tenant=rec.tenant)

    def finish(self, rid: str, ok: bool = True,
               error: Optional[str] = None) -> None:
        """Retire a record: close the root span, move it to the
        completed ring, mirror it to the JSONL sink.  Unknown rids (and
        double-finishes) are no-ops."""
        with self._lock:
            rec = self._active.pop(rid, None)
            if rec is None:
                return
            rec.done = True
            rec.ok = bool(ok)
            rec.error = error
            self._seq += 1
            rec.seq = self._seq
            self._completed.append(rec)
        trace.end_span(rec.span, ok=ok, error=error)
        doc = rec.doc()
        sink = self._sink()
        if sink is not None:
            sink.write(doc)
        for fn in list(_completion_listeners):
            # attribution taps (the outcome joiner's TTFT/ITL join) run
            # off the ledger lock and must never break the finish path
            try:
                fn(doc)
            except Exception:  # noqa: BLE001
                log.debug("completion listener failed", exc_info=True)

    # -- read side ------------------------------------------------------
    def get(self, rid: str) -> Optional[dict]:
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                for r in self._completed:
                    if r.rid == rid:
                        rec = r
                        break
        return rec.doc() if rec is not None else None

    def recent(self, n: int = 50) -> List[dict]:
        with self._lock:
            done = [r.doc() for r in list(self._completed)[-n:]]
            live = [r.doc() for r in list(self._active.values())[-n:]]
        return (done + live)[-n:]

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": len(self._active),
                "completed": len(self._completed),
                "dropped": self.dropped,
            }

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._completed.clear()
            self.dropped = 0


#: process-wide ledger, the serving plane's singleton
LEDGER = RequestLedger()


def requests_body(params: Dict[str, str]) -> bytes:
    """``GET /requests[?rid=<rid>][&n=<count>]`` — one attribution record
    (404-as-empty semantics: unknown rid → ``{"rid": ..., "found":
    false}``) or the most recent ``n`` records."""
    import json

    rid = params.get("rid")
    if rid:
        doc = LEDGER.get(rid)
        if doc is None:
            doc = {"rid": rid, "found": False}
        return json.dumps(doc, default=str).encode()
    try:
        n = int(params.get("n", "50"))
    except ValueError:
        n = 50
    docs = LEDGER.recent(n)
    body = {"requests": docs, "count": len(docs), **LEDGER.stats()}
    return json.dumps(body, default=str).encode()
