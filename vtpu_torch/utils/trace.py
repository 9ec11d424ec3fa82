"""Lightweight trace spans for the control-plane hot paths.

The port's copy of ``vtpu/utils/trace.py`` (the port imports nothing
of vtpu): the same span dicts, ring, context tokens and Chrome export.
It has its own ring and switch; both read ``VTPU_TRACE``.
Locks are plain ``threading.Lock`` objects (the JAX package's
``make_lock`` is one too unless its lock witness is switched on).

The reference has no tracing at all — log lines only (SURVEY.md §5
"Tracing / profiling: none ... Rebuild: add optional trace spans around
Filter/Bind/Allocate").  This is that rebuild: zero-dependency spans with
a ring buffer for inspection (the /spans debug endpoint) and structured
log emission.  Disabled by default; enable with VTPU_TRACE=1 or
``tracing(True)``.

Cross-component lifecycle tracing: every span carries ``trace_id`` /
``span_id`` / ``parent``.  The scheduler roots a pod's trace at Filter
(trace id = pod UID), stamps ``<trace_id>:<span_id>`` into the
``vtpu.io/trace-context`` pod annotation, the device plugin's Allocate
continues it from there and forwards it to the container through the
``VTPU_TRACE_CONTEXT`` env (the shim ABI), and the shim runtime picks it
up at startup — so one pod's filter → patch → Allocate → shim-init chain
shares a single trace id across three processes.  Ring buffers merge via
``ingest`` (the scheduler's POST /spans/ingest feed, or directly in the
test harness); ``timeline`` reconstructs the causal order and
``export_chrome`` emits Chrome trace-event JSON for chrome://tracing /
Perfetto.

Span ids are monotonic per process; ``(proc, span_id)`` identifies a span
across merged feeds, where ``proc`` is a per-process random token — a
bare pid would collide across nodes (every container entrypoint is pid 1)
and across restarts.
"""

from __future__ import annotations

import binascii
import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Deque, Dict, Iterable, Iterator, List, Optional, Tuple

from vtpu_torch.utils.envs import env_str

log = logging.getLogger("vtpu_torch.trace")

_RING_SIZE = 2048
_lock = threading.Lock()
_spans: Deque[dict] = collections.deque(maxlen=_RING_SIZE)
_seen_ids: set = set()  # (proc, span_id) of everything in/through the ring
_enabled: Optional[bool] = None  # None ⇒ read env lazily
_next_span_id = 0
_ctx = threading.local()  # .stack: [(trace_id, span_id), ...]
# cross-feed process identity: pid alone collides (containers are pid 1;
# restarts reuse pids), so spans carry pid + a random per-process token
_PROC_ID = f"{os.getpid()}-{binascii.hexlify(os.urandom(4)).decode()}"


def _span_key(sp: dict) -> tuple:
    """Cross-feed span identity: (proc token, span id); pid fallback for
    feeds from older builds."""
    return (sp.get("proc") or sp.get("pid"), sp.get("span_id"))


def _trim_seen_locked() -> None:
    """Bound the dedup set alongside the ring (caller holds _lock): once
    it outgrows the ring several times over, drop ids no longer live —
    without this, weeks of spans leak one tuple each."""
    if len(_seen_ids) > 8 * _RING_SIZE:
        live = {_span_key(s) for s in _spans}
        _seen_ids.intersection_update(live)


def tracing(on: Optional[bool] = None) -> bool:
    """Get (no arg) or set the global trace switch."""
    global _enabled
    if on is not None:
        _enabled = bool(on)
    if _enabled is None:
        _enabled = env_str("VTPU_TRACE") not in ("", "0", "false")
    return _enabled


def _alloc_span_id() -> int:
    global _next_span_id
    with _lock:
        _next_span_id += 1
        return _next_span_id


def _ctx_stack() -> list:
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    return stack


# --------------------------------------------------------------------------
# Trace-context wire format: "<trace_id>:<span_id>" (annotation + env ABI)
# --------------------------------------------------------------------------

def parse_context(ctx: Optional[str]) -> Tuple[Optional[str], Optional[int]]:
    """``"<trace_id>:<span_id>"`` → (trace_id, parent span id).  Tolerant:
    a bare trace id (no colon / bad span id) still joins the trace."""
    if not ctx:
        return None, None
    trace_id, _, parent = ctx.partition(":")
    try:
        return trace_id or None, int(parent)
    except ValueError:
        return trace_id or None, None


def context_of(sp: dict) -> Optional[str]:
    """The ``trace_id:span_id`` token a span's children should carry, or
    None for the disabled-tracing empty span."""
    if sp.get("trace_id") is not None and sp.get("span_id") is not None:
        return f"{sp['trace_id']}:{sp['span_id']}"
    return None


def current_context() -> Optional[str]:
    """Context token of the innermost active span on this thread (what a
    log line emitted "inside a span" should carry), or None."""
    stack = getattr(_ctx, "stack", None)
    if stack:
        trace_id, span_id = stack[-1]
        if trace_id is not None:
            return f"{trace_id}:{span_id}"
    return None


@contextlib.contextmanager
def span(
    name: str,
    trace_id: Optional[str] = None,
    ctx: Optional[str] = None,
    **attrs: object,
) -> Iterator[Dict[str, object]]:
    """Context manager: times the block, records outcome + attributes.

    The yielded dict is live — handlers may add attributes mid-span
    (e.g. ``sp["node"] = picked``).  Exceptions are recorded and
    re-raised; recording failures never break the traced path.

    Trace context: ``trace_id`` roots/joins a trace explicitly (the
    scheduler passes the pod UID); ``ctx`` joins a propagated
    ``"<trace_id>:<span_id>"`` token (annotation / env ABI), making that
    span the parent; with neither, the span inherits the innermost active
    span on this thread.  Nested spans parent automatically.
    """
    if not tracing():
        yield {}
        return
    parent: Optional[int] = None
    if ctx is not None:
        ctx_trace, parent = parse_context(ctx)
        if trace_id is None:
            trace_id = ctx_trace
    stack = _ctx_stack()
    if stack and (trace_id is None or parent is None):
        inh_trace, inh_span = stack[-1]
        if trace_id is None:
            trace_id = inh_trace
            if parent is None:
                parent = inh_span
        elif parent is None and trace_id == inh_trace:
            parent = inh_span
    span_id = _alloc_span_id()
    sp: Dict[str, object] = {
        "name": name,
        "start": time.time(),
        "trace_id": trace_id,
        "span_id": span_id,
        "parent": parent,
        "proc": _PROC_ID,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        **attrs,
    }
    t0 = time.monotonic()
    stack.append((trace_id, span_id))
    try:
        yield sp
        sp["ok"] = True
    except BaseException as e:
        sp["ok"] = False
        sp["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        stack.pop()
        sp["dur_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        try:
            with _lock:
                _spans.append(sp)
                _seen_ids.add(_span_key(sp))
                _trim_seen_locked()
            log.info("span %s dur=%.2fms ok=%s %s", name, sp["dur_ms"],
                     sp.get("ok"), {k: v for k, v in sp.items()
                                    if k not in ("name", "start", "dur_ms",
                                                 "ok", "pid", "tid")})
        except Exception:  # noqa: BLE001 — tracing must never break the path
            pass


def start_span(
    name: str,
    trace_id: Optional[str] = None,
    ctx: Optional[str] = None,
    **attrs: object,
) -> Dict[str, object]:
    """Begin-style counterpart to :func:`span` for long-lived work that
    crosses threads or hops (a request span opened at router admission and
    closed when the first token publishes; a wire stream span closed by
    the pump's completion callback).

    Unlike :func:`span` this does NOT push the thread-local stack —
    unrelated spans opened on other threads must not accidentally parent
    under it — so children join explicitly via ``ctx=context_of(sp)``.
    Returns the live span dict ({} when tracing is off: every field
    access stays ``sp.get(...)``-safe and ``end_span({})`` is a no-op).
    """
    if not tracing():
        return {}
    parent: Optional[int] = None
    if ctx is not None:
        ctx_trace, parent = parse_context(ctx)
        if trace_id is None:
            trace_id = ctx_trace
    sp: Dict[str, object] = {
        "name": name,
        "start": time.time(),
        "trace_id": trace_id,
        "span_id": _alloc_span_id(),
        "parent": parent,
        "proc": _PROC_ID,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "_t0": time.monotonic(),
        **attrs,
    }
    return sp


def end_span(
    sp: Dict[str, object],
    ok: bool = True,
    error: Optional[str] = None,
) -> None:
    """Close a :func:`start_span` span: stamp duration/outcome and commit
    it to the ring.  Exactly-once by construction — the monotonic anchor
    ``_t0`` is popped on the first close, so double-closes (a stream that
    both finishes and is aborted by a racing teardown) are no-ops, as is
    closing the disabled-tracing ``{}`` span."""
    if not sp:
        return
    t0 = sp.pop("_t0", None)
    if t0 is None:
        return
    sp["ok"] = bool(ok)
    if error is not None:
        sp["error"] = str(error)
    sp["dur_ms"] = round((time.monotonic() - t0) * 1e3, 3)
    try:
        with _lock:
            _spans.append(sp)
            _seen_ids.add(_span_key(sp))
            _trim_seen_locked()
        log.info("span %s dur=%.2fms ok=%s %s", sp.get("name"),
                 sp["dur_ms"], sp.get("ok"),
                 {k: v for k, v in sp.items()
                  if k not in ("name", "start", "dur_ms", "ok",
                               "pid", "tid")})
    except Exception:  # noqa: BLE001 — tracing must never break the path
        pass


def recent_spans(n: int = 100, name: Optional[str] = None) -> list:
    """Last ``n`` spans, newest last; ``name`` filters before the count
    (the /spans?n=&name= debug query)."""
    with _lock:
        spans = list(_spans)
    if name is not None:
        spans = [s for s in spans if s.get("name") == name]
    return spans[-n:]


def clear() -> None:
    with _lock:
        _spans.clear()
        _seen_ids.clear()


# --------------------------------------------------------------------------
# Merged feeds: plugin/monitor rings POSTed into the scheduler's ring
# --------------------------------------------------------------------------

def ingest(spans: Iterable[dict]) -> int:
    """Merge a remote ring-buffer dump into the local ring, skipping spans
    already seen (re-pushes are idempotent: ``(pid, span_id)`` is the
    cross-process span identity).  Returns how many were added."""
    added = 0
    with _lock:
        for sp in spans:
            if not isinstance(sp, dict) or "name" not in sp:
                continue
            key = _span_key(sp)
            if key[1] is not None and key in _seen_ids:
                continue
            _seen_ids.add(key)
            _spans.append(dict(sp))
            added += 1
        _trim_seen_locked()
    return added


def push_spans(url: str, timeout: float = 5.0) -> int:
    """POST this process's ring to a collector (the scheduler's
    POST /spans/ingest).  Returns the HTTP status; raises on transport
    errors (callers decide whether a push loop retries)."""
    import urllib.request

    body = json.dumps(recent_spans(_RING_SIZE), default=str).encode()
    req = urllib.request.Request(
        url, body, {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status


def timeline(trace_id: str) -> List[dict]:
    """Every span of one trace, in causal order: parents before children,
    siblings by start time.  Works on the merged ring, so after plugin/
    monitor feeds are ingested this is the full cross-component pod
    lifecycle (the /timeline?pod=<uid> endpoint)."""
    with _lock:
        mine = [s for s in _spans if s.get("trace_id") == trace_id]
    by_id: Dict[object, dict] = {}
    for s in mine:
        if s.get("span_id") is not None:
            by_id[_span_key(s)] = s

    def depth(s: dict, hops: int = 0) -> int:
        # parent links are process-local span ids; resolve within the
        # same process first, falling back to any (cross-process links
        # carry the parent's id from the propagated context token)
        if hops > len(mine):
            return hops  # cycle guard: corrupt feeds must not hang
        parent = s.get("parent")
        if parent is None:
            return 0
        p = by_id.get((_span_key(s)[0], parent))
        if p is None or p is s:
            candidates = [
                v for (proc, sid), v in by_id.items()
                if sid == parent and v is not s
            ]
            p = candidates[0] if candidates else None
        if p is None:
            return 1
        return depth(p, hops + 1) + 1

    return sorted(mine, key=lambda s: (depth(s), s.get("start", 0)))


def export_chrome(spans: Optional[Iterable[dict]] = None) -> str:
    """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto /
    ``ui.perfetto.dev`` load format) for ``spans`` (default: the whole
    ring).  Complete events (``ph="X"``) with microsecond timestamps."""
    events = []
    for sp in (recent_spans(_RING_SIZE) if spans is None else spans):
        if "start" not in sp:
            continue
        args = {
            k: v for k, v in sp.items()
            if k not in ("name", "start", "dur_ms", "pid", "tid")
        }
        events.append({
            "name": sp.get("name", "?"),
            "ph": "X",
            "ts": round(float(sp["start"]) * 1e6, 3),
            "dur": round(float(sp.get("dur_ms", 0)) * 1e3, 3),
            "pid": sp.get("pid", 0),
            "tid": sp.get("tid", 0),
            "cat": "vtpu",
            "args": args,
        })
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      default=str)
