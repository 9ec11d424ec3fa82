"""Wire-level K/V handoff: the port's copy of the wire half of
``vtpu/serving/transport.py`` (the port imports nothing of vtpu).

A leased handle's blocks are serialized into fixed-size **chunks**
(versioned binary framing, crc-guarded) and streamed over a link (in
process, or keep-alive HTTP) into pre-leased destination blocks, adopted
chunk by chunk so the slot binds on the last chunk's arrival.  Frames
are byte-identical to the JAX package's, and refusals travel by class
**name** (``_ERROR_TYPES``): the port cannot subclass vtpu's errors, so
an HTTP peer of either package maps a refusal of the other to its own
class of the same name.

Protocol:

- **Framing**: ``header ‖ meta-JSON ‖ payload``; a fixed header (magic,
  version, kind, flags, seq, chunk count, block offset, block count,
  lengths, payload crc32, 16-byte stream id).  Frame 0 (``seq=0``) is
  the OPEN, carrying the handle's wire document and the pool layout
  digest; data chunks are ``seq 1..nchunks``, FIN flagged on the last.
- **Credits**: the receiver pre-leases destination blocks and grants
  their count; the sender never ships past the grant, so a full decode
  pool backpressures the stream.
- **Resume**: a torn connection resyncs at chunk granularity (a RESUME
  frame on a fresh connection); a replayed chunk is a typed
  ``DuplicateChunkError``.
- **Abort**: a stream that cannot finish releases both pools' blocks;
  the receiver remembers consumed ``(pool, stamp)`` pairs, so a reused
  stamp is refused.

Instead of the JAX package's metrics, :meth:`ReceiverHub.stats` and the
sender's attributes count bytes, chunks, streams and resumes; request
ledger and trace marks come with the observability slice.  The device
work lives behind the engines' ``start_extract`` / ``wire_*`` surfaces
(``vtpu_torch/serving/disagg.py``).
"""

from __future__ import annotations

import collections
import http.client
import json
import logging
import struct
import threading
import time
import urllib.parse
import uuid
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from vtpu_torch.serving import wirecodec
from vtpu_torch.serving.kvpool import (
    KVHandle,
    KVHandoffError,
    PoolMismatchError,
    StaleHandleError,
)
from vtpu_torch.utils.envs import env_int

log = logging.getLogger(__name__)

__all__ = [
    "CodecMismatchError",
    "CreditOverrunError",
    "DuplicateChunkError",
    "Frame",
    "HttpKVLink",
    "LoopbackLink",
    "OutOfOrderChunkError",
    "ReceiverHub",
    "ReplicaSaturatedError",
    "StreamAbortedError",
    "StreamSender",
    "TruncatedChunkError",
    "VersionSkewError",
    "WireError",
    "WireReplica",
    "decode_frame",
    "encode_frame",
]

MAGIC = b"VKVW"
VERSION = 1

KIND_DATA = 0
KIND_RESUME = 1
KIND_ABORT = 2
KIND_STATS = 3
KIND_PING = 4
# additive (the framing versions kinds): a data chunk whose payload is
# the blockwise-int8 encoding (vtpu_torch/serving/wirecodec.py) instead of
# raw pool bytes.  Negotiated at OPEN — an old receiver never sees one.
KIND_DATA_QUANT = 5
# sub-byte codecs (same negotiation, same fallback): fp8 payloads are
# e4m3 bytes + per-block f32 scales; int4 payloads are nibble-packed
# two-per-byte + per-block f32 scales
KIND_DATA_FP8 = 6
KIND_DATA_INT4 = 7

_DATA_KINDS = (KIND_DATA, KIND_DATA_QUANT, KIND_DATA_FP8, KIND_DATA_INT4)

# the single source of truth for codec → data-chunk kind: both the
# receiver's expected-kind check and the sender's frame emission look
# here, so a new codec cannot drift the two ends apart
KIND_FOR_CODEC = {
    wirecodec.CODEC_FP32: KIND_DATA,
    wirecodec.CODEC_INT8: KIND_DATA_QUANT,
    wirecodec.CODEC_FP8: KIND_DATA_FP8,
    wirecodec.CODEC_INT4: KIND_DATA_INT4,
}

FLAG_FIN = 0x01

# magic, version, kind, flags, seq, nchunks, block_off, nblocks,
# meta_len, payload_len, payload crc32, stream id
_HDR = struct.Struct("<4sHBBIIIHHQI16s")

DEFAULT_CHUNK_BLOCKS = env_int("VTPU_KV_CHUNK_BLOCKS", 4)
DEFAULT_STREAM_RETRIES = env_int("VTPU_KV_STREAM_RETRIES", 2)
DEFAULT_STAMP_CAP = env_int("VTPU_KV_STAMP_CACHE_CAP", 4096)


class WireError(KVHandoffError):
    """Base class for wire-transport protocol violations."""


class TruncatedChunkError(WireError):
    """A frame shorter than its header claims (or failing its payload
    crc, or FIN arriving before every block) — a torn or corrupt read."""


class VersionSkewError(WireError):
    """The frame's protocol version does not match this endpoint's."""


class OutOfOrderChunkError(WireError):
    """A data chunk arrived ahead of the receiver's expected sequence."""


class DuplicateChunkError(WireError):
    """A data chunk the receiver already applied was replayed (a resume
    that ignored the receiver's next-expected offset)."""


class CreditOverrunError(WireError):
    """The sender shipped blocks past the receiver's credit grant."""


class StreamAbortedError(WireError):
    """The stream cannot continue (peer aborted, unknown stream after a
    receiver-side abort, or retries exhausted)."""


class CodecMismatchError(WireError):
    """A data chunk's kind disagrees with the codec negotiated for its
    stream at OPEN (e.g. a sender switching to fp32 frames mid-stream
    after a resume, on a stream the receiver accepted as int8) —
    applying it would scatter misparsed bytes into the pool."""


class ReplicaSaturatedError(WireError):
    """The receiver could not pre-lease any destination blocks — the
    decode pool is full.  Backpressure, not failure: the router parks
    the handoff and retries once blocks free."""


# typed-error round trip over non-raising links (HTTP): the server maps
# a WireError to its class name, the client maps the name back (the
# session mover's errors join the table: vtpu_torch/serving/migrate.py)
_ERROR_TYPES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        TruncatedChunkError, VersionSkewError, OutOfOrderChunkError,
        DuplicateChunkError, CreditOverrunError, StreamAbortedError,
        ReplicaSaturatedError, CodecMismatchError, StaleHandleError,
        PoolMismatchError, WireError, KVHandoffError,
    )
}


def raise_wire_error(doc: dict) -> None:
    """Re-raise a typed error from a peer's error response doc."""
    cls = _ERROR_TYPES.get(doc.get("error", ""), WireError)
    raise cls(doc.get("detail", doc.get("error", "wire error")))


class Frame:
    """One decoded wire frame."""

    __slots__ = ("kind", "flags", "seq", "nchunks", "block_off",
                 "nblocks", "sid", "meta", "payload")

    def __init__(self, kind, flags, seq, nchunks, block_off, nblocks,
                 sid, meta, payload):
        self.kind = kind
        self.flags = flags
        self.seq = seq
        self.nchunks = nchunks
        self.block_off = block_off
        self.nblocks = nblocks
        self.sid = sid
        self.meta = meta
        self.payload = payload


def encode_frame(
    kind: int,
    sid: bytes,
    *,
    seq: int = 0,
    nchunks: int = 0,
    block_off: int = 0,
    nblocks: int = 0,
    flags: int = 0,
    meta: Optional[dict] = None,
    payload: bytes = b"",
) -> bytes:
    meta_b = json.dumps(meta, sort_keys=True).encode() if meta else b""
    hdr = _HDR.pack(
        MAGIC, VERSION, kind, flags, seq, nchunks, block_off, nblocks,
        len(meta_b), len(payload), zlib.crc32(payload) & 0xFFFFFFFF, sid,
    )
    return hdr + meta_b + payload


def decode_frame(data: bytes) -> Frame:
    if len(data) < _HDR.size:
        raise TruncatedChunkError(
            f"frame shorter than the fixed header "
            f"({len(data)} < {_HDR.size} bytes)"
        )
    (magic, version, kind, flags, seq, nchunks, block_off, nblocks,
     meta_len, payload_len, crc, sid) = _HDR.unpack_from(data)
    if magic != MAGIC:
        raise WireError(f"not a K/V wire frame (magic {magic!r})")
    if version != VERSION:
        raise VersionSkewError(
            f"peer speaks wire version {version}, this endpoint "
            f"speaks {VERSION}"
        )
    if len(data) != _HDR.size + meta_len + payload_len:
        raise TruncatedChunkError(
            f"frame length {len(data)} != header-declared "
            f"{_HDR.size + meta_len + payload_len}"
        )
    meta_b = data[_HDR.size:_HDR.size + meta_len]
    payload = data[_HDR.size + meta_len:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise TruncatedChunkError("payload crc mismatch (corrupt chunk)")
    meta = None
    if meta_len:
        try:
            meta = json.loads(meta_b)
        except ValueError as e:
            raise WireError(f"malformed frame meta: {e}") from e
    return Frame(kind, flags, seq, nchunks, block_off, nblocks, sid,
                 meta, payload)


# ---------------------------------------------------------------------------
# Receiver side
# ---------------------------------------------------------------------------

class _RxStream:
    __slots__ = ("sid", "rid", "meta", "ctx", "nchunks", "next_seq",
                 "total_blocks", "received_blocks", "credits",
                 "stamp_key", "codec", "skip")

    def __init__(self, sid, rid, meta, ctx, nchunks, total_blocks,
                 credits, stamp_key, codec, skip=0):
        self.sid = sid
        self.rid = rid
        self.meta = meta
        self.ctx = ctx
        self.nchunks = nchunks
        self.next_seq = 1
        # blocks the sender actually SHIPS: the handle total minus the
        # skip count the sink negotiated at OPEN (suffix-only session
        # migration — the receiver's pool already holds the prefix)
        self.total_blocks = total_blocks
        self.received_blocks = 0
        self.credits = credits
        self.stamp_key = stamp_key
        self.codec = codec
        self.skip = skip

    def echo(self) -> dict:
        """Stream facts every RESUME response re-states so a re-synced
        sender can never drift off what OPEN negotiated: the codec, the
        suffix skip, and (for session streams) the session doc."""
        doc = {"codec": self.codec, "skip_blocks": self.skip}
        sess = (self.meta or {}).get("session")
        if sess is not None:
            doc["session"] = sess
        return doc


class ReceiverHub:
    """Decode-side endpoint: demultiplexes frames into per-stream state
    against a wire *sink* — anything exposing the engine surface
    ``wire_open / wire_write / wire_top_up / wire_finish / wire_abort``
    plus ``stats()`` / ``ping()`` (:class:`vtpu_torch.serving.disagg.
    DecodeEngine` implements it, and so does the JAX package's).

    Every protocol violation aborts the offending stream FIRST (both
    pools leak-free) and then raises the typed error, so an in-process
    caller gets the exception and an HTTP server wraps it into the
    typed-error response doc."""

    def __init__(self, sink, *, stamp_cap: int = 0) -> None:
        self.sink = sink
        self._streams: Dict[bytes, _RxStream] = {}
        # consumed (pool, stamp) pairs: a handle is adoptable exactly
        # once, across transports too — a second OPEN with a stamp this
        # receiver has already seen is the mid-stream-reuse attack the
        # StaleHandleError protocol exists to stop.  Bounded FIFO.
        self._stamps: "collections.OrderedDict[Tuple[str, int], bytes]" = (
            collections.OrderedDict()
        )
        # finished-stream tombstones (sid → nchunks): a sender whose
        # FIN *response* was lost on a torn connection resumes and must
        # learn "that stream completed" — answering "gone" (the abort
        # reply) would make it abort a transfer that succeeded, and the
        # deployment would retry an already-decoding request.  Bounded
        # FIFO like the stamp cache.
        self._fins: "collections.OrderedDict[bytes, int]" = (
            collections.OrderedDict()
        )
        self._stamp_cap = stamp_cap or DEFAULT_STAMP_CAP
        self._lock = threading.RLock()
        # bytes / chunks applied, streams by outcome, payload bytes by
        # codec, stale stamps refused
        self.counters: "collections.Counter[str]" = collections.Counter()

    # -- bookkeeping ----------------------------------------------------
    def stats(self) -> dict:
        """The hub's counters, and the credits granted to live streams
        and not yet used."""
        with self._lock:
            return {**self.counters, "open_streams": len(self._streams),
                    "inflight_credits": sum(
                        max(0, s.credits - s.received_blocks)
                        for s in self._streams.values())}

    def open_streams(self) -> int:
        with self._lock:
            return len(self._streams)

    def _abort_stream(self, st: _RxStream,
                      error: str = "stream aborted") -> None:
        self._streams.pop(st.sid, None)
        try:
            self.sink.wire_abort(st.ctx)
        except Exception:  # noqa: BLE001 — abort must not mask the cause
            log.exception("kv wire: sink abort failed for %s (%s)",
                          st.rid, error)

    def abort_all(self) -> None:
        """Receiver-side teardown (replica shutdown): release every
        partial adoption."""
        with self._lock:
            for st in list(self._streams.values()):
                self._abort_stream(st, error="receiver shutdown")
                self.counters["streams_aborted"] += 1

    # -- frame handling -------------------------------------------------
    def handle(self, data: bytes) -> dict:
        frame = decode_frame(data)
        with self._lock:
            if frame.kind == KIND_PING:
                return {"status": "ok", "ping": bool(self.sink.ping())}
            if frame.kind == KIND_STATS:
                st = dict(self.sink.stats())
                st["wire_streams"] = len(self._streams)
                return {"status": "ok", "stats": st}
            if frame.kind == KIND_ABORT:
                st = self._streams.get(frame.sid)
                if st is not None:
                    self._abort_stream(st, error="peer abort")
                    self.counters["streams_aborted"] += 1
                return {"status": "ok"}
            if frame.kind == KIND_RESUME:
                st = self._streams.get(frame.sid)
                if st is None:
                    nchunks = self._fins.get(frame.sid)
                    if nchunks is not None:
                        return {"status": "fin", "next": nchunks + 1,
                                "credits": 0}
                    return {"status": "gone"}
                # RESUME doubles as the credit poll: a starved sender
                # re-asks here, so blocks freed since the last data
                # frame become credits without an extra frame kind
                if st.credits < st.total_blocks:
                    st.credits = int(self.sink.wire_top_up(st.ctx))
                # every RESUME response re-echoes what OPEN negotiated
                # (codec, suffix skip, session doc) so a re-synced
                # sender can never drift onto the wrong chunk kind or
                # block offset mid-stream
                return {"status": "ok", "next": st.next_seq,
                        "credits": st.credits, **st.echo()}
            if frame.kind not in _DATA_KINDS:
                raise WireError(f"unknown frame kind {frame.kind}")
            if frame.seq == 0:
                if frame.kind != KIND_DATA:
                    raise WireError(
                        "stream OPEN must be a KIND_DATA frame (codec "
                        "selection is meta-negotiated, not kind 0)"
                    )
                return self._open(frame)
            return self._data(frame)

    def _open(self, frame: Frame) -> dict:
        meta = frame.meta or {}
        try:
            handle = KVHandle.from_wire(meta["handle"])
            rid = str(meta["rid"])
            layout = meta["layout"]
            chunk_blocks = int(meta.get("chunk_blocks",
                                        DEFAULT_CHUNK_BLOCKS))
        except (KeyError, TypeError, KVHandoffError) as e:
            raise WireError(f"malformed stream OPEN meta: {e}") from e
        if frame.sid in self._streams:
            raise DuplicateChunkError(
                f"stream {frame.sid.hex()} already open"
            )
        stamp_key = (handle.pool_id, handle.stamp)
        if stamp_key in self._stamps:
            self.counters["stale"] += 1
            raise StaleHandleError(
                f"handle stamp {handle.stamp} from pool "
                f"{handle.pool_id} was already streamed to this "
                f"receiver (mid-stream stamp reuse)"
            )
        total = len(handle.blocks)
        # codec negotiation: accept the advertised codec when the sink
        # supports it, else fall back to fp32.  An OLD sender (no codec
        # key) gets fp32; an old RECEIVER never reaches here with quant
        # state because it simply omits "codec" from its response and
        # the sender falls back.
        advertised = str(meta.get("codec", wirecodec.CODEC_FP32))
        supported = tuple(getattr(
            self.sink, "wire_codecs", lambda: (wirecodec.CODEC_FP32,)
        )())
        codec = wirecodec.negotiate(advertised, supported)
        ctx = self.sink.wire_open(rid, total, layout, chunk_blocks,
                                  codec=codec, meta=meta)
        if ctx is None:
            self.counters["streams_saturated"] += 1
            return {"status": "saturated", "credits": 0}
        credits = int(self.sink.wire_credits(ctx))
        # suffix-only negotiation (session migration): the sink may
        # report that its pool already holds the handle's leading
        # ``skip`` blocks (matched by chain digest) — only the suffix
        # ships, so the hub's chunk accounting runs over the suffix and
        # the sender is told to recompute its chunk plan from the same
        # number.  A sink that never skips (skip 0) is byte-identical
        # to the plain protocol, frame for frame.
        skip = int(ctx.get("skip", 0)) if isinstance(ctx, dict) else 0
        skip = max(0, min(skip, total - 1)) if total else 0
        suffix = total - skip
        nchunks = -(-suffix // max(1, chunk_blocks)) if suffix else 0
        st = _RxStream(frame.sid, rid, meta, ctx, nchunks, suffix,
                       credits, stamp_key, codec,
                       skip=skip)
        self._streams[frame.sid] = st
        self._stamps[stamp_key] = frame.sid
        while len(self._stamps) > self._stamp_cap:
            self._stamps.popitem(last=False)
        return {"status": "ok", "next": 1, "credits": credits,
                **st.echo()}

    def _data(self, frame: Frame) -> dict:
        st = self._streams.get(frame.sid)
        if st is None:
            raise StreamAbortedError(
                f"no such stream {frame.sid.hex()} (aborted, finished, "
                f"or never opened)"
            )
        try:
            want_kind = KIND_FOR_CODEC.get(st.codec, KIND_DATA)
            if frame.kind != want_kind:
                raise CodecMismatchError(
                    f"chunk kind {frame.kind} on a stream that "
                    f"negotiated codec {st.codec!r} at OPEN"
                )
            if frame.seq < st.next_seq:
                raise DuplicateChunkError(
                    f"chunk {frame.seq} already applied "
                    f"(next expected: {st.next_seq})"
                )
            if frame.seq > st.next_seq:
                raise OutOfOrderChunkError(
                    f"chunk {frame.seq} ahead of expected {st.next_seq}"
                )
            if frame.block_off != st.received_blocks:
                raise OutOfOrderChunkError(
                    f"chunk block offset {frame.block_off} != received "
                    f"{st.received_blocks}"
                )
            end = frame.block_off + frame.nblocks
            if end > st.total_blocks:
                raise TruncatedChunkError(
                    f"chunk spills past the handle "
                    f"({end} > {st.total_blocks} blocks)"
                )
            if end > st.credits:
                raise CreditOverrunError(
                    f"chunk reaches block {end} past the credit grant "
                    f"{st.credits}"
                )
            try:
                self.sink.wire_write(st.ctx, frame.block_off,
                                     frame.nblocks, frame.payload)
            except WireError:
                raise
            except Exception as e:  # sink-side shape/size mismatch
                raise TruncatedChunkError(
                    f"chunk payload rejected by the pool sink: {e}"
                ) from e
            st.next_seq = frame.seq + 1
            st.received_blocks = end
            self.counters["chunks"] += 1
            self.counters["bytes"] += len(frame.payload)
            self.counters[f"bytes_{st.codec}"] += len(frame.payload)
            if frame.flags & FLAG_FIN:
                if (frame.seq != st.nchunks
                        or st.received_blocks != st.total_blocks):
                    raise TruncatedChunkError(
                        f"FIN at chunk {frame.seq}/{st.nchunks} with "
                        f"{st.received_blocks}/{st.total_blocks} blocks"
                    )
                self._streams.pop(st.sid, None)
                self.sink.wire_finish(st.ctx, st.meta)
                self._fins[st.sid] = st.nchunks
                while len(self._fins) > self._stamp_cap:
                    self._fins.popitem(last=False)
                self.counters["streams_ok"] += 1
                return {"status": "ok", "next": st.next_seq,
                        "credits": st.credits, "fin": True}
            if st.credits < st.total_blocks:
                st.credits = int(self.sink.wire_top_up(st.ctx))
            return {"status": "ok", "next": st.next_seq,
                    "credits": st.credits}
        except WireError as e:
            # protocol violations tear the stream down leak-free BEFORE
            # propagating — a half-adopted handle must never pin blocks
            self._abort_stream(st, error=f"{type(e).__name__}: {e}")
            self.counters["streams_aborted"] += 1
            raise

    def top_up(self) -> None:
        """Re-ask the sink for credits on every starved stream (the
        decode engine's pump calls this as slots retire)."""
        with self._lock:
            for st in self._streams.values():
                if st.credits < st.total_blocks:
                    st.credits = int(self.sink.wire_top_up(st.ctx))


# ---------------------------------------------------------------------------
# Links
# ---------------------------------------------------------------------------

class LoopbackLink:
    """In-process link: frames go straight into a :class:`ReceiverHub`.
    ``fault`` (optional) is called with each outgoing frame's bytes and
    may raise to simulate a torn connection — the sender's retry/resume
    path is exercised without sockets or sleeps."""

    def __init__(self, hub: ReceiverHub,
                 fault: Optional[Callable[[bytes], None]] = None) -> None:
        self.hub = hub
        self.fault = fault

    def send(self, data: bytes, fresh: bool = False) -> dict:
        if self.fault is not None and not fresh:
            self.fault(data)
        return self.hub.handle(data)

    def close(self) -> None:
        pass


class HttpKVLink:
    """Persistent keep-alive HTTP link to a remote receiver endpoint
    (``POST /kv/stream``, binary frame body → JSON response).  Same
    pooled-connection discipline as the sharded extender's
    :class:`~vtpu.scheduler.shard.HttpPeer`: a bounded idle pool of
    ``http.client`` connections reused across frames; a stale keep-alive
    failure closes the connection and surfaces to the sender, whose
    chunk-level RESUME (on a ``fresh=True`` pooled-bypass connection)
    owns the retry — the link itself never replays a frame, because a
    data chunk whose response was lost may have been applied and a blind
    replay would be the DuplicateChunkError the protocol rejects."""

    def __init__(self, base_url: str, timeout_s: float = 5.0,
                 pool_size: int = 2, path: str = "/kv/stream") -> None:
        self.base_url = base_url.rstrip("/")
        self.path = path
        self.timeout_s = timeout_s
        self.pool_size = max(1, pool_size)
        u = urllib.parse.urlsplit(self.base_url)
        if u.scheme != "http":
            raise ValueError(
                f"HttpKVLink speaks plain http in-cluster, got "
                f"{self.base_url!r}"
            )
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self._lock = threading.Lock()
        self._idle: collections.deque = collections.deque()

    def _acquire(self, fresh: bool):
        if not fresh:
            with self._lock:
                if self._idle:
                    return self._idle.pop()
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self.timeout_s
        )

    def _release(self, conn) -> None:
        with self._lock:
            if len(self._idle) < self.pool_size:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            while self._idle:
                self._idle.pop().close()

    def send(self, data: bytes, fresh: bool = False) -> dict:
        conn = self._acquire(fresh)
        try:
            conn.request("POST", self.path, data,
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.will_close:
                conn.close()
            else:
                self._release(conn)
        except (http.client.HTTPException, OSError):
            conn.close()
            raise
        doc = json.loads(body or b"{}")
        if doc.get("status") == "error":
            raise_wire_error(doc)
        return doc


def handle_http_frame(hub: ReceiverHub, body: bytes) -> Tuple[int, dict]:
    """Server-side glue for an HTTP listener: one frame in, one
    ``(http status, response doc)`` out, typed errors mapped to the
    error-doc form :func:`raise_wire_error` reverses."""
    try:
        return 200, hub.handle(body)
    except WireError as e:
        return 400, {"status": "error", "error": type(e).__name__,
                     "detail": str(e)}
    except KVHandoffError as e:
        return 409, {"status": "error", "error": type(e).__name__,
                     "detail": str(e)}


# ---------------------------------------------------------------------------
# Sender side
# ---------------------------------------------------------------------------

class StreamSender:
    """One outbound K/V stream: chunks an extract's host bytes under the
    receiver's credit grant, resumes at chunk granularity on a torn
    connection, and aborts leak-free when retries exhaust.

    ``extract`` is the prefill engine's async D2H handle
    (:meth:`vtpu_torch.serving.disagg.PrefillEngine.start_extract`):
    ``ready_blocks()`` says how many leading blocks have landed on the
    host (chunks ship as the copy completes, behind the next prefill
    window), ``payload(lo, hi)`` yields their bytes.
    ``on_done(ok)`` releases the source pool's blocks either way."""

    def __init__(
        self,
        link,
        rid: str,
        handle: KVHandle,
        extract=None,
        *,
        layout: Optional[list] = None,
        meta_extra: Optional[dict] = None,
        chunk_blocks: int = 0,
        retries: int = 0,
        on_done: Optional[Callable[[bool], None]] = None,
        extract_fn: Optional[Callable[[], object]] = None,
        codec: str = "",
    ) -> None:
        self.link = link
        self.rid = rid
        self.handle = handle
        # the codec this sender ADVERTISES in the OPEN meta; the
        # receiver's answer (or its absence — an old receiver) settles
        # self.codec before the first data chunk ships, and before the
        # deferred extract_fn runs, so the extract encodes the codec
        # the receiver actually accepted
        self.advertise = codec or wirecodec.DEFAULT_CODEC
        self.codec = wirecodec.CODEC_FP32
        # the extract may attach AFTER open(): the OPEN must precede the
        # source-pool claim (a saturated receiver leaves the handle
        # adoptable for a later retry), and the claim precedes the D2H.
        # ``extract_fn`` defers even the gather DISPATCH to the first
        # pump — the pump thread owns the device extract, so its cost
        # lands under the next prefill window instead of serializing
        # with the submit path (claimed blocks are never written by
        # later pool programs, so the late gather reads stable rows)
        self.extract = extract
        self.extract_fn = extract_fn
        self.chunk_blocks = chunk_blocks or DEFAULT_CHUNK_BLOCKS
        self.retries = retries or DEFAULT_STREAM_RETRIES
        self.on_done = on_done
        self.sid = uuid.uuid4().bytes
        total = len(handle.blocks)
        self.nchunks = -(-total // self.chunk_blocks) if total else 0
        self.meta = {
            "rid": rid,
            "handle": handle.to_wire(),
            "layout": (layout if layout is not None
                       else extract.layout() if extract is not None
                       else []),
            "chunk_blocks": self.chunk_blocks,
            "codec": self.advertise,
            **(meta_extra or {}),
        }
        self._next = 0            # 0 = OPEN not yet acked
        self._credits = 0
        self._resumes = 0         # per-stream budget: retries total
        self.sent_bytes = 0       # payload bytes shipped
        self.finished_at = 0.0    # perf_counter stamp of final ack/abort
        self.done = False
        self.aborted = False
        # suffix-only (session migration): leading handle blocks the
        # receiver already holds — settled by the OPEN ack, before the
        # deferred extract_fn runs, so the extract gathers only
        # ``handle.blocks[skip:]`` and payload offsets are
        # suffix-relative on both ends
        self.skip = 0
        # outcome disambiguation for the caller: ``fin_unacked`` is
        # True exactly while a sent FIN chunk has no response — a
        # stream that aborts in that window MAY have been applied by
        # the receiver (the torn response could have carried the final
        # ack), and a session mover must fail loudly instead of
        # restoring the session on the source (never duplicate).
        # ``receiver_gone`` means the receiver positively answered
        # "gone" (its side aborted): the transfer did NOT apply.
        self.fin_unacked = False
        self.receiver_gone = False

    # -- wire I/O with resume -------------------------------------------
    def _send(self, data: bytes) -> dict:
        """One frame with chunk-level resume: a torn connection re-syncs
        to the receiver's next-expected seq on a fresh connection and
        either skips (the lost response was applied) or re-raises for
        the caller to retry the pump."""
        try:
            return self.link.send(data)
        except (OSError, http.client.HTTPException) as e:
            last: Exception = e
        # the resume budget is PER STREAM, not per frame: a link that
        # tears every data frame but still answers RESUME must not spin
        # forever — after ``retries`` total resumes the stream aborts
        while self._resumes < self.retries:
            self._resumes += 1
            try:
                rsp = self.link.send(
                    encode_frame(KIND_RESUME, self.sid), fresh=True
                )
            except (OSError, http.client.HTTPException) as e:
                last = e
                continue
            if rsp.get("status") == "gone":
                self.receiver_gone = True  # positively NOT applied
                self.fin_unacked = False
                self.abort(notify=False)
                raise StreamAbortedError(
                    f"stream for {self.rid} gone at the receiver "
                    f"(aborted remotely)"
                )
            # "fin": the torn frame WAS the FIN and it applied — the
            # receiver's tombstone confirms completion, so the pump loop
            # terminates and the stream finishes normally (no abort, no
            # deployment-level retry of an already-decoding request)
            self._next = int(rsp.get("next", self._next))
            self._credits = int(rsp.get("credits", self._credits))
            # re-sync to what OPEN negotiated: a resumed sender must
            # never drift onto the other chunk kind (CodecMismatchError
            # at the receiver) or block-offset base mid-stream
            self.codec = str(rsp.get("codec", self.codec))
            self.skip = int(rsp.get("skip_blocks", self.skip))
            # session streams: the echoed doc must be OURS — a receiver
            # restart could have a different stream under this sid, and
            # resuming chunks into a stranger's session scatters wrong
            # K/V.  Drift aborts typed instead.
            echoed = rsp.get("session")
            mine = (self.meta or {}).get("session")
            if (mine is not None and echoed is not None
                    and echoed != mine):
                self.abort()
                raise StreamAbortedError(
                    f"stream for {self.rid}: RESUME echoed a foreign "
                    f"session doc (receiver state replaced?)"
                )
            if int(rsp.get("next", 0)) <= self.nchunks:
                # the receiver's authoritative next-expected seq proves
                # the FIN (if one was in flight) did NOT apply
                self.fin_unacked = False
            return rsp
        self.abort()
        raise StreamAbortedError(
            f"stream for {self.rid}: resume retries exhausted"
        ) from last

    def open(self) -> None:
        """Send the OPEN frame; raises :class:`ReplicaSaturatedError`
        when the receiver cannot pre-lease a single block (the caller
        parks the handoff — nothing was claimed or leaked)."""
        rsp = self._send(encode_frame(
            KIND_DATA, self.sid, seq=0, nchunks=self.nchunks,
            meta=self.meta,
        ))
        if rsp.get("status") == "saturated":
            raise ReplicaSaturatedError(
                f"receiver pool saturated for {self.rid}"
            )
        self._next = int(rsp.get("next", 1))
        self._credits = int(rsp.get("credits", 0))
        # an old receiver answers without a codec key → fp32 fallback;
        # a new one echoes what it accepted (the advertised codec, or
        # its own fp32 fallback)
        self.codec = str(rsp.get("codec", wirecodec.CODEC_FP32))
        # suffix-only ack: the receiver already holds the leading
        # ``skip_blocks`` (digest-matched in its pool) — re-plan the
        # chunk schedule over the suffix.  The caller's deferred
        # extract_fn (which runs at the first pump, after this ack)
        # must gather ``handle.blocks[self.skip:]``.
        self.skip = int(rsp.get("skip_blocks", 0))
        if self.skip:
            if self.extract is not None:
                # a preset extract covers EVERY block and would ship
                # mis-offset payloads against the receiver's suffix
                # plan — only extract_fn senders may carry a chain
                self.abort()
                raise WireError(
                    f"stream for {self.rid}: suffix-only OPEN "
                    f"(skip {self.skip}) needs a deferred extract_fn"
                )
            suffix = len(self.handle.blocks) - self.skip
            self.nchunks = (-(-suffix // self.chunk_blocks)
                            if suffix > 0 else 0)

    def pump(self) -> bool:
        """Push every chunk the credit grant and the D2H readiness
        allow.  Returns True when the stream finished this call."""
        if self.done or self.aborted:
            return self.done
        if self._next == 0:
            self.open()
        if self.extract is None:
            if self.extract_fn is None:
                return False  # not yet extracted (caller's turn)
            self.extract = self.extract_fn()
            self.extract_fn = None
        # suffix-relative plan: block offsets, payload slices, and the
        # credit grant all count SHIPPED blocks (handle total − skip);
        # with skip 0 this is the plain whole-handle plan
        total = len(self.handle.blocks) - self.skip
        while self._next <= self.nchunks:
            lo = (self._next - 1) * self.chunk_blocks
            hi = min(lo + self.chunk_blocks, total)
            if hi > self._credits:
                # ask for a fresh grant (slots may have retired);
                # still starved → backpressure, try next pump
                rsp = self._send(encode_frame(KIND_RESUME, self.sid))
                status = rsp.get("status")
                if status == "gone":
                    self.receiver_gone = True
                    self.abort(notify=False)
                    raise StreamAbortedError(
                        f"stream for {self.rid} gone at the receiver"
                    )
                if status == "fin":  # lost-FIN-ack resync: done
                    self._next = self.nchunks + 1
                    self.fin_unacked = False
                    break
                self._credits = int(rsp.get("credits", self._credits))
                if hi > self._credits:
                    return False
            if self.extract.ready_blocks() < hi:
                return False  # D2H still in flight; ride next pump
            payload = self.extract.payload(lo, hi)
            fin = self._next == self.nchunks
            kind = KIND_FOR_CODEC.get(self.codec, KIND_DATA)
            if fin:
                # from the send to the response, an abort is
                # AMBIGUOUS: the receiver may have applied the FIN
                # and lost only the ack (the caller must not assume
                # the transfer failed — see fin_unacked)
                self.fin_unacked = True
            rsp = self._send(encode_frame(
                kind, self.sid, seq=self._next,
                nchunks=self.nchunks, block_off=lo, nblocks=hi - lo,
                flags=FLAG_FIN if fin else 0, payload=payload,
            ))
            self.fin_unacked = False
            self.sent_bytes += len(payload)
            self._next = int(rsp.get("next", self._next + 1))
            self._credits = int(rsp.get("credits", self._credits))
        self._finish()
        return True

    def _finish(self) -> None:
        self.done = True
        self.finished_at = time.perf_counter()
        if self.on_done is not None:
            self.on_done(True)

    def abort(self, notify: bool = True) -> None:
        """Release the source side (and best-effort tell the receiver):
        a stream that dies mid-flight leaks nothing on either pool."""
        if self.done or self.aborted:
            return
        self.aborted = True
        self.finished_at = time.perf_counter()
        if notify:
            try:
                self.link.send(encode_frame(KIND_ABORT, self.sid),
                               fresh=True)
            except Exception:  # noqa: BLE001 — receiver may be dead too
                log.debug("kv wire: abort notify failed for %s",
                          self.rid, exc_info=True)
        if self.on_done is not None:
            self.on_done(False)


# ---------------------------------------------------------------------------
# The router-facing replica proxy
# ---------------------------------------------------------------------------

class WireReplica:
    """A decode replica reached over the wire transport — duck-type
    compatible with the router's replica surface (``submit_handle`` /
    ``step`` / ``stats`` / ``ping``), so the front door needs no special
    casing: a handoff to a WireReplica claims the handle from the source
    pool, starts the async D2H extract, and streams chunks on subsequent
    ``step()`` calls (the router's pump), overlapped with whatever the
    prefill engine computes next.

    ``local`` (loopback topologies: tests, the chip smoke, co-located
    processes) is the in-process decode engine behind the hub — its
    ``step()``/transcripts are driven/read directly.  Over HTTP the
    remote process drives its own engine and ``out`` is collected by the
    deployment, not the router."""

    def __init__(self, link, replica_id: str, *, local=None,
                 chunk_blocks: int = 0, retries: int = 0,
                 codec: str = "") -> None:
        self.link = link
        self.replica_id = replica_id
        self._local = local
        self.chunk_blocks = chunk_blocks or DEFAULT_CHUNK_BLOCKS
        self.retries = retries or DEFAULT_STREAM_RETRIES
        # advertised to each stream's receiver; fp32 stays the token-
        # exact default (VTPU_KV_WIRE_CODEC flips the fleet)
        self.codec = codec or wirecodec.DEFAULT_CODEC
        self._senders: List[StreamSender] = []

    # -- router surface -------------------------------------------------
    def ping(self) -> bool:
        rsp = self.link.send(encode_frame(KIND_PING, b"\0" * 16))
        return bool(rsp.get("ping"))

    def stats(self) -> dict:
        rsp = self.link.send(encode_frame(KIND_STATS, b"\0" * 16))
        st = dict(rsp.get("stats") or {})
        st["wire_senders"] = len(self._senders)
        # in-flight streams are uncollected work the admission
        # controller must see, exactly like claimed-but-unslotted handles
        st["queued"] = int(st.get("queued", 0)) + len(self._senders)
        return st

    # the router hands digest chains to replicas that declare support
    accepts_chain = True

    def submit_handle(self, rid: str, handle: KVHandle, first_token: int,
                      num_new: int, source=None, submitted: float = 0.0,
                      admit: bool = True,
                      chain: Optional[list] = None) -> None:
        if source is None or getattr(source, "pool", None) is None \
                or source.pool.pool_id != handle.pool_id:
            raise PoolMismatchError(
                f"wire handoff of a handle from pool {handle.pool_id!r} "
                f"needs its source engine to extract from"
            )
        meta_extra = {"first": int(first_token),
                      "num_new": int(num_new),
                      "submitted": float(submitted)}
        if chain:
            # decode-side prefix adoption over the wire: the receiver
            # matches the chain against its pool registry at OPEN and
            # answers with a skip count — only the unmatched suffix
            # ships.  chain_bs gates REGISTRATION at the far end (a
            # foreign granularity would attest the wrong token spans).
            meta_extra["chain"] = [str(d) for d in chain]
            meta_extra["chain_bs"] = int(
                getattr(source, "block_size", 0) or 0)
        sender = StreamSender(
            self.link, rid, handle,
            layout=source.wire_layout(),
            meta_extra=meta_extra,
            chunk_blocks=self.chunk_blocks, retries=self.retries,
            codec=self.codec,
        )
        # OPEN before claiming: a saturated receiver must leave the
        # handle adoptable so the router can park and re-deliver it once
        # the decode pool frees — claiming first would consume the
        # one-shot stamp on a handoff that never happened
        sender.open()          # raises ReplicaSaturatedError, leak-free
        blocks = source.pool.adopt(handle)   # claim AFTER the receiver
        # the gather dispatch + D2H issue happen at the FIRST PUMP (the
        # writer thread), overlapped with whatever the prefill engine
        # computes next; the claim above keeps the blocks stable until
        # then.  The codec AND the suffix skip are settled by the OPEN
        # ack above, so the deferred extract encodes what the receiver
        # accepted and gathers only the blocks that will ship.
        sender.extract_fn = (
            lambda: source.start_extract(blocks[sender.skip:],
                                         codec=sender.codec)
        )

        def _done(ok: bool, _blocks=blocks, _pool=source.pool) -> None:
            # the D2H gather was enqueued before any later source-pool
            # write, so the host-side free is safe now (same program-
            # order argument as the fused cross-pool adopt)
            _pool.release(_blocks)

        sender.on_done = _done
        self._senders.append(sender)
        if admit:
            self._pump_senders()

    def admit_pending(self) -> None:
        self._pump_senders()

    def step(self) -> None:
        self._pump_senders()
        if self._local is not None:
            self._local.step()

    def pump_streams(self) -> None:
        """Push chunks without stepping the local engine — the writer-
        thread entry point: a deployment runs this
        concurrently with the prefill engine's compute, which is where
        the stream's wall time hides."""
        self._pump_senders()

    def _pump_senders(self) -> None:
        keep: List[StreamSender] = []
        for s in self._senders:
            try:
                s.pump()
            except WireError:
                if not s.aborted:
                    s.abort()
                raise
            if not (s.done or s.aborted):
                keep.append(s)
        self._senders = keep

    # -- loopback conveniences ------------------------------------------
    @property
    def out(self) -> dict:
        return self._local.out if self._local is not None else {}

    def _flush_first_tokens(self) -> None:
        if self._local is not None:
            flush = getattr(self._local, "_flush_first_tokens", None)
            if flush is not None:
                flush()

    def idle_senders(self) -> int:
        return len(self._senders)
