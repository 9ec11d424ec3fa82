"""Live session migration: moving a decoding session between replicas.

The port's copy of ``vtpu/serving/migrate.py`` (the port imports nothing
of vtpu):

- the source engine **exports** a session
  (:meth:`~vtpu_torch.serving.disagg.DecodeEngine.export_session`): the
  slot's blocks detach into a one-adoption
  :class:`~vtpu_torch.serving.kvpool.KVHandle`, and the host cursor state
  (sequence position, generated tokens, remaining budget, EOS freeze)
  rides a :class:`SessionExport`;
- the mover streams the blocks over the wire transport: the OPEN carries
  a ``session`` sub-document (cursor, tail, remaining, done, chain; every
  RESUME answer echoes it), and the receiver adopts into a reserved
  slot, resuming decode token for token;
- the move is **suffix-only** where it can be: the receiver skips every
  leading block its registry holds under the OPEN's chain
  (``skip_blocks``), and registers the chain once adopted.

A failure is typed (:class:`MigrationError`) and leaks nothing on either
pool: the session either goes on at the source (restored through
:meth:`~vtpu_torch.serving.disagg.DecodeEngine.adopt_session`) or the
move fails loudly -- never is it live on two replicas.  The one ambiguous
window, a FIN whose answer was lost with every resume probe failing,
raises :class:`MigrationAmbiguousError` with the transcript and restores
nothing.

The engines are duck-typed, so either package's engine can be a source
or a target.  The error classes join the transport's by-name table
(``transport._ERROR_TYPES``): over HTTP they travel by name, as the
wire's own do.  A mover runs on the target engine's driving thread (the
wire sink's serialization contract).

Observability, at the JAX mover's sites: one ``session_migrate`` span a
move, under the request's trace context (its context crosses to the
target in the OPEN meta), the move's wall time as the request's
``migration_pause`` (success or not), and the
``vtpu_session_migrations_total`` / ``vtpu_session_migrate_seconds`` /
``vtpu_session_migrate_blocks_total`` families.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from vtpu_torch import obs
from vtpu_torch.serving import transport
from vtpu_torch.serving.kvpool import KVHandle, KVHandoffError
from vtpu_torch.serving.transport import (
    LoopbackLink,
    ReceiverHub,
    ReplicaSaturatedError,
    StreamSender,
)
from vtpu_torch.serving.reqtrace import LEDGER
from vtpu_torch.utils import trace
from vtpu_torch.utils.envs import env_int

log = logging.getLogger(__name__)

__all__ = [
    "MigrationAmbiguousError",
    "MigrationError",
    "MoveReport",
    "NoMigrationTargetError",
    "SessionExport",
    "SessionGoneError",
    "SessionMover",
]

_REG = obs.registry("serving")

MIGRATIONS_TOTAL = _REG.counter(
    "vtpu_session_migrations_total",
    "Session moves by outcome: migrated (resumed on the target), "
    "fallback (no target with credit — restored on the source to "
    "finish in place), failed (typed mid-move failure — restored on "
    "the source when it still lives), ambiguous (lost FIN ack with "
    "resume probes exhausted — failed loudly, never restored)",
)
MIGRATE_HIST = _REG.histogram(
    "vtpu_session_migrate_seconds",
    "Wall time of one session move, export to resumed-on-target",
)
MIGRATE_BLOCKS = _REG.counter(
    "vtpu_session_migrate_blocks_total",
    "Session-migration pool blocks by kind: shipped (streamed over the "
    "wire) vs skipped (suffix-only — the receiver's registry already "
    "held the digest-matched prefix)",
)

DEFAULT_MAX_PUMPS = env_int("VTPU_MIGRATE_MAX_PUMPS", 1024)


class MigrationError(KVHandoffError):
    """Typed session-move failure.  ``phase`` names the state it failed
    in (``export`` / ``open`` / ``claim`` / ``stream`` / ``fin``);
    ``restored`` is True when the session was re-adopted on the source
    and goes on there."""

    def __init__(self, detail: str, phase: str = "move",
                 restored: bool = False) -> None:
        super().__init__(detail)
        self.phase = phase
        self.restored = restored


class SessionGoneError(MigrationError):
    """The session finished (or never lived) on the source: nothing to
    move, no work stranded."""

    def __init__(self, detail: str) -> None:
        super().__init__(detail, phase="export")


class NoMigrationTargetError(MigrationError):
    """No target accepted the OPEN (saturated, dead or mismatched); the
    session was restored on the source to finish in place."""

    def __init__(self, detail: str, restored: bool = True) -> None:
        super().__init__(detail, phase="open", restored=restored)


class MigrationAmbiguousError(MigrationError):
    """The FIN's answer was lost and every resume probe failed: the
    receiver may hold the session.  The source's blocks were released and
    the session NOT restored (it could be live twice); ``tail`` is the
    transcript to reconcile with the target."""

    def __init__(self, detail: str, tail: Optional[List[int]] = None) -> None:
        super().__init__(detail, phase="fin", restored=False)
        self.tail = list(tail or [])


# refusals travel by class name over HTTP, as the wire's own errors do
transport._ERROR_TYPES.update(
    {cls.__name__: cls for cls in (MigrationError, SessionGoneError,
                                   NoMigrationTargetError,
                                   MigrationAmbiguousError)})


@dataclasses.dataclass(frozen=True)
class SessionExport:
    """A live session detached from its slot: the claim ticket for its
    blocks and the host state that makes resumption exact.  ``cursor`` is
    the slot's device position (the next step writes K/V there), ``tail``
    the tokens generated so far (the last is the next step's input),
    ``remaining`` the budget still to generate, ``frozen`` whether EOS was
    seen, and ``chain`` the prompt's digests as far as the source attests
    them, at granularity ``block_size`` (may be empty)."""

    rid: str
    handle: KVHandle
    cursor: int
    tail: Tuple[int, ...]
    remaining: int
    frozen: bool
    chain: Tuple[str, ...] = ()
    block_size: int = 0

    def session_doc(self) -> dict:
        """The OPEN's ``session`` sub-document."""
        return {"cursor": int(self.cursor),
                "tail": [int(t) for t in self.tail],
                "remaining": int(self.remaining),
                "done": bool(self.frozen),
                "chain": list(self.chain),
                "chain_bs": int(self.block_size)}


@dataclasses.dataclass(frozen=True)
class MoveReport:
    """What one successful move did."""

    rid: str
    target: str
    blocks_shipped: int
    blocks_skipped: int
    wire_bytes: int
    codec: str
    duration_s: float


class SessionMover:
    """Moves live sessions between decode replicas over the wire.

    - The **source** exposes ``export_session`` / ``adopt_session`` (the
      restore leg) / ``start_extract`` / ``wire_layout`` / ``pool``; a
      wire replica is unwrapped to its ``_local`` engine.
    - The **target** is reached through its own ``link`` when it has one,
      else through a cached :class:`ReceiverHub` and
      :class:`LoopbackLink` of this package (cached, so the stamp replay
      protection spans moves)."""

    def __init__(self, *, chunk_blocks: int = 0, retries: int = 0,
                 codec: str = "", max_pumps: int = 0,
                 clock=time.perf_counter) -> None:
        self.chunk_blocks = chunk_blocks
        self.retries = retries
        self.codec = codec
        self.max_pumps = max_pumps or DEFAULT_MAX_PUMPS
        self._clock = clock
        self._lock = threading.Lock()
        self._hubs: Dict[int, LoopbackLink] = {}

    # -- topology -------------------------------------------------------
    @staticmethod
    def engine_of(replica):
        """The exportable engine behind a replica."""
        local = getattr(replica, "_local", None)
        return local if local is not None else replica

    def exportable(self, replica) -> List[str]:
        """Rids the replica can export (empty for one without the
        session surface)."""
        fn = getattr(self.engine_of(replica), "exportable_sessions", None)
        if fn is None:
            return []
        try:
            return list(fn())
        except Exception:  # noqa: BLE001 -- a dying source exports nothing
            log.debug("mover: exportable_sessions failed", exc_info=True)
            return []

    def _link_for(self, replica):
        link = getattr(replica, "link", None)
        if link is not None:
            return link
        with self._lock:
            lk = self._hubs.get(id(replica))
            if lk is None:
                lk = LoopbackLink(ReceiverHub(replica))
                self._hubs[id(replica)] = lk
            return lk

    # -- the move -------------------------------------------------------
    def move(self, rid: str, source,
             targets: Sequence[Tuple[str, object]]) -> MoveReport:
        """Export, OPEN at the first target with credit, stream (suffix
        only where the target's registry matches the chain), resume on
        the target.  Raises the :class:`MigrationError` family; on every
        failure but the ambiguous FIN the session is restored on the
        source first.  The move is one ``session_migrate`` span, failed
        on every error, and its wall time is the request's
        ``migration_pause`` either way (the session did not decode while
        it ran)."""
        sp = trace.start_span("session_migrate", ctx=LEDGER.ctx(rid),
                              rid=rid)
        t0 = self._clock()
        try:
            report = self._move(rid, source, targets, trace.context_of(sp))
        except BaseException as e:
            trace.end_span(sp, ok=False, error=f"{type(e).__name__}: {e}")
            LEDGER.pause(rid, "migration_pause", self._clock() - t0)
            raise
        if sp:
            sp["target"] = report.target
            sp["blocks_shipped"] = report.blocks_shipped
            sp["blocks_skipped"] = report.blocks_skipped
        trace.end_span(sp)
        LEDGER.pause(rid, "migration_pause", report.duration_s)
        return report

    def _move(self, rid: str, source, targets: Sequence[Tuple[str, object]],
              tctx: Optional[str]) -> MoveReport:
        src = self.engine_of(source)
        t0 = self._clock()
        try:
            export = src.export_session(rid)  # SessionGoneError through
        except MigrationError:
            raise
        except Exception as e:  # noqa: BLE001 -- a dying source, typed
            MIGRATIONS_TOTAL.inc(outcome="failed")
            raise MigrationError(
                f"export of {rid} failed on the source: {e}",
                phase="export") from e
        sender = picked = target_rep = None
        try:
            layout = src.wire_layout()
        except Exception as e:  # noqa: BLE001 -- nothing claimed yet
            restored = self._restore(src, export, None)
            MIGRATIONS_TOTAL.inc(outcome="failed")
            raise MigrationError(f"source layout for {rid} failed: {e}",
                                 phase="export", restored=restored) from e
        for tid, rep in targets:
            s = StreamSender(
                self._link_for(rep), rid, export.handle, layout=layout,
                meta_extra={"first": int(export.tail[-1]),
                            "num_new": int(export.remaining) + 1,
                            "submitted": 0.0,
                            "session": export.session_doc(),
                            **({"trace": tctx} if tctx else {})},
                chunk_blocks=self.chunk_blocks, retries=self.retries,
                codec=self.codec)
            try:
                s.open()
            except ReplicaSaturatedError:
                continue  # no credit there: try the next target
            except Exception:  # noqa: BLE001 -- dead or mismatched target
                log.debug("mover: OPEN for %s at %s failed", rid, tid,
                          exc_info=True)
                continue
            sender, picked, target_rep = s, tid, rep
            break
        if sender is None:
            restored = self._restore(src, export, None)
            MIGRATIONS_TOTAL.inc(outcome="fallback")
            raise NoMigrationTargetError(
                f"no migration target with credit for {rid} "
                f"({len(list(targets))} candidates)", restored=restored)
        # claim after the accepted OPEN: a refused OPEN leaves the handle
        # detached, so the restore re-adopts it
        try:
            blocks = src.pool.adopt(export.handle)
        except Exception as e:  # noqa: BLE001 -- e.g. a stale stamp
            try:
                sender.abort()
            except Exception:  # noqa: BLE001
                log.debug("mover: abort after a failed claim failed",
                          exc_info=True)
            restored = self._restore(src, export, None)
            MIGRATIONS_TOTAL.inc(outcome="failed")
            raise MigrationError(f"claim for {rid} failed: {e}",
                                 phase="claim", restored=restored) from e
        skip = sender.skip
        shipped = list(blocks[skip:])
        sender.extract_fn = (
            lambda: src.start_extract(shipped, codec=sender.codec))
        try:
            pumps = 0
            while not sender.pump():
                pumps += 1
                if pumps > self.max_pumps:
                    sender.abort()
                    restored = self._restore(src, export, blocks)
                    MIGRATIONS_TOTAL.inc(outcome="failed")
                    raise MigrationError(
                        f"stream for {rid} stalled after {self.max_pumps} "
                        f"pumps (credits never freed)", phase="stream",
                        restored=restored)
                # let the target retire slots, so starved credits grow
                step = getattr(target_rep, "step", None)
                if step is not None:
                    try:
                        step()
                    except Exception:  # noqa: BLE001 -- surfaces in the
                        # stream itself
                        log.debug("mover: target %s step failed", picked,
                                  exc_info=True)
        except MigrationError:
            raise
        except Exception as e:  # noqa: BLE001 -- typed below
            if not (sender.done or sender.aborted):
                try:
                    sender.abort()
                except Exception:  # noqa: BLE001
                    log.debug("mover: abort notify failed", exc_info=True)
            if sender.fin_unacked and not sender.receiver_gone:
                # the receiver may hold the session: restoring could make
                # two live copies.  Release the source and fail loudly
                try:
                    src.pool.release(blocks)
                except KVHandoffError:
                    log.exception("mover: ambiguous-FIN release failed")
                MIGRATIONS_TOTAL.inc(outcome="ambiguous")
                raise MigrationAmbiguousError(
                    f"FIN for {rid} sent but unacknowledged and every "
                    f"resume probe failed; the target may hold the "
                    f"session, so it is not restored on the source",
                    tail=list(export.tail)) from e
            restored = self._restore(src, export, blocks)
            MIGRATIONS_TOTAL.inc(outcome="failed")
            raise MigrationError(
                f"stream for {rid} to {picked} failed: {e}",
                phase="stream", restored=restored) from e
        # the target holds the session; the source's claim is spent
        src.pool.release(blocks)
        dur = self._clock() - t0
        MIGRATIONS_TOTAL.inc(outcome="migrated")
        MIGRATE_HIST.observe(dur)
        MIGRATE_BLOCKS.inc(len(shipped), kind="shipped")
        if skip:
            MIGRATE_BLOCKS.inc(skip, kind="skipped")
        per_block = int(getattr(sender.extract, "per_block", 0) or 0)
        return MoveReport(rid=rid, target=picked,
                          blocks_shipped=len(shipped), blocks_skipped=skip,
                          wire_bytes=len(shipped) * per_block,
                          codec=sender.codec, duration_s=dur)

    def _restore(self, src, export: SessionExport,
                 blocks: Optional[List[int]]) -> bool:
        """Re-adopt the export on the source, so it goes on where it
        stopped.  ``blocks`` is the mover's claim when the handle was
        already consumed.  False -- with both claims released -- when the
        source cannot take it back."""
        try:
            src.adopt_session(export, blocks=blocks)
            return True
        except Exception:  # noqa: BLE001 -- the source died mid-move
            log.exception("mover: restore of %s on the source failed",
                          export.rid)
            try:
                if blocks is None:
                    src.pool.release_handle(export.handle)
                else:
                    src.pool.release(blocks)
            except Exception:  # noqa: BLE001 -- pool gone with the engine
                log.debug("mover: release after a failed restore failed",
                          exc_info=True)
            return False
