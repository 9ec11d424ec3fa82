"""Host-side block-pool accounting and transferable K/V leases.

The port's own copy of ``vtpu/serving/kvpool.py::BlockPool`` (the port
imports nothing of vtpu): a free list, per-block refcounts, and the
handle surface of disaggregated serving.  Block 0 is the garbage block
(inactive rows write there) and is never leased.

A prefill engine writes a request's K/V into leased blocks and
**detaches** the lease into a :class:`KVHandle`; a decode engine
**adopts** it -- zero-copy when both engines share the pool, else by one
device-side copy into its own pool (``vtpu_torch/serving/disagg.py``).
Wire format (``KVHandle.to_wire``): ``{"pool": <pool id>, "blocks":
[ints], "seq_len": <tokens written>, "stamp": <generation>}``, the same
document as the JAX package's, so a handle crosses between the two.  A
handle is valid for exactly one adoption: a stale stamp raises
:class:`StaleHandleError`, a release of a block that holds no reference
raises :class:`DoubleReleaseError`, both before anything changes.

The handoff counters are plain integers in :meth:`BlockPool.stats`
(``handoff_*``, ``spec_*``).  The prefix registry, the host spill tier
and persistence come later: until then the registry holds no pins.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

# the plain-integer counters of stats(): adoptions (mode = shared, copy
# or wire), blocks adopted, bytes moved device-side by cross-pool copies,
# cache bytes that crossed the host (wire streams only), stale stamps
# refused, and speculative wire adoptions and their rollbacks
COUNTERS = ("handoff_shared", "handoff_copy", "handoff_wire",
            "handoff_blocks", "handoff_device_bytes", "handoff_host_bytes",
            "handoff_stale", "spec_adoptions", "spec_rollbacks")


class KVHandoffError(RuntimeError):
    """Base class for lease/handle protocol violations."""


class DoubleReleaseError(KVHandoffError):
    """A lease was released twice (or never held)."""


class StaleHandleError(KVHandoffError):
    """A handle's generation stamp no longer matches the pool: it was
    already adopted, or its lease was released underneath it."""


class PoolMismatchError(KVHandoffError):
    """A handle was presented to (or with) a pool it does not belong to."""


@dataclasses.dataclass(frozen=True)
class KVHandle:
    """Transferable K/V lease: the pool coordinates of the blocks that
    hold a request's K/V, never their contents."""

    pool_id: str
    blocks: Tuple[int, ...]
    seq_len: int   # tokens written (the prompt length)
    stamp: int     # pool detach generation; valid for ONE adoption

    def to_wire(self) -> dict:
        return {"pool": self.pool_id, "blocks": list(self.blocks),
                "seq_len": self.seq_len, "stamp": self.stamp}

    @classmethod
    def from_wire(cls, doc: dict) -> "KVHandle":
        try:
            return cls(pool_id=str(doc["pool"]),
                       blocks=tuple(int(b) for b in doc["blocks"]),
                       seq_len=int(doc["seq_len"]),
                       stamp=int(doc["stamp"]))
        except (KeyError, TypeError, ValueError) as e:
            raise KVHandoffError(f"malformed KV handle: {doc!r}") from e


class BlockPool:
    """Refcounted free-list accounting for one physical block pool.
    Thread-safe (one reentrant lock): a router may adopt into a decode
    engine on one thread while a prefill engine leases on another.

    The detach registry maps a handle's stamp to its block list; adoption
    consumes the entry, so a second adoption finds it gone."""

    def __init__(self, total_blocks: int, block_size: int,
                 pool_id: str = "") -> None:
        if total_blocks < 2:
            raise ValueError(
                f"BlockPool needs at least 2 blocks (block 0 is the "
                f"garbage block), got {total_blocks}"
            )
        # unique: adoption mode (shared vs copy) is chosen by pool-id
        # equality, and handles cross processes
        self.pool_id = pool_id or f"pool-{uuid.uuid4().hex[:12]}"
        self.total_blocks = total_blocks
        self.block_size = block_size
        self._lock = threading.RLock()
        self.free: collections.deque[int] = collections.deque(
            range(1, total_blocks))
        self._refs: Dict[int, int] = {}
        self._stamp = 0
        self._detached: Dict[int, Tuple[int, ...]] = {}
        # outstanding claim tickets per block: claims[b] <= refs[b] -
        # registry pins (none until the prefix registry is ported)
        self._detached_claims: "collections.Counter[int]" = (
            collections.Counter())
        self.counters: "collections.Counter[str]" = collections.Counter(
            {k: 0 for k in COUNTERS})

    # -- leases ---------------------------------------------------------
    def leasable(self) -> int:
        return self.total_blocks - 1

    def free_blocks(self) -> int:
        with self._lock:
            return len(self.free)

    def _take(self, n: int) -> List[int]:
        blocks = [self.free.popleft() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def try_lease(self, n: int) -> Optional[List[int]]:
        """Lease ``n`` blocks atomically, or ``None`` when fewer are free."""
        with self._lock:
            return None if n > len(self.free) else self._take(n)

    def lease_upto(self, n: int) -> List[int]:
        """Lease as many of ``n`` blocks as are free (possibly none): the
        wire receiver's incremental credit grant."""
        with self._lock:
            return self._take(min(n, len(self.free)))

    def lease(self, n: int) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); the caller has checked
        that they are free."""
        blocks = self.try_lease(n)
        if blocks is None:
            raise KVHandoffError(
                f"pool {self.pool_id}: lease of {n} blocks exceeds "
                f"{self.free_blocks()} free")
        return blocks

    def ref(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                if b not in self._refs:
                    raise DoubleReleaseError(
                        f"pool {self.pool_id}: ref on unleased block {b}")
            for b in blocks:
                self._refs[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block reaching 0 is free."""
        with self._lock:
            for b in blocks:
                if self._refs.get(b, 0) < 1:
                    raise DoubleReleaseError(
                        f"pool {self.pool_id}: release of block {b} which "
                        f"holds no live reference (double release?)"
                    )
            for b in blocks:
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    del self._refs[b]
                    self.free.append(b)

    # -- transferable handles -------------------------------------------
    def detach(self, blocks: Sequence[int], seq_len: int) -> KVHandle:
        """Turn a live lease into a handle: its references move to the
        handle (no refcount change) and the pool records the stamp the
        handle must present back."""
        with self._lock:
            for b in blocks:
                if b not in self._refs:
                    raise DoubleReleaseError(
                        f"pool {self.pool_id}: detach of unleased block {b}")
                if self._detached_claims[b] + 1 > self._refs[b]:
                    raise KVHandoffError(
                        f"pool {self.pool_id}: block {b} already belongs "
                        f"to a detached handle")
            self._stamp += 1
            handle = KVHandle(self.pool_id, tuple(blocks), seq_len,
                              self._stamp)
            self._detached[self._stamp] = handle.blocks
            self._detached_claims.update(handle.blocks)
            return handle

    def _claim(self, handle: KVHandle) -> Tuple[int, ...]:
        if handle.pool_id != self.pool_id:
            raise PoolMismatchError(
                f"handle belongs to pool {handle.pool_id!r}, "
                f"not {self.pool_id!r}")
        with self._lock:
            blocks = self._detached.pop(handle.stamp, None)
            if blocks is None or blocks != handle.blocks:
                if blocks is not None:  # stamp reused with other blocks
                    self._detached[handle.stamp] = blocks
                self.counters["handoff_stale"] += 1
                raise StaleHandleError(
                    f"pool {self.pool_id}: handle stamp {handle.stamp} is "
                    f"stale (already adopted or released)")
            for b in blocks:
                self._detached_claims[b] -= 1
                if self._detached_claims[b] <= 0:
                    del self._detached_claims[b]
            return blocks

    def adopt(self, handle: KVHandle) -> List[int]:
        """Consume a detached handle: its blocks and references now belong
        to the caller.  A second adoption raises :class:`StaleHandleError`."""
        return list(self._claim(handle))

    def release_handle(self, handle: KVHandle) -> None:
        """Consume a detached handle and free its blocks (an abandoned
        prefill, or the source side after a copy)."""
        self.release(self._claim(handle))

    def count(self, **deltas: int) -> None:
        """Add to the handoff counters (names from ``COUNTERS``)."""
        with self._lock:
            for k, v in deltas.items():
                if k not in self.counters:
                    raise KeyError(f"unknown pool counter {k!r}")
                self.counters[k] += v

    def stats(self) -> dict:
        with self._lock:
            return {"pool_id": self.pool_id,
                    "pool_blocks": self.total_blocks,
                    "leased": len(self._refs),
                    "free": len(self.free),
                    "detached_handles": len(self._detached),
                    "prefix_runs": 0, "prefix_blocks": 0,
                    **self.counters}
