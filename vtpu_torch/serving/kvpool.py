"""Host-side block-pool accounting for the paged K/V cache.

The port's own copy of the part of ``vtpu/serving/kvpool.py::BlockPool``
that ``PagedBatcher`` uses: a free list and per-block refcounts.  Block
0 is the garbage block (inactive rows write there) and is never leased.
Releasing a block that holds no reference raises
:class:`DoubleReleaseError` before anything changes.  Handles, spill,
persistence and metrics come with the disaggregation slice.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence


class KVHandoffError(RuntimeError):
    """Base class for lease protocol violations."""


class DoubleReleaseError(KVHandoffError):
    """A lease was released twice (or never held)."""


class BlockPool:
    """Refcounted free-list accounting for one physical block pool.
    Thread-safe (one plain lock)."""

    def __init__(self, total_blocks: int, block_size: int) -> None:
        if total_blocks < 2:
            raise ValueError(
                f"BlockPool needs at least 2 blocks (block 0 is the "
                f"garbage block), got {total_blocks}"
            )
        self.total_blocks = total_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        self.free: collections.deque[int] = collections.deque(
            range(1, total_blocks))
        self._refs: Dict[int, int] = {}

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
        """Lease as many of ``n`` blocks as are free (possibly none)."""
        with self._lock:
            return self._take(min(n, len(self.free)))

    def lease(self, n: int) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); the caller has checked
        that they are free."""
        blocks = self.try_lease(n)
        if blocks is None:
            raise KVHandoffError(
                f"lease of {n} blocks exceeds {self.free_blocks()} free")
        return blocks

    def ref(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                if b not in self._refs:
                    raise DoubleReleaseError(f"ref on unleased block {b}")
            for b in blocks:
                self._refs[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block reaching 0 is free."""
        with self._lock:
            for b in blocks:
                if self._refs.get(b, 0) < 1:
                    raise DoubleReleaseError(
                        f"release of block {b} which holds no live "
                        f"reference (double release?)"
                    )
            for b in blocks:
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    del self._refs[b]
                    self.free.append(b)

    def stats(self) -> dict:
        with self._lock:
            return {"pool_blocks": self.total_blocks,
                    "leased": len(self._refs),
                    "free": len(self.free)}
