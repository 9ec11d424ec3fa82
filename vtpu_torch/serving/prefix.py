"""Chained block digests and the router's prefix index.

The port's copy of ``vtpu/serving/prefix.py`` (the port imports nothing
of vtpu): ``chain_digests`` and ``PrefixIndex``.  Digest ``i`` is ``sha256(digest[i-1] ‖ tokens
of block i)``, so one digest names the whole token prefix up to block
``i``: a prefill engine's pool registry, a decode engine's and the wire's
OPEN document all agree on it without shipping tokens.  A chain crosses
between the two packages in the OPEN document, so the digests are byte
for byte the JAX package's (tests/test_torch_prefix.py).

:class:`PrefixIndex` is the router's digest -> prefill-replica hint map.
Before routing on an entry the router verifies that the replica's pool
still holds the run (``prefix_match_depth``); a hint that is not (or not
yet) in the pool is kept but not followed.  Its lock is a plain
``threading.Lock`` (the JAX package's ``make_lock`` is one too unless its
lock witness is switched on).
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from vtpu_torch.utils.envs import env_int

DEFAULT_INDEX_CAP = env_int("VTPU_PREFIX_CACHE_INDEX_CAP", 8192)


def chain_digests(tokens: Sequence[int], block_size: int) -> List[str]:
    """Chained digests (hex) of every full block of ``tokens``: entry
    ``i`` is ``sha256(entry[i-1] ‖ block i's tokens)``, each token as 8
    little-endian signed bytes.  The partial tail block is never
    digested (its K/V keeps being appended to)."""
    if block_size <= 0:
        return []
    out: List[str] = []
    prev = b""
    n = (len(tokens) // block_size) * block_size
    for i in range(0, n, block_size):
        h = hashlib.sha256(prev)
        for t in tokens[i:i + block_size]:
            h.update(int(t).to_bytes(8, "little", signed=True))
        prev = h.digest()
        out.append(prev.hex())
    return out


class PrefixIndex:
    """Router-side digest → prefill-replica hint map.

    ``route`` walks a prompt's chain longest-first, verifying each hit
    against the candidate engine's authoritative pool registry while
    the index lock is held (check-and-touch is atomic vs concurrent
    submits; a pool-evicted entry is pruned on sight).  ``record``
    registers every depth of the routed chain so later prompts sharing
    any prefix length find the replica."""

    def __init__(self, cap: int = 0) -> None:
        self.cap = cap or DEFAULT_INDEX_CAP
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def route(self, chain: Sequence[str],
              engines: Dict[str, object]) -> Tuple[Optional[str], int]:
        """(replica id, verified depth in blocks) of the deepest live
        prefix match among ``engines`` (replica id → prefill engine),
        or ``(None, 0)``."""
        if not chain:
            return None, 0
        with self._lock:
            for k in range(len(chain), 0, -1):
                pid = self._entries.get(chain[k - 1])
                if pid is None:
                    continue
                eng = engines.get(pid)
                pool = getattr(eng, "pool", None)
                if pool is None:
                    # replica gone (or drained out of the candidate
                    # set): the entry may revive later — keep it
                    continue
                depth = pool.prefix_match_depth(chain[:k])
                if depth > 0:
                    self._entries.move_to_end(chain[k - 1])
                    return pid, depth
                # not (or not YET) in that pool's registry: keep the
                # hint, just don't follow it — optimistic records land
                # before the routed prefill registers, and a pool-
                # evicted run re-registers on its next miss.  The LRU
                # cap bounds genuinely dead entries.
            return None, 0

    def record(self, chain: Sequence[str], pid: str) -> None:
        with self._lock:
            for d in chain:
                self._entries[d] = pid
                self._entries.move_to_end(d)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)

    def forget_replica(self, pid: str) -> None:
        """Drop every hint pointing at a replica (router drain path)."""
        with self._lock:
            for d in [d for d, p in self._entries.items() if p == pid]:
                del self._entries[d]
