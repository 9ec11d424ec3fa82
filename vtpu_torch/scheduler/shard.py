"""Consistent-hash ownership over replica ids.

The port's copy of ``vtpu/scheduler/shard.py``'s ``DEFAULT_VNODES`` and
``HashRing`` (the port imports nothing of vtpu).  The ring hashes
``"<replica>#<vnode>"`` and every name with md5, as the JAX package's
does, so both rings give every name the same owner: a session pinned by
either package's Router lands on the same replica id.  Removing a
replica remaps only the names it owned.

The sharded extender's merge layer, peer transports and leader election
stay in the JAX package: the port's serving tier needs only the ring.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right
from typing import Dict, List, Tuple

DEFAULT_VNODES = 64


class HashRing:
    """Consistent-hash ring over replica ids (md5-based: stable across
    processes and restarts, unlike the salted builtin hash)."""

    def __init__(self, replicas: List[str],
                 vnodes: int = DEFAULT_VNODES) -> None:
        if not replicas:
            raise ValueError("HashRing needs at least one replica")
        self.replicas = sorted(set(replicas))
        self.vnodes = max(1, vnodes)
        points: List[Tuple[int, str]] = []
        for rid in self.replicas:
            for v in range(self.vnodes):
                points.append((self._hash(f"{rid}#{v}"), rid))
        points.sort()
        self._keys = [p[0] for p in points]
        self._owners = [p[1] for p in points]
        # name -> owner memo (the ring is immutable per instance), bounded
        # so that a storm of distinct names cannot grow it without limit
        self._memo: Dict[str, str] = {}
        self._memo_cap = 262144

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")

    def owner(self, node_name: str) -> str:
        """The replica owning ``node_name`` (first vnode clockwise)."""
        got = self._memo.get(node_name)
        if got is not None:
            return got
        idx = bisect_right(self._keys, self._hash(node_name))
        if idx == len(self._keys):
            idx = 0
        rid = self._owners[idx]
        if len(self._memo) >= self._memo_cap:
            self._memo.clear()
        self._memo[node_name] = rid
        return rid

    def partition(self, node_names: List[str]) -> Dict[str, List[str]]:
        """Split a name list by owning replica (order-preserving)."""
        parts: Dict[str, List[str]] = {}
        for name in node_names:
            parts.setdefault(self.owner(name), []).append(name)
        return parts
