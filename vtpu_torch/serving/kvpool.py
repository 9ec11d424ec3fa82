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

The pool also keeps the cluster-wide **prefix registry** (chained block
digests, ``vtpu_torch/serving/prefix.py``, each registered run pinning
one reference per block) and the **host spill tier** (demoted runs as
opaque quantized payloads, LRU and byte-capped).  The device halves of
demotion and onload live in ``vtpu_torch/serving/disagg.py``; this
module is host bookkeeping only.

Metrics: every count goes both into the pool's own integers
(``COUNTERS``, in :meth:`BlockPool.stats`) and into the port's ``serving``
registry under the JAX package's family names (``vtpu_kv_handoff_*``,
``vtpu_kv_speculative_*``, ``vtpu_prefix_cache_*``, ``vtpu_kv_spill_*``,
``_REGISTRY_OF``); the per-pool gauges ``vtpu_prefix_cache_blocks_total``
and ``vtpu_kv_pool_blocks_total`` follow the same mutations as the JAX
pool's, and :meth:`BlockPool.close` prunes them.
``vtpu_kv_handoff_host_bytes_total`` is the tripwire: the in-process
adoptions keep it at 0, and only a wire stream's chunks add to it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from vtpu_torch import obs
from vtpu_torch.utils.envs import env_int

_REG = obs.registry("serving")

DEFAULT_PREFIX_CAP = env_int("VTPU_PREFIX_CACHE_CAP", 512)
DEFAULT_SPILL_MAX_BYTES = env_int("VTPU_KV_SPILL_MAX_BYTES", 1 << 30)

# K/V handoff instrumentation (docs/observability.md §Serving): adopt
# outcomes by mode (shared = same-pool zero-copy rebind, copy = fused
# cross-pool device scatter), blocks moved, and the two byte counters —
# device bytes ride the fused program, host bytes MUST stay 0 (the
# disagg bench asserts it; any increment means a handoff regressed into
# a host-numpy round trip).
HANDOFF_TOTAL = _REG.counter(
    "vtpu_kv_handoff_total",
    "K/V handle adoptions by mode (shared = zero-copy rebind, "
    "copy = fused cross-pool device transfer)",
)
HANDOFF_BLOCKS = _REG.counter(
    "vtpu_kv_handoff_blocks_total",
    "Pool blocks moved (or rebound) by K/V handle adoptions",
)
HANDOFF_DEVICE_BYTES = _REG.counter(
    "vtpu_kv_handoff_device_bytes_total",
    "K/V bytes moved device-side by cross-pool handle adoptions",
)
HANDOFF_HOST_BYTES = _REG.counter(
    "vtpu_kv_handoff_host_bytes_total",
    "K/V cache bytes that crossed the host on a handoff path.  The "
    "in-process adopt modes (shared rebind, fused cross-pool copy) "
    "never materialize cache contents in host numpy, so they keep this "
    "at 0 (the disagg bench still asserts that); the WIRE transport "
    "(vtpu/serving/transport.py) deliberately stages bytes through the "
    "host and accounts them here, matching "
    "vtpu_kv_transport_bytes_total",
)
HANDOFF_STALE = _REG.counter(
    "vtpu_kv_handoff_stale_total",
    "Handle adoptions rejected because the generation stamp was stale",
)

# Speculative wire adoption (docs/serving.md §Wire transport): streams
# whose slot/first-token bind began before FIN, and the rollbacks that
# un-published them on abort/torn-stream exhaustion.
SPEC_ADOPTIONS = _REG.counter(
    "vtpu_kv_speculative_adoptions_total",
    "Wire streams speculatively adopted (slot reserved and first token "
    "published at OPEN, before FIN)",
)
SPEC_ROLLBACKS = _REG.counter(
    "vtpu_kv_speculative_rollbacks_total",
    "Speculative wire adoptions rolled back (stream aborted or torn "
    "past its resume budget before FIN) — slot freed, first token "
    "retracted, destination blocks released",
)

# Cluster-wide prefix cache (docs/serving.md §Prefix cache): pool-
# registry outcomes plus a per-pool gauge of registry-pinned blocks.
PREFIX_HITS = _REG.counter(
    "vtpu_prefix_cache_hits_total",
    "Prompt-prefix registry matches (prefill recompute skipped for the "
    "matched block run)",
)
PREFIX_MISSES = _REG.counter(
    "vtpu_prefix_cache_misses_total",
    "Prompt-prefix registry lookups that matched nothing",
)
PREFIX_EVICTIONS = _REG.counter(
    "vtpu_prefix_cache_evictions_total",
    "Prefix runs evicted from a pool registry (LRU cap or lease "
    "pressure)",
)
PREFIX_BLOCKS = _REG.gauge(
    "vtpu_prefix_cache_blocks_total",
    "Distinct pool blocks currently pinned by the prefix registry, "
    "per pool",
)

# K/V memory hierarchy (docs/serving.md §Memory hierarchy): per-pool
# block residency by tier, plus the demote/onload/rehydrate flow
# counters.  device = the physical pool; host = blocks' worth of
# demoted (quantized) prefix payloads held in host buffers; disk =
# blocks' worth journaled by the persistence store
# (vtpu/serving/kvpersist.py).  ``BlockPool.close()`` prunes a pool's
# series so churned pools don't grow the registry without bound.
POOL_TIER_BLOCKS = _REG.gauge(
    "vtpu_kv_pool_blocks_total",
    "Pool blocks resident per memory tier (device = physical pool, "
    "host = demoted quantized prefix payloads, disk = journaled by the "
    "persistence store), per pool",
)
SPILL_DEMOTIONS = _REG.counter(
    "vtpu_kv_spill_demotions_total",
    "Registered prefix runs demoted from device blocks to the host "
    "spill tier (gathered and quantized at demotion)",
)
SPILL_ONLOADS = _REG.counter(
    "vtpu_kv_spill_onloads_total",
    "Spilled prefix runs onloaded back into device blocks on a prompt "
    "match (dequantizing adoption scatter)",
)
SPILL_REHYDRATIONS = _REG.counter(
    "vtpu_kv_spill_rehydrations_total",
    "Prefix runs rehydrated into the host tier from the on-disk "
    "persistence journal after a restart",
)

# the plain-integer counters of stats(): adoptions (mode = shared, copy
# or wire), blocks adopted, bytes moved device-side by cross-pool copies,
# cache bytes that crossed the host (wire streams only), stale stamps
# refused, speculative wire adoptions and their rollbacks; registry
# hits and misses (counted by the admitting engine) and evictions; runs
# demoted to the host tier, onloaded back (counted by the engine) and
# rehydrated from a persistence journal
COUNTERS = ("handoff_shared", "handoff_copy", "handoff_wire",
            "handoff_blocks", "handoff_device_bytes", "handoff_host_bytes",
            "handoff_stale", "spec_adoptions", "spec_rollbacks",
            "prefix_hits", "prefix_misses", "prefix_evictions",
            "spill_demotions", "spill_onloads", "spill_rehydrations")

# pool counter -> (registry family, labels): the JAX package's sites
_REGISTRY_OF = {
    "handoff_shared": (HANDOFF_TOTAL, {"mode": "shared"}),
    "handoff_copy": (HANDOFF_TOTAL, {"mode": "copy"}),
    "handoff_wire": (HANDOFF_TOTAL, {"mode": "wire"}),
    "handoff_blocks": (HANDOFF_BLOCKS, {}),
    "handoff_device_bytes": (HANDOFF_DEVICE_BYTES, {}),
    "handoff_host_bytes": (HANDOFF_HOST_BYTES, {}),
    "handoff_stale": (HANDOFF_STALE, {}),
    "spec_adoptions": (SPEC_ADOPTIONS, {}),
    "spec_rollbacks": (SPEC_ROLLBACKS, {}),
    "prefix_hits": (PREFIX_HITS, {}),
    "prefix_misses": (PREFIX_MISSES, {}),
    "prefix_evictions": (PREFIX_EVICTIONS, {}),
    "spill_demotions": (SPILL_DEMOTIONS, {}),
    "spill_onloads": (SPILL_ONLOADS, {}),
    "spill_rehydrations": (SPILL_REHYDRATIONS, {}),
}


class KVHandoffError(RuntimeError):
    """Base class for lease/handle protocol violations."""


class DoubleReleaseError(KVHandoffError):
    """A lease was released twice (or never held)."""


class StaleHandleError(KVHandoffError):
    """A handle's generation stamp no longer matches the pool: it was
    already adopted, or its lease was released underneath it."""


class PoolMismatchError(KVHandoffError):
    """A handle was presented to (or with) a pool it does not belong to."""


@dataclasses.dataclass
class SpilledPrefix:
    """One demoted prefix run in the host tier: its digest chain (entry
    ``i`` attests blocks ``[:i+1]``), the quantized wire-layout payload
    of all ``len(chain)`` blocks, and the codec that encoded it."""

    chain: Tuple[str, ...]
    payload: bytes
    codec: str


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
                 pool_id: str = "", prefix_cap: Optional[int] = None,
                 spill_max_bytes: Optional[int] = None) -> None:
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
        self.prefix_cap = (DEFAULT_PREFIX_CAP if prefix_cap is None
                           else prefix_cap)
        self._lock = threading.RLock()
        self.free: collections.deque[int] = collections.deque(
            range(1, total_blocks))
        self._refs: Dict[int, int] = {}
        self._stamp = 0
        self._detached: Dict[int, Tuple[int, ...]] = {}
        # outstanding claim tickets per block: claims[b] <= refs[b] -
        # pins[b].  A prefix-shared block carries one reference per
        # sharing lease, so shared runs detach, while one lease still
        # cannot mint two tickets over one block
        self._detached_claims: "collections.Counter[int]" = (
            collections.Counter())
        # prefix registry: chained digest -> pinned block run (LRU; each
        # entry holds one reference per block of its run)
        self._prefix_runs: "collections.OrderedDict[str, Tuple[int, ...]]" = (
            collections.OrderedDict())
        self._prefix_pins: "collections.Counter[int]" = collections.Counter()
        # host spill tier: deepest digest of a demoted run -> its payload
        # (LRU, byte-capped).  An onload copies out and keeps the entry
        self.spill_max_bytes = (DEFAULT_SPILL_MAX_BYTES
                                if spill_max_bytes is None
                                else int(spill_max_bytes))
        self._spilled: "collections.OrderedDict[str, SpilledPrefix]" = (
            collections.OrderedDict())
        self._spill_bytes = 0
        # every spilled run's digests: which registry entries eviction
        # may drop first without losing anything
        self._spilled_digests: set = set()
        self._disk_blocks = 0
        self.counters: "collections.Counter[str]" = collections.Counter(
            {k: 0 for k in COUNTERS})
        self._tier_gauge()

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
                if (self._detached_claims[b] + 1
                        > self._refs[b] - self._prefix_pins[b]):
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
                self.count(handoff_stale=1)
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

    # -- cluster-wide prefix registry -----------------------------------
    # Keys are chained digests (prefix.chain_digests): digest i names the
    # whole token prefix through block i, so matching a prompt walks ITS
    # chain longest first.  Every registered run pins one reference per
    # block, so a run outlives the lease that wrote it; eviction drops
    # the pins, and the blocks free when their last sharer releases.

    def _prefix_gauge(self) -> None:
        PREFIX_BLOCKS.set(float(len(self._prefix_pins)), pool=self.pool_id)

    def _tier_gauge(self) -> None:
        POOL_TIER_BLOCKS.set(float(self.total_blocks),
                             pool=self.pool_id, tier="device")
        POOL_TIER_BLOCKS.set(
            float(sum(len(e.chain) for e in self._spilled.values())),
            pool=self.pool_id, tier="host")
        POOL_TIER_BLOCKS.set(float(self._disk_blocks),
                             pool=self.pool_id, tier="disk")

    def _drop_prefix_entry(self, digest: str) -> None:
        run = self._prefix_runs.pop(digest)
        for b in run:
            self._prefix_pins[b] -= 1
            if self._prefix_pins[b] <= 0:
                del self._prefix_pins[b]
        self.release(run)

    def _evict_prefix_entry(self) -> None:
        self._drop_prefix_entry(next(iter(self._prefix_runs)))
        self.count(prefix_evictions=1)

    def register_prefix(self, chain: Sequence[str],
                        blocks: Sequence[int]) -> None:
        """Register every depth of a freshly written prefix: ``chain[i]``
        maps to ``blocks[:i+1]``, pinning one reference a block.  The
        caller holds live references on ``blocks`` and registers only
        once the K/V write is enqueued, so a later matching prefill,
        behind it on the stream, reads written blocks."""
        if self.prefix_cap <= 0 or not chain:
            return
        with self._lock:
            for i, digest in enumerate(chain):
                if i >= len(blocks):
                    break
                if digest in self._prefix_runs:
                    self._prefix_runs.move_to_end(digest)
                    continue
                run = tuple(blocks[:i + 1])
                for b in run:
                    if b not in self._refs:
                        raise DoubleReleaseError(
                            f"pool {self.pool_id}: prefix registration "
                            f"over unleased block {b}")
                for b in run:
                    self._refs[b] += 1
                    self._prefix_pins[b] += 1
                self._prefix_runs[digest] = run
            while len(self._prefix_runs) > self.prefix_cap:
                self._evict_prefix_entry()
            self._prefix_gauge()

    def match_and_ref(self, chain: Sequence[str],
                      max_blocks: int) -> Tuple[List[int], int]:
        """The longest registered run matching the prompt's chain, at most
        ``max_blocks`` deep: its blocks, referenced for the caller in the
        same critical section as the lookup, and its depth; ``([], 0)``
        on a miss.  Hits and misses are the admitting caller's to count,
        once a request, not once a backpressure retry."""
        with self._lock:
            for k in range(min(len(chain), max_blocks), 0, -1):
                run = self._prefix_runs.get(chain[k - 1])
                if run is None:
                    continue
                self._prefix_runs.move_to_end(chain[k - 1])
                for b in run:
                    self._refs[b] += 1
                return list(run), k
            return [], 0

    def digests_for_run(self, blocks: Sequence[int]) -> List[str]:
        """The longest contiguous chain the registry attests for the
        leading blocks of ``blocks`` (entry ``i`` registered for exactly
        ``blocks[:i+1]``); empty when the prefix was never registered.
        A session export's fallback when its slot carried no chain."""
        with self._lock:
            if not self._prefix_runs:
                return []
            want = tuple(blocks)
            by_depth: Dict[int, str] = {}
            for d, run in self._prefix_runs.items():
                k = len(run)
                if k <= len(want) and run == want[:k]:
                    by_depth[k] = d
            out: List[str] = []
            for k in range(1, len(want) + 1):
                d = by_depth.get(k)
                if d is None:
                    break  # a chain is contiguous from depth 1
                out.append(d)
            return out

    def prefix_match_depth(self, chain: Sequence[str],
                           include_spilled: bool = True) -> int:
        """Read-only longest match depth in blocks, over the device
        registry and (by default) the host tier, whose runs the engine
        can onload; takes no references."""
        with self._lock:
            for k in range(len(chain), 0, -1):
                if chain[k - 1] in self._prefix_runs:
                    return k
                if include_spilled and chain[k - 1] in self._spilled:
                    return k
            return 0

    def evict_prefixes_for(self, need: int) -> bool:
        """Lease pressure: drop registry entries until ``need`` blocks are
        free or the registry is empty -- first entries the host tier
        already covers (nothing is lost), then least recently used.  An
        entry whose blocks slots still share frees nothing at once, but
        its pins go.  True when ``need`` blocks are free."""
        with self._lock:
            while len(self.free) < need and self._prefix_runs:
                backed = next((d for d in self._prefix_runs
                               if d in self._spilled_digests), None)
                if backed is not None:
                    self._drop_prefix_entry(backed)
                    self.count(prefix_evictions=1)
                else:
                    self._evict_prefix_entry()
            self._prefix_gauge()
            return len(self.free) >= need

    # -- host spill tier -------------------------------------------------
    def demotion_candidate(self) -> Optional[Tuple[List[str], List[int]]]:
        """``(chain, run)`` of the least recently used maximal registered
        run not yet spilled: maximal = no registered run extends it; a
        run whose chain is not registered contiguously from depth 1 is
        skipped.  ``None`` when nothing qualifies."""
        with self._lock:
            for digest, run in self._prefix_runs.items():  # LRU order
                if digest in self._spilled_digests:
                    continue
                k = len(run)
                if any(len(r2) > k and r2[:k] == run
                       for r2 in self._prefix_runs.values()):
                    continue
                chain = self.digests_for_run(run)
                if len(chain) == len(run):
                    return list(chain), list(run)
            return None

    def _insert_spilled(self, entry: SpilledPrefix) -> None:
        old = self._spilled.pop(entry.chain[-1], None)
        if old is not None:
            self._spill_bytes -= len(old.payload)
        self._spilled[entry.chain[-1]] = entry
        self._spill_bytes += len(entry.payload)
        # keep one entry even past the cap: spilling must not wedge
        while (self._spill_bytes > self.spill_max_bytes
               and len(self._spilled) > 1):
            _d, ev = self._spilled.popitem(last=False)
            self._spill_bytes -= len(ev.payload)
        self._spilled_digests = set()
        for e in self._spilled.values():
            self._spilled_digests.update(e.chain)

    def store_spilled(self, chain: Sequence[str], payload: bytes,
                      codec: str) -> None:
        """Install a demoted run in the host tier and drop every registry
        entry along its chain (its blocks free once no lease shares
        them).  The engine did the gather and the quantization."""
        chain = tuple(chain)
        if not chain:
            return
        with self._lock:
            for d in chain:
                if d in self._prefix_runs:
                    self._drop_prefix_entry(d)
            self._insert_spilled(SpilledPrefix(chain, bytes(payload),
                                               str(codec)))
            self.count(spill_demotions=1)
            self._prefix_gauge()
            self._tier_gauge()

    def rehydrate_spilled(self, chain: Sequence[str], payload: bytes,
                          codec: str) -> bool:
        """Install a journaled run straight into the host tier (a
        restart: there is no device state to demote).  False for an
        empty chain."""
        chain = tuple(chain)
        if not chain:
            return False
        with self._lock:
            self._insert_spilled(SpilledPrefix(chain, bytes(payload),
                                               str(codec)))
            self.count(spill_rehydrations=1)
            self._tier_gauge()
            return True

    def match_spilled(self, chain: Sequence[str], max_blocks: int,
                      ) -> Optional[Tuple[List[str], bytes, str, int]]:
        """The longest host-tier run matching the prompt's chain, at most
        ``max_blocks`` deep, as ``(chain, payload, codec, depth)``, or
        ``None``.  The hit is touched, not removed."""
        with self._lock:
            for k in range(min(len(chain), max_blocks), 0, -1):
                e = self._spilled.get(chain[k - 1])
                if e is not None and len(e.chain) == k:
                    self._spilled.move_to_end(chain[k - 1])
                    return list(e.chain), e.payload, e.codec, k
            return None

    def known_chains(self) -> List[Tuple[str, ...]]:
        """Every chain this pool can serve a prefix for: the spilled runs
        and the contiguously registered device runs."""
        with self._lock:
            out = [e.chain for e in self._spilled.values()]
            for run in self._prefix_runs.values():
                chain = self.digests_for_run(run)
                if len(chain) == len(run):
                    out.append(tuple(chain))
            return out

    def set_disk_blocks(self, n: int) -> None:
        """The persistence journal's block count (``disk_blocks``)."""
        with self._lock:
            self._disk_blocks = int(n)
            self._tier_gauge()

    def close(self) -> None:
        """Prune this pool's per-pool gauge series, so that a process
        churning pools does not grow the registry without bound.  The
        pool stays usable (the series come back on its next mutation)."""
        with self._lock:
            PREFIX_BLOCKS.remove(pool=self.pool_id)
            for tier in ("device", "host", "disk"):
                POOL_TIER_BLOCKS.remove(pool=self.pool_id, tier=tier)

    def count(self, **deltas: int) -> None:
        """Add to the pool's counters (names from ``COUNTERS``) and to
        their registry families."""
        with self._lock:
            for k, v in deltas.items():
                if k not in self.counters:
                    raise KeyError(f"unknown pool counter {k!r}")
                self.counters[k] += v
        for k, v in deltas.items():
            fam, labels = _REGISTRY_OF[k]
            fam.inc(v, **labels)

    def stats(self) -> dict:
        with self._lock:
            return {"pool_id": self.pool_id,
                    "pool_blocks": self.total_blocks,
                    "leased": len(self._refs),
                    "free": len(self.free),
                    "detached_handles": len(self._detached),
                    "prefix_runs": len(self._prefix_runs),
                    "prefix_blocks": len(self._prefix_pins),
                    "spilled_runs": len(self._spilled),
                    "spilled_blocks": sum(len(e.chain)
                                          for e in self._spilled.values()),
                    "spilled_bytes": self._spill_bytes,
                    "disk_blocks": self._disk_blocks,
                    **self.counters}
