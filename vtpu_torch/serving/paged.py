"""Paged continuous batching: a shared block pool behind the slot array.

The port of ``vtpu/serving/paged.py::PagedBatcher``.  K/V live in one
physical pool of ``kv_pool_blocks`` blocks (``kv_cache_layout="paged"``)
and each admission leases ``ceil((prompt + num_new) / block_size)``
blocks.  When the pool cannot cover the head of the queue, admission
waits for blocks (backpressure, not failure).

Prefill runs directly against the live pool: one batched forward per
admission round and suffix-length bucket, whose ``[n, nb_max]`` table
rows point at each request's leased blocks, so the pool is written in
place.  Padding rows carry an all-zero table row and write into the
garbage block 0, which is never leased.

Prefix caching (``prefix_cache=N``): the block-aligned prefix of every
admitted prompt is registered (a trie over block-sized token chunks); a
later prompt that starts with the same tokens references those blocks
instead of prefilling them again.  Blocks are refcounted; a shared block
is freed when every slot using it has retired and its registry entry has
been evicted (FIFO beyond N entries, or idle entries evicted for a
starved head of the queue).

The ledger's ``prefill_start``/``prefill_done`` marks bracket each
admission forward, as at the reference's; the rest of the hooks are the
base class's.

Weight-only int8 trees (``dequantize_tree``) come with a later slice.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
import torch

from vtpu_torch.models.transformer import TransformerLM, bucket_length
from vtpu_torch.serving.batcher import ContinuousBatcher, _Request
from vtpu_torch.serving.kvpool import BlockPool
from vtpu_torch.serving.reqtrace import LEDGER
from vtpu_torch.utils import trace


def pool_forward(model: TransformerLM, layers, tokens, pos, table):
    """Prefill against a live pool: a cache view whose pools are
    ``layers`` (written in place) and whose position and table rows are
    the group's."""
    return model(tokens, {"pos": pos, "block_table": table,
                          "layers": layers})


def suffix_bucket(prompt_len: int, shared_tok: int, max_seq: int,
                  bucket_prefill: bool) -> int:
    """The padded length a prompt's unshared suffix prefills at: its
    power-of-two bucket, capped so padded writes never pass max_seq (a
    clamped table index would land in the lease's last block)."""
    suffix = prompt_len - shared_tok
    if not bucket_prefill:
        return suffix
    return bucket_length(suffix, max_seq - shared_tok)


def pool_prefill(model: TransformerLM, layers, items, rows: int,
                 blen: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One admission forward of a length bucket against the live pool
    ``layers``: ``items`` are ``(prompt, shared_tok, table row)``, padded
    to ``rows`` rows whose all-zero table rows write into the garbage
    block.  Returns the first tokens ``[len(items)]`` (argmax at each
    row's true last token, on the device) and the ``[rows, nb_max]``
    table.  The admission compute shared by ``PagedBatcher`` and the
    disaggregated ``PrefillEngine``."""
    nb_max = model.max_seq // model.kv_block_size
    toks = np.zeros((rows, blen), np.int32)
    table = np.zeros((rows, nb_max), np.int32)
    pos0 = np.zeros((rows,), np.int32)
    lens = np.ones((rows,), np.int32)  # pad rows index token 0
    for r, (prompt, shared_tok, row) in enumerate(items):
        toks[r, :prompt.size - shared_tok] = prompt[shared_tok:]
        table[r] = row
        pos0[r] = shared_tok
        lens[r] = prompt.size - shared_tok
    dev = model.device
    table_t = torch.as_tensor(table, device=dev)
    logits = pool_forward(model, layers, torch.as_tensor(toks, device=dev),
                          torch.as_tensor(pos0, device=dev), table_t)
    n = len(items)
    lens_t = torch.as_tensor(lens[:n] - 1, device=dev).long()
    sel = logits[torch.arange(n, device=dev), lens_t]
    return sel.argmax(dim=-1).to(torch.int32), table_t


class PagedBatcher(ContinuousBatcher):
    """Continuous batching over a leased-block KV pool."""

    def __init__(self, model: TransformerLM, max_batch: int, eos_id=None,
                 prefill_chunk: int = 0, prefix_cache: int = 0,
                 harvest_every: int = 1, pipeline_depth: int = 1,
                 bucket_prefill: bool = True, decode_graph: str = "auto", *,
                 device="cuda"):
        if model.kv_cache_layout != "paged" or model.kv_pool_blocks <= 1:
            raise ValueError(
                "PagedBatcher needs kv_cache_layout='paged' and a real "
                "pool (kv_pool_blocks > 1)"
            )
        super().__init__(model, max_batch, eos_id=eos_id,
                         prefill_chunk=prefill_chunk,
                         harvest_every=harvest_every,
                         pipeline_depth=pipeline_depth,
                         bucket_prefill=bucket_prefill,
                         decode_graph=decode_graph, device=device)
        self.block_size = model.kv_block_size
        self.nb_max = model.max_seq // model.kv_block_size
        self.pool = BlockPool(model.kv_pool_blocks, model.kv_block_size)
        self._slot_blocks: Dict[int, List[int]] = {}
        # prefix registry: block-aligned token tuple -> block ids (FIFO)
        self.prefix_cache = prefix_cache
        self._prefixes: "collections.OrderedDict[tuple, List[int]]" = (
            collections.OrderedDict())
        # trie over block-sized token chunks; node: [terminal key or
        # None, {chunk tuple: child node}]
        self._trie: list = [None, {}]

    # -- block accounting (delegated to the BlockPool) ------------------
    @property
    def free(self) -> "collections.deque[int]":
        return self.pool.free

    @property
    def _block_refs(self) -> Dict[int, int]:
        return self.pool._refs

    def _lease(self, n: int) -> List[int]:
        return self.pool.lease(n)

    def _ref(self, blocks: List[int]) -> None:
        self.pool.ref(blocks)

    def _unref(self, blocks: List[int]) -> None:
        self.pool.release(blocks)  # raises on a double release

    # -- admission ------------------------------------------------------
    def _blocks_needed(self, req: _Request) -> int:
        return -(-(req.prompt.size + req.num_new) // self.block_size)

    def submit(self, rid: str, prompt, num_new: int) -> None:
        p = np.asarray(prompt, np.int32).reshape(-1)
        need = self._blocks_needed(_Request(rid, p, num_new))
        leasable = self.pool.leasable()
        if need > leasable:
            # a request the pool can never serve fails now: queued, it
            # would deadlock run()
            raise ValueError(
                f"request needs {need} blocks but the pool can lease at "
                f"most {leasable}"
            )
        super().submit(rid, prompt, num_new)

    def _admit_pending(self) -> None:
        """Head-of-line admission into every free slot: the oldest
        request waits for blocks rather than being overtaken.  Leases
        are taken as each request is popped, and the group prefills in
        one pool forward per suffix-length bucket."""
        progress = True
        while progress:
            progress = False
            group: List[Tuple[int, _Request, int, np.ndarray]] = []
            for slot in self._free_slots():
                if not self.queue:
                    break
                if not self._slot_is_free(slot):
                    continue
                # admissibility mirrors what is leased: the need AFTER
                # the prefix match
                req = self.queue[0]
                shared, shared_tok = self._match_prefix(req.prompt)
                need_new = self._blocks_needed(req) - len(shared)
                # starved head: evict idle registry prefixes (oldest
                # first, never the head's own match)
                while need_new > len(self.free) and self._evict_prefix(
                        keep=shared):
                    pass
                if need_new > len(self.free):
                    break  # head-of-line: the oldest waits for blocks
                self.queue.popleft()
                assigned = self._lease(need_new)
                self._ref(shared)
                table_blocks = shared + assigned
                self._slot_blocks[slot] = table_blocks
                row = np.zeros((self.nb_max,), np.int32)
                row[:len(table_blocks)] = table_blocks
                if 0 < self.prefill_chunk < req.prompt.size - shared_tok:
                    # chunked admission: one chunk per step() between
                    # the running slots' decodes
                    st = {"req": req, "cache": None, "done": shared_tok,
                          "row": torch.as_tensor(row[None, :],
                                                 device=self.device)}
                    st["pf"] = self._make_chunk_pf(st)
                    self.prefilling[slot] = st
                    progress = True
                    continue
                group.append((slot, req, shared_tok, row))
            if group:
                self._admit_batch_paged(group)
                progress = True

    def _admit_batch_paged(
            self, group: List[Tuple[int, _Request, int, np.ndarray]]) -> None:
        """Per suffix-length bucket: pool prefill, first-token argmax at
        each row's true last token, and the table/position/token publish
        of every admitted slot.  No host sync: the first tokens are read
        at the next harvest."""
        by_bucket: Dict[int, list] = {}
        for item in group:
            _slot, req, shared_tok, _row = item
            by_bucket.setdefault(
                suffix_bucket(req.prompt.size, shared_tok,
                              self.model.max_seq, self.bucket_prefill),
                []).append(item)
        for blen, sub in by_bucket.items():
            # register once the prefix K/V write is enqueued: stream
            # order makes a later matching prefill read written blocks
            for slot, req, *_ in sub:
                self._register_prefix(req.prompt, self._slot_blocks[slot])
            tr = trace.tracing()
            if tr:
                for _slot, req, *_ in sub:
                    LEDGER.mark(req.rid, "prefill_start")
            n = len(sub)
            firsts, table_t = pool_prefill(
                self.model, self.cache["layers"],
                [(req.prompt, shared_tok, row)
                 for _s, req, shared_tok, row in sub],
                self._bucket_rows(n), blen)
            if tr:
                # the enqueue boundary (the forward runs on asynchronously)
                for _slot, req, *_ in sub:
                    LEDGER.mark(req.rid, "prefill_done")
            dev = self.device
            slots = torch.as_tensor([s for s, *_ in sub], device=dev).long()
            sizes = [r.prompt.size for _s, r, *_ in sub]
            self.cache["block_table"][slots] = table_t[:n]
            self.cache["pos"][slots] = torch.as_tensor(
                sizes, dtype=torch.int32, device=dev)
            self.tok[slots] = firsts
            self._queue_first(firsts, [(s, r) for s, r, *_ in sub])

    def _chunks(self, key: tuple):
        bs = self.block_size
        return [key[i:i + bs] for i in range(0, len(key), bs)]

    def _index_add(self, key: tuple) -> None:
        node = self._trie
        for ch in self._chunks(key):
            node = node[1].setdefault(ch, [None, {}])
        node[0] = key

    def _index_remove(self, key: tuple) -> None:
        chunks = self._chunks(key)
        path = [self._trie]
        for ch in chunks:
            path.append(path[-1][1][ch])
        path[-1][0] = None
        # prune now-empty nodes
        for i in range(len(path) - 1, 0, -1):
            node = path[i]
            if node[0] is None and not node[1]:
                del path[i - 1][1][chunks[i - 1]]

    def _match_prefix(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest registered block-aligned prefix of ``prompt`` that
        leaves at least one suffix token.  Returns (shared block ids,
        shared token count)."""
        if not self.prefix_cache:
            return [], 0
        bs = self.block_size
        max_tok = prompt.size - 1
        node = self._trie
        best_key = None
        depth_tok = 0
        while depth_tok + bs <= max_tok:
            ch = tuple(int(t) for t in prompt[depth_tok:depth_tok + bs])
            node = node[1].get(ch)
            if node is None:
                break
            depth_tok += bs
            if node[0] is not None:
                best_key = node[0]
        if best_key is None:
            return [], 0
        return list(self._prefixes[best_key]), len(best_key)

    def _evict_prefix(self, keep: List[int]) -> bool:
        """Evict the oldest registry entry that is not ``keep`` and whose
        blocks only the registry holds.  True if one was evicted."""
        for key, blocks in self._prefixes.items():
            if blocks != keep and all(
                    self._block_refs.get(b, 0) == 1 for b in blocks):
                del self._prefixes[key]
                self._index_remove(key)
                self._unref(blocks)
                return True
        return False

    def _register_prefix(self, prompt: np.ndarray,
                         table_blocks: List[int]) -> None:
        aligned = (prompt.size // self.block_size) * self.block_size
        if not self.prefix_cache or aligned < self.block_size:
            return
        key = tuple(int(t) for t in prompt[:aligned])
        if key in self._prefixes:
            return
        blocks = table_blocks[:aligned // self.block_size]
        self._ref(blocks)
        self._prefixes[key] = blocks
        self._index_add(key)
        while len(self._prefixes) > self.prefix_cache:
            old_key, old_blocks = self._prefixes.popitem(last=False)
            self._index_remove(old_key)
            self._unref(old_blocks)

    def _make_chunk_pf(self, st: dict):
        """Chunk driver for one prefilling slot, closed over its state."""
        def pf(_cache_unused, chunk):
            pos = torch.full((1,), st["done"], dtype=torch.int32,
                             device=self.device)
            return pool_forward(self.model, self.cache["layers"], chunk, pos,
                                st["row"]), None

        return pf

    def _pre_activate(self, slot: int, st: dict) -> None:
        # the chunked prefill wrote its last chunk: register the prefix
        self._register_prefix(st["req"].prompt, self._slot_blocks[slot])

    def _publish_rows(self, slots, rows_np, pos_vals) -> None:
        """Publish table rows and positions of a group of slots."""
        idx = torch.as_tensor(np.asarray(slots), device=self.device).long()
        self.cache["block_table"][idx] = torch.as_tensor(
            np.asarray(rows_np, np.int32), device=self.device)
        self.cache["pos"][idx] = torch.as_tensor(
            np.asarray(pos_vals, np.int32), device=self.device)

    def _merge_rows(self, slots, rows_cache, pos) -> None:
        """Chunked-prefill activation: the pool is already written; only
        the slot's table row (from its lease) and position remain."""
        slot = int(slots[0])
        table_blocks = self._slot_blocks[slot]
        row = np.zeros((1, self.nb_max), np.int32)
        row[0, :len(table_blocks)] = table_blocks
        self._publish_rows(np.asarray(slots[:1]), row, np.asarray(pos[:1]))

    # -- retirement -----------------------------------------------------
    def _on_retire(self, slot: int) -> None:
        self._retire_rows([slot])

    def _retire_rows(self, slots: List[int]) -> None:
        """Free each retiring slot's lease, then point its writes at the
        garbage block and rewind its position (the slot keeps decoding
        as an inactive row; a freed block given to a new tenant must
        never be written by it)."""
        for slot in slots:
            blocks = self._slot_blocks.pop(slot, None)
            if blocks:
                self._unref(blocks)
        idx = torch.as_tensor(slots, device=self.device).long()
        self.cache["block_table"][idx] = 0
        self.cache["pos"][idx] = 0

    def pool_stats(self) -> dict:
        return {**self.pool.stats(),
                "registered_prefixes": len(self._prefixes)}

    def stats(self) -> dict:
        return {**super().stats(), **self.pool_stats()}
