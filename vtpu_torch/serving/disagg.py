"""Prefill/decode disaggregation: the role-split serving engines.

The port of ``vtpu/serving/disagg.py``.

- :class:`PrefillEngine` runs only the bucketed admission path (the
  compute half of ``PagedBatcher``'s admission, ``paged.pool_prefill``):
  it prefills a group of prompts into leased pool blocks, argmaxes each
  row's first token and **detaches** each lease into a
  :class:`~vtpu_torch.serving.kvpool.KVHandle`, emitting
  :class:`PrefillResult` ``(rid, first_token, handle)``.
- :class:`DecodeEngine` is the ``PagedBatcher`` decode loop (pipelined
  harvest, decode windows as CUDA graphs) admitting by **handle
  adoption** instead of raw prompts: the slot opens with the prefill's
  first token and position and decodes on from there.

Adoption has three modes:

- **shared** (``PrefillEngine(shared_with=decode)``, one pool): the
  handle's blocks are bound into the slot's table row; no cache byte
  moves.
- **copy** (a standalone prefill pool): the decode engine leases its own
  blocks and copies the source blocks device-side, one ``index_select``
  and ``index_copy_`` per pool leaf; no cache byte reaches the host
  (``handoff_host_bytes`` stays 0).
- **wire**: the decode engine is the sink of a K/V stream
  (``vtpu_torch/serving/transport.py``): ``wire_open`` pre-leases
  destination blocks as credits, ``wire_write`` scatters each chunk as
  it lands (dequantizing on the device under the int8/fp8/int4 codecs),
  ``wire_finish`` binds the slot.  With ``speculative`` (the default) a
  slot is reserved and the first token published at OPEN; its table row
  stays on the garbage block until FIN, so the decode windows that keep
  running inactive rows never write into blocks the stream is filling.

The bind, position and first-token writes are ``index_copy_`` into the
very tensors the captured decode windows read, so adoption never breaks
a graph.

Both engines serve a model with int8 weights
(``TransformerLM.quantize_weights`` or ``load_quantized``; the
reference's engines take a ``quantize_tree`` tree and call
``dequantize_tree`` in each program): the model dequantizes its weights
where they are used.  The K/V wire is the same: weights never travel
over it, and a JAX prefill on the same int8 tree hands its K/V to a
torch decode engine token for token (tests/test_torch_quant_tree.py).

Wire order of the pool leaves is the JAX package's flatten order: layer
names sorted as strings (``h0, h1, h10, h11, h2, ...``) and, within a
layer, ``k_pool, k_pool_scale, v_pool, v_pool_scale``.  Every leaf of a
model has the same shape and dtype, so the layout digest alone cannot
tell a layer-order stream from it; the order is what makes a JAX
prefill's stream land in the right layers of a torch decode engine, and
back (tests/test_torch_wire.py runs at depth 12 for that reason).

The rest of the JAX engines' surface:

- **prefix cache** (``PrefillEngine(prefix_cache=True)``): prompts digest
  into chained block digests (``prefix.chain_digests``); admission
  matches them against the pool's registry and prefills only the
  unmatched suffix.  A decode engine handed the chain registers the
  adopted prefix in its own pool, and a stream whose OPEN carries a
  chain its registry matches ships only the suffix (``skip_blocks``).
- **host spill** (``host_spill=True``, standalone pools only): under
  lease pressure the least recently used registered run is gathered,
  quantized (``VTPU_KV_SPILL_CODEC``, default int8) and kept on the
  host; a prompt that matches it onloads it back through the decode
  engine's dequantizing scatter.  ``persist_dir`` journals every demotion
  (``kvpersist.PrefixStore``) and rehydrates the host tier when an
  engine starts on the same directory.
- **session export and adoption** (``DecodeEngine.export_session``,
  ``adopt_session``, ``start_extract``; ``migrate.SessionMover`` moves a
  session over the wire, the OPEN carrying a ``session`` document).
  An export drains the windows in flight and parks the slot's table row
  on the garbage block before the next window, so no captured window
  writes into blocks that now belong to a handle.

Observability, at the JAX engines' sites: the request ledger's
``ensure``, ``prefill_start``, ``prefill_done``, ``handoff_done``,
``adopted`` and ``first_token`` marks (a decode engine holds the first
token on the host at adoption, or at a speculative OPEN), the
``prefill``, ``kv_spill_demote`` and ``kv_spill_onload`` spans, the
``spill_onload`` pause, and the pool counters (``kvpool._REGISTRY_OF``).
All of it is host code outside every captured decode window.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import TransformerLM
from vtpu_torch.ops.quant import (
    _e4m3_to_f32,
    dequantize_blockwise,
    pack_int4,
    quantize_blockwise,
    quantize_blockwise_fp8,
    quantize_blockwise_int4,
)
from vtpu_torch.serving import wirecodec
from vtpu_torch.serving.kvpersist import PrefixStore
from vtpu_torch.serving.kvpool import (
    BlockPool,
    KVHandle,
    KVHandoffError,
    PoolMismatchError,
)
from vtpu_torch.serving.migrate import SessionExport, SessionGoneError
from vtpu_torch.serving.batcher import _QTFT_HIST
from vtpu_torch.serving.paged import PagedBatcher, pool_prefill, suffix_bucket
from vtpu_torch.serving.prefix import chain_digests
from vtpu_torch.serving.reqtrace import LEDGER
from vtpu_torch.serving.transport import WireError
from vtpu_torch.utils import trace
from vtpu_torch.utils.envs import env_bool, env_str

__all__ = ["DecodeEngine", "HostExtract", "PrefillEngine",
           "PrefillResult", "pool_layout", "wire_leaves"]


def wire_leaves(layers: Sequence[dict]) -> List[torch.Tensor]:
    """A cache's pool leaves in the JAX package's flatten order: layers
    by their flax names ``h<i>`` sorted as strings, then each layer's
    leaves by name."""
    order = sorted(range(len(layers)), key=lambda i: f"h{i}")
    return [layers[i][name] for i in order for name in sorted(layers[i])]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def pool_layout(leaves: Sequence[torch.Tensor]) -> list:
    """Wire-layout digest of pool leaves (in wire order): per-block shape
    and dtype per leaf, dtypes named as JAX names them, so the same model
    gives the same digest in both packages.  The receiver checks it
    before it leases anything."""
    return [{"shape": [int(d) for d in leaf.shape[1:]],
             "dtype": _dtype_name(leaf.dtype)} for leaf in leaves]


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bf16 as its raw 16-bit words."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class HostExtract:
    """Async D2H of a claimed handle's gathered blocks: the sender side
    of the wire.  The copies into pinned memory are issued here, behind
    the gather on the stream, with an event recorded after them;
    ``ready_blocks()`` queries that event (never a sync), so the stream
    sender ships chunks only once the bytes have landed.  ``payload(lo,
    hi)`` gives exactly the bytes the JAX extract gives: per leaf in wire
    order, raw, or (quantized codecs) ``f32 scales ‖ quantized data``."""

    def __init__(self, gathered: List[torch.Tensor], nblocks: int,
                 codec: str = wirecodec.CODEC_FP32,
                 scales: Optional[List[torch.Tensor]] = None) -> None:
        self.codec = codec
        self.nblocks = nblocks
        self._layout = pool_layout(gathered)
        self.per_block = sum(
            int(np.prod(t.shape[1:])) * t.element_size() for t in gathered)
        if codec in wirecodec.QUANT_CODECS:
            self.per_block += 4 * len(gathered)
        self._event = None
        if gathered and gathered[0].device.type == "cuda":
            self._host = [self._pinned_copy(t) for t in gathered]
            self._host_scales = ([self._pinned_copy(s) for s in scales]
                                 if scales is not None else None)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(gathered)
            self._host_scales = list(scales) if scales is not None else None
        self._np: Optional[list] = None
        self._np_scales: Optional[list] = None

    @staticmethod
    def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def layout(self) -> list:
        return self._layout

    def ready_blocks(self) -> int:
        """Blocks whose bytes have landed host-side (0 while the copy is
        in flight)."""
        if self._event is not None and not self._event.query():
            return 0
        return self.nblocks

    def payload(self, lo: int, hi: int) -> bytes:
        """Bytes of blocks [lo, hi): per-leaf slices in wire order (the
        quantized codecs: each leaf's scale segment, then its data)."""
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()  # landed by ready_blocks()
            self._np = [_host_view(t) for t in self._host]
            if self._host_scales is not None:
                self._np_scales = [_host_view(s).astype("<f4", copy=False)
                                   for s in self._host_scales]
        # one copy, straight from the pinned buffers into the result
        if self.codec in wirecodec.QUANT_CODECS:
            parts = [memoryview(np.ascontiguousarray(a[lo:hi]))
                     for s, q in zip(self._np_scales, self._np)
                     for a in (s, q)]
        else:
            parts = [memoryview(np.ascontiguousarray(leaf[lo:hi]))
                     for leaf in self._np]
        return b"".join(parts)


@dataclasses.dataclass(frozen=True)
class PrefillResult:
    """One finished prefill: the first generated token and the claim
    ticket for the K/V it wrote.  ``chain`` is the prompt's block digests
    (prefix-cache runs only): it rides the handoff, so the decode side
    registers the adopted prefix and later streams ship only suffixes."""

    rid: str
    first_token: int
    handle: KVHandle
    num_new: int
    submitted: float = 0.0
    chain: Tuple[str, ...] = ()


@dataclasses.dataclass
class _PendingAdopt:
    """A handle whose blocks are claimed but still waiting for a slot
    (and, in copy mode, for destination blocks).  ``tail`` is set for a
    migrated session: its tokens so far, the slot resuming at ``seq_len``
    with ``first == tail[-1]`` as the next step's input; ``frozen``
    carries its EOS freeze."""

    rid: str
    blocks: List[int]     # claimed from the handle (ownership moved here)
    seq_len: int
    first: int
    num_new: int
    mode: str             # "shared" | "copy" | "wire"
    source: object        # the source engine (copy mode), else None
    submitted: float
    tail: Optional[List[int]] = None
    frozen: bool = False
    chain: Optional[List[str]] = None  # registered after adoption


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _make_wire_gathers() -> dict:
    """The extract's device half, one per wire codec: a row gather of
    pool blocks (fp32), and the quantized variants with the blockwise
    codec applied to the gathered rows (one f32 scale per (block,
    leaf); int4 also nibble-packed), so the D2H moves 4x-8x fewer bytes.
    Each maps ``(leaves, idx)`` to ``(data leaves, scale leaves or
    None)``.  The quantized variants gather the leaves of one shape and
    dtype into one tensor and quantize it once (a (leaf, block) pair is
    a block of it), so a model's 2·depth leaves cost one pass of the
    codec's elementwise ops, not one each."""
    def gather(leaves, idx):
        return [leaf.index_select(0, idx) for leaf in leaves], None

    def quant_gather(quantize, post=None):
        def g(leaves, idx):
            groups: Dict[tuple, List[int]] = {}
            for i, leaf in enumerate(leaves):
                groups.setdefault((tuple(leaf.shape[1:]), leaf.dtype),
                                  []).append(i)
            qs: List[torch.Tensor] = [None] * len(leaves)
            scales: List[torch.Tensor] = [None] * len(leaves)
            n = idx.numel()
            for (shape, dtype), members in groups.items():
                rows = torch.empty((len(members), n) + shape, dtype=dtype,
                                   device=idx.device)
                for j, i in enumerate(members):
                    torch.index_select(leaves[i], 0, idx, out=rows[j])
                q, s = quantize(rows.reshape((-1,) + shape))
                if post is not None:
                    q = post(q)
                q = q.reshape((len(members), n) + q.shape[1:])
                s = s.reshape(len(members), n).float()
                for j, i in enumerate(members):
                    qs[i], scales[i] = q[j], s[j]
            return qs, scales
        return g

    return {wirecodec.CODEC_FP32: gather,
            wirecodec.CODEC_INT8: quant_gather(quantize_blockwise),
            wirecodec.CODEC_FP8: quant_gather(quantize_blockwise_fp8),
            wirecodec.CODEC_INT4: quant_gather(quantize_blockwise_int4,
                                               post=pack_int4)}


def _extract_blocks(leaves, blocks, codec, gathers: dict) -> HostExtract:
    """Gather exactly ``blocks`` (quantizing under int8/fp8/int4) and
    start the async D2H.  The JAX extract pads the list to a power of two
    to bound its compiled programs; eager PyTorch has none to bound, so
    no pad row is gathered.  The caller fences the dispatch where a
    donating program could race it (the prefill engine's lock)."""
    idx = torch.as_tensor(list(blocks), device=leaves[0].device).long()
    gathered, scales = gathers[codec](leaves, idx)
    return HostExtract(gathered, idx.numel(), codec=codec, scales=scales)


def _leaf_meta(leaves) -> list:
    """``[(n_elem, shape, dtype, itemsize)]`` of pool leaves in wire
    order: a payload's parse input."""
    return [(int(np.prod(t.shape[1:])), tuple(t.shape[1:]), t.dtype,
             t.element_size()) for t in leaves]


def _payload_bytes(meta, codec: str, nblocks: int) -> int:
    """Bytes of an ``nblocks``-block payload under ``codec``
    (``wirecodec.block_bytes`` times ``nblocks``)."""
    if codec in wirecodec.QUANT_CODECS:
        return sum(4 * nblocks + _quant_bytes(codec, n, nblocks)
                   for n, *_ in meta)
    return nblocks * sum(n * isz for n, _sh, _dt, isz in meta)


def _quant_bytes(codec: str, n_elem: int, nblocks: int) -> int:
    if codec == wirecodec.CODEC_INT4:
        return nblocks * ((n_elem + 1) // 2)
    return nblocks * n_elem


def _segment(buf: torch.Tensor, off: int, nbytes: int,
             dtype: torch.dtype) -> torch.Tensor:
    seg = buf[off:off + nbytes]
    itemsize = torch.empty((), dtype=dtype).element_size()
    if off % itemsize:
        seg = seg.clone()  # an unaligned view cannot change its type
    return seg.view(dtype)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, codec: str,
                n_elem: int, nblocks: int,
                dtype: torch.dtype) -> torch.Tensor:
    """One leaf's received bytes -> ``[nblocks, n_elem]`` in the pool's
    dtype, as ``vtpu_torch.ops.quant``'s dequantizers compute it."""
    s = scale.reshape(nblocks, 1)
    if codec == wirecodec.CODEC_FP8:
        return (_e4m3_to_f32(q.reshape(nblocks, n_elem)) * s).to(dtype)
    if codec == wirecodec.CODEC_INT4:
        packed = q.reshape(nblocks, (n_elem + 1) // 2)
        nib = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
        u = nib.reshape(nblocks, -1)[:, :n_elem].to(torch.int8)
        q = torch.where(u > 7, u - 16, u)
    else:
        q = q.view(torch.int8).reshape(nblocks, n_elem)
    return dequantize_blockwise(q, s, dtype)


def scatter_payload(leaves, meta, idx: torch.Tensor, buf: torch.Tensor,
                    codec: str) -> None:
    """Write a payload of ``idx.numel()`` blocks (wire layout, already on
    the device as uint8 ``buf``) into rows ``idx`` of the pool
    ``leaves``: raw bytes under fp32, else dequantized on the device
    (int4: the nibble unpack too).  The wire chunk's and the spill
    onload's scatter."""
    nblocks = idx.numel()
    off = 0
    for leaf, (n_elem, shape, dtype, isz) in zip(leaves, meta):
        if codec not in wirecodec.QUANT_CODECS:
            nbytes = nblocks * n_elem * isz
            src = _segment(buf, off, nbytes, dtype)
            off += nbytes
        else:
            scale = _segment(buf, off, 4 * nblocks, torch.float32)
            off += 4 * nblocks
            nbytes = _quant_bytes(codec, n_elem, nblocks)
            src = _dequantize(buf[off:off + nbytes], scale, codec, n_elem,
                              nblocks, dtype)
            off += nbytes
        leaf.index_copy_(0, idx, src.reshape((nblocks,) + shape))


def chunk_to_device(payload, device: torch.device) -> torch.Tensor:
    """A received chunk's bytes on ``device`` as uint8: on CUDA one copy
    into pinned memory and one async H2D (PyTorch reuses the pinned
    block only once the copy has run)."""
    src = np.frombuffer(payload, np.uint8)
    if device.type != "cuda":
        return torch.from_numpy(src.copy())
    stage = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
    stage.numpy()[...] = src
    return stage.to(device, non_blocking=True)


class PrefillEngine:
    """The prefill role: bucketed admission only, emitting (first token,
    K/V handle) per request.

    Standalone by default (its own :class:`BlockPool` and pool tensors:
    the cross-pool topology, one copy per handoff), or co-located with
    ``shared_with=<DecodeEngine>``, whose pool and cache leaves it writes
    in place (handoff is a bind).  Admission is head-of-line FIFO on
    block backpressure, like the monolithic engine.  ``prefix_cache``,
    ``host_spill`` (``VTPU_KV_HOST_SPILL``; standalone pools only) and
    ``persist_dir`` (``VTPU_KV_PERSIST_DIR``; needs the spill tier) as in
    the module docstring."""

    def __init__(self, model: TransformerLM, *,
                 shared_with: Optional["DecodeEngine"] = None,
                 bucket_prefill: bool = True, prefix_cache: bool = False,
                 host_spill: Optional[bool] = None,
                 persist_dir: Optional[str] = None,
                 device="cuda") -> None:
        if model.kv_cache_layout != "paged" or model.kv_pool_blocks <= 1:
            raise ValueError(
                "PrefillEngine needs kv_cache_layout='paged' and a real "
                "pool (kv_pool_blocks > 1)")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine was asked for {dev}")
        self.model = model
        self.device = model.device
        self.bucket_prefill = bool(bucket_prefill)
        self.block_size = model.kv_block_size
        self.nb_max = model.max_seq // model.kv_block_size
        self._host = shared_with
        if shared_with is not None:
            if shared_with.pool.block_size != self.block_size:
                raise PoolMismatchError(
                    "shared prefill/decode need the same block size")
            self.pool = shared_with.pool
            self._layers = None
        else:
            self.pool = BlockPool(model.kv_pool_blocks, model.kv_block_size)
            self._layers = model.init_cache(1)["layers"]
        # a pump thread's extract and the admission forward both enqueue
        # on the device; claimed blocks are never written again, so only
        # the dispatches are fenced
        self._dispatch_lock = threading.Lock()
        self.queue: collections.deque = collections.deque()
        self._rids: set = set()
        self.prefills = 0
        self._wire_gathers = _make_wire_gathers()
        self.prefix_cache = bool(prefix_cache) and self.pool.prefix_cap > 0
        self.prefix_hits = 0
        self.prefix_tokens_skipped = 0
        # the host spill tier: a shared pool's decode engine keeps its
        # prefixes in the one device pool, so spilling is standalone only
        spill = (env_bool("VTPU_KV_HOST_SPILL", False)
                 if host_spill is None else bool(host_spill))
        self.host_spill = bool(spill and self._layers is not None
                               and self.prefix_cache)
        self._spill_codec = env_str("VTPU_KV_SPILL_CODEC",
                                    wirecodec.CODEC_INT8)
        if self._spill_codec not in wirecodec.QUANT_CODECS:
            self._spill_codec = wirecodec.CODEC_INT8
        self.spill_demotions = 0
        self.spill_onloads = 0
        self._spill_meta = None
        pdir = (env_str("VTPU_KV_PERSIST_DIR", "") if persist_dir is None
                else persist_dir)
        self._persist = None
        if pdir and self.host_spill:
            self._persist = PrefixStore(pdir, sig=self._persist_sig())
            meta = self._spill_leaf_meta()
            for chain, payload, codec, bs in self._persist.load():
                if (bs != self.block_size
                        or codec not in wirecodec.QUANT_CODECS
                        or len(payload) != _payload_bytes(meta, codec,
                                                          len(chain))
                        or len(chain) > self.pool.leasable()):
                    continue  # foreign geometry, or never onloadable here
                self.pool.rehydrate_spilled(chain, payload, codec)
            self.pool.set_disk_blocks(self._persist.blocks_journaled)

    # -- wire transport (sender side) ----------------------------------
    def wire_layout(self) -> list:
        """Layout digest the receiver validates before pre-leasing."""
        return pool_layout(self.pool_leaves())

    def start_extract(self, blocks,
                      codec: str = wirecodec.CODEC_FP32) -> HostExtract:
        """Begin the async D2H of claimed blocks for a wire stream, under
        the stream's negotiated ``codec``.  The gather enqueues behind any
        prefill already queued, so it reads written blocks."""
        with self._dispatch_lock:
            return _extract_blocks(self.pool_leaves(), blocks, codec,
                                   self._wire_gathers)

    def pool_leaves(self) -> List[torch.Tensor]:
        """This engine's own pool tensors, in wire order: what a
        cross-pool adoption and a wire extract read."""
        if self._layers is None:
            raise PoolMismatchError(
                "shared-mode prefill has no pool of its own -- adoption "
                "is the zero-copy rebind, not a copy")
        return wire_leaves(self._layers)

    def _live_layers(self) -> list:
        if self._host is not None:
            return self._host.cache["layers"]
        return self._layers

    # -- the host spill tier ---------------------------------------------
    def _spill_leaf_meta(self) -> list:
        if self._spill_meta is None:
            self._spill_meta = _leaf_meta(self.pool_leaves())
        return self._spill_meta

    def _persist_sig(self) -> str:
        """The layout signature journaled with every run, as the JAX
        engine computes it (``pool_layout`` is equal across the two
        packages), so a journal of either package's engine rehydrates the
        other's, and never one of another geometry."""
        doc = {"layout": pool_layout(self.pool_leaves()),
               "block_size": self.block_size}
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    def _demote_for(self, need: int) -> bool:
        """Lease pressure, demotion before eviction: gather and quantize
        the least recently used maximal registered run into the host tier
        (and the journal), drop its pins, until ``need`` blocks are free
        or no candidate is left.  The D2H wait is deliberate: this runs
        only when the pool is out of blocks."""
        if not self.host_spill:
            return False
        progressed = False
        while self.pool.free_blocks() < need:
            cand = self.pool.demotion_candidate()
            if cand is None:
                break
            chain, run = cand
            with trace.span("kv_spill_demote", blocks=len(run),
                            codec=self._spill_codec):
                ex = self.start_extract(run, codec=self._spill_codec)
                payload = ex.payload(0, len(run))  # waits for the D2H
                self.pool.store_spilled(chain, payload, self._spill_codec)
                self.spill_demotions += 1
                progressed = True
                if self._persist is not None:
                    self._persist.append(chain, payload, self._spill_codec,
                                         self.block_size)
                    self.pool.set_disk_blocks(
                        self._persist.blocks_journaled)
        return progressed and self.pool.free_blocks() >= need

    def _maybe_onload(self, chain: List[str], max_blocks: int,
                      rid: Optional[str] = None) -> None:
        """A host-tier run deeper than the device registry's match: lease
        blocks (demoting others if need be), scatter the dequantized
        payload into them and register the chain, so the admission's
        ``match_and_ref`` right after hits on the device.  Demotion, to
        make room, never picks the run being onloaded (it is spilled, not
        registered), so two runs cannot take turns evicting each other.
        When no blocks can be had, the prompt prefills from scratch.
        ``rid`` (tracing on) takes the onload as its ``spill_onload``
        pause."""
        if not self.host_spill or not chain:
            return
        hit = self.pool.match_spilled(chain, max_blocks)
        if hit is None:
            return
        sub_chain, payload, codec, k = hit
        if k <= self.pool.prefix_match_depth(chain, include_spilled=False):
            return  # the device registry serves this depth already
        if len(payload) != _payload_bytes(self._spill_leaf_meta(), codec, k):
            return  # a corrupt host entry: recompute instead
        blocks = self.pool.try_lease(k)
        if blocks is None and self._demote_for(k):
            blocks = self.pool.try_lease(k)
        if blocks is None:
            return
        t_sp = time.perf_counter()
        with trace.span("kv_spill_onload", blocks=k, codec=codec,
                        ctx=LEDGER.ctx(rid) if rid is not None else None):
            self._spill_scatter(blocks, payload, codec)
            self.pool.register_prefix(sub_chain, blocks)
            self.pool.release(blocks)  # the registry's pins keep them
        self.spill_onloads += 1
        self.pool.count(spill_onloads=1)
        if rid is not None:
            LEDGER.pause(rid, "spill_onload", time.perf_counter() - t_sp)

    def _spill_scatter(self, blocks: List[int], payload: bytes,
                       codec: str) -> None:
        """The device half of an onload: the payload to the device in one
        copy, dequantized there and written into exactly ``blocks`` (the
        decode engine's wire scatter)."""
        buf = chunk_to_device(payload, self.device)
        idx = torch.as_tensor(blocks, device=self.device).long()
        with self._dispatch_lock:
            scatter_payload(self.pool_leaves(), self._spill_leaf_meta(),
                            idx, buf, codec)

    # ------------------------------------------------------------------
    def _blocks_needed(self, prompt_len: int, num_new: int) -> int:
        # the lease covers prompt + decode budget, so the same blocks
        # serve the whole request after adoption
        return -(-(prompt_len + num_new) // self.block_size)

    def submit(self, rid: str, prompt, num_new: int, *,
               chain: Optional[list] = None) -> None:
        """Queue one prompt.  ``chain`` is an optional precomputed digest
        chain (a router's, so the prompt is not hashed twice); ignored
        while the prefix cache is off."""
        if num_new < 1:
            raise ValueError(f"num_new must be >= 1, got {num_new}")
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < 1:
            raise ValueError("prompt must have at least one token")
        if p.size + num_new > self.model.max_seq:
            raise ValueError(
                f"prompt ({p.size}) + num_new ({num_new}) exceeds "
                f"max_seq ({self.model.max_seq})")
        if self._blocks_needed(p.size, num_new) > self.pool.leasable():
            raise ValueError(
                "request needs more blocks than the pool can ever lease")
        if rid in self._rids:
            raise ValueError(f"duplicate request id {rid!r}")
        self._rids.add(rid)
        # matched at admission (the registry may grow while the prompt
        # waits), registered after its prefill
        if not self.prefix_cache:
            chain = []
        elif chain is None or len(chain) != p.size // self.block_size:
            # absent, or of another block granularity: compute ours
            chain = chain_digests(p.tolist(), self.block_size)
        self.queue.append((rid, p, num_new, time.perf_counter(),
                           list(chain)))
        # a record for direct-submit topologies (a router minted one
        # already; idempotent, and a no-op while tracing is off)
        LEDGER.ensure(rid)

    def step(self) -> List[PrefillResult]:
        """One admission round: take as many queued prompts as the pool
        can lease (head-of-line FIFO), prefill them in one forward per
        suffix-length bucket, and detach every lease into a handle.  With
        the prefix cache on, a prompt's matched blocks are referenced
        (shared, never copied) and only its suffix prefills, from the
        matched position.  The first tokens are the only host
        materialization -- tokens, never cache contents."""
        tr = trace.tracing()
        taken: List[Tuple] = []
        while self.queue:
            rid, p, num_new, t0, chain = self.queue[0]
            shared: List[int] = []
            shared_tok = 0
            if chain:
                # leave >= 1 suffix token: admission needs its logits
                max_blocks = (p.size - 1) // self.block_size
                self._maybe_onload(chain, max_blocks,
                                   rid=rid if tr else None)
                shared, k = self.pool.match_and_ref(chain, max_blocks)
                shared_tok = k * self.block_size
            need = self._blocks_needed(p.size, num_new) - len(shared)
            # atomic check-and-lease (a co-located decode engine may lease
            # on another thread); under pressure demotion goes first, then
            # registry entries yield their pins
            blocks = self.pool.try_lease(need)
            if blocks is None and self._demote_for(need):
                blocks = self.pool.try_lease(need)
            if blocks is None and self.pool.evict_prefixes_for(need):
                blocks = self.pool.try_lease(need)
            if blocks is None:
                if shared:
                    self.pool.release(shared)  # un-ref the match
                break  # the oldest waits for blocks; FIFO completion
            # counted at admission: a retried head counts once
            if shared:
                self.prefix_hits += 1
                self.prefix_tokens_skipped += shared_tok
                self.pool.count(prefix_hits=1)
            elif chain:
                self.pool.count(prefix_misses=1)
            self.queue.popleft()
            taken.append((rid, p, num_new, t0, chain, shared + blocks,
                          shared_tok))
        if not taken:
            return []
        # router_queue ends and prefill_compute begins for every taken
        # prompt
        pf_spans: Dict[str, dict] = {}
        if tr:
            for item in taken:
                LEDGER.mark(item[0], "prefill_start")
                pf_spans[item[0]] = trace.start_span(
                    "prefill", ctx=LEDGER.ctx(item[0]), rid=item[0],
                    prompt_tokens=int(item[1].size))
        by_bucket: Dict[int, list] = {}
        for item in taken:
            by_bucket.setdefault(
                suffix_bucket(item[1].size, item[6], self.model.max_seq,
                              self.bucket_prefill), []).append(item)
        out: List[PrefillResult] = []
        for blen, sub in by_bucket.items():
            n = len(sub)
            rows = []
            for _rid, p, _n, _t0, _c, blocks, shared_tok in sub:
                row = np.zeros((self.nb_max,), np.int32)
                row[:len(blocks)] = blocks
                rows.append((p, shared_tok, row))
            with self._dispatch_lock:
                firsts, _table = pool_prefill(
                    self.model, self._live_layers(), rows,
                    _pow2(n) if self.bucket_prefill else n, blen)
            # registered once the forward is enqueued: a later matching
            # prefill, behind it on the stream, reads written blocks
            for _rid, _p, _n, _t0, chain, blocks, _st in sub:
                if chain:
                    self.pool.register_prefix(chain, blocks)
            vals = firsts.tolist()  # the first-token harvest
            for (rid, p, num_new, t0, chain, blocks, _st), first in zip(
                    sub, vals):
                handle = self.pool.detach(blocks, seq_len=int(p.size))
                out.append(PrefillResult(rid, int(first), handle, num_new,
                                         t0, chain=tuple(chain)))
                if tr:
                    LEDGER.mark(rid, "prefill_done")
                    trace.end_span(pf_spans.pop(rid, {}))
        self.prefills += len(out)
        return out

    def purge(self, rid: str) -> bool:
        """Drop a still-queued prompt (nothing was leased yet)."""
        for i, item in enumerate(self.queue):
            if item[0] == rid:
                del self.queue[i]
                self._rids.discard(rid)
                return True
        return False

    def run(self) -> List[PrefillResult]:
        """Drain the whole queue (blocks permitting each round)."""
        out: List[PrefillResult] = []
        while self.queue:
            got = self.step()
            if not got:
                break  # backpressure with nothing in flight to free blocks
            out.extend(got)
        return out

    def stats(self) -> dict:
        return {**self.pool.stats(), "queued": len(self.queue),
                "prefills": self.prefills, "prefix_hits": self.prefix_hits,
                "prefix_tokens_skipped": self.prefix_tokens_skipped,
                "spill_demotions": self.spill_demotions,
                "spill_onloads": self.spill_onloads}


class DecodeEngine(PagedBatcher):
    """The decode role: the PagedBatcher decode loop, admitting by handle
    adoption instead of raw prompts.  ``self.queue`` holds
    :class:`_PendingAdopt` records, so the base class's drive loop
    (``run``/``step``/stats) works unchanged."""

    def __init__(self, model: TransformerLM, max_batch: int,
                 replica_id: str = "decode0", speculative: bool = True,
                 **kw) -> None:
        super().__init__(model, max_batch, **kw)
        self.replica_id = replica_id
        self.speculative = bool(speculative)
        self._spec_lock = threading.Lock()
        self._spec_slots: Dict[int, str] = {}   # reserved slot -> rid
        # the largest scale a quantized chunk applied: the largest
        # per-element reconstruction error is
        # wirecodec.error_bound(wire_quant_max_scale, wire_quant_codec)
        self.wire_quant_max_scale = 0.0
        self.wire_quant_codec = wirecodec.CODEC_INT8
        self._wire_meta = None
        # per slot, the device position of its first published token
        # (cursor - (tokens - 1)): an export derives the cursor from it
        # without a device read -- after the drain every harvested token
        # advanced the slot by one
        self._slot_base: Dict[int, int] = {}
        # per slot, the prompt's chain when the handoff carried one: an
        # export re-ships it, so the target can skip the matched prefix
        # (decode writes land past the chain's full prompt blocks)
        self._slot_chain: Dict[int, List[str]] = {}
        # the sender half of a session move
        self._wire_gathers = _make_wire_gathers()

    def ping(self) -> bool:
        return True

    # the router hands a prompt's digest chain only to replicas that
    # declare they register it
    accepts_chain = True

    # speculative reservations hold their slot against every other
    # admission until FIN binds it (or a rollback frees it)
    def _free_slots(self) -> List[int]:
        return [s for s in super()._free_slots() if s not in self._spec_slots]

    def _slot_is_free(self, slot: int) -> bool:
        return (super()._slot_is_free(slot)
                and slot not in self._spec_slots)

    def submit(self, rid: str, prompt, num_new: int) -> None:
        raise TypeError(
            "DecodeEngine admits finished prefills -- use submit_handle() "
            "(raw prompts go to the PrefillEngine or a monolithic "
            "PagedBatcher)")

    def submit_handle(self, rid: str, handle: KVHandle, first_token: int,
                      num_new: int, source=None, submitted: float = 0.0,
                      admit: bool = True,
                      chain: Optional[List[str]] = None) -> None:
        """Adopt a detached K/V lease: claim it now (a stale stamp fails
        here), queue it for a slot, and admit as capacity frees.
        ``source`` is the engine owning the handle's pool when that is
        not this engine's own (copy mode).  ``admit=False`` defers the
        admission so that a batch of handles binds as one group; call
        :meth:`admit_pending` after the batch.  ``chain`` (the prompt's
        digests) registers the adopted prefix in this pool after the
        bind, so later streams of sibling prompts and session moves ship
        only their suffix; a chain of another block size is dropped."""
        if chain and source is not None and getattr(
                source, "block_size", None) != self.block_size:
            chain = None  # another digest granularity: never register
        if num_new < 1:
            raise ValueError(f"num_new must be >= 1, got {num_new}")
        if handle.seq_len + num_new > self.model.max_seq:
            raise ValueError(
                f"seq_len ({handle.seq_len}) + num_new ({num_new}) "
                f"exceeds max_seq ({self.model.max_seq})")
        if rid in self._rids:
            raise ValueError(f"duplicate request id {rid!r}")
        if handle.pool_id == self.pool.pool_id:
            blocks = self.pool.adopt(handle)  # StaleHandleError on reuse
            mode, src = "shared", None
        else:
            if (source is None or getattr(source, "pool", None) is None
                    or source.pool.pool_id != handle.pool_id):
                raise PoolMismatchError(
                    f"handle from pool {handle.pool_id!r} needs its source "
                    f"engine to copy from")
            if len(handle.blocks) > self.pool.leasable():
                raise ValueError(
                    "handle needs more blocks than this pool can ever lease")
            blocks = source.pool.adopt(handle)  # claim the src references
            mode, src = "copy", source
        self._rids.add(rid)
        self.queue.append(_PendingAdopt(
            rid, blocks, handle.seq_len, int(first_token), num_new, mode,
            src, submitted, chain=list(chain) if chain else None))
        # in-process handoff: wire_transfer is zero-width (a wire stream
        # marks this at its FIN instead)
        LEDGER.mark(rid, "handoff_done")
        if admit:
            self._admit_pending()

    def admit_pending(self) -> None:
        """Admit everything queued (slots permitting) as one group."""
        self._admit_pending()

    def purge_pending(self, rid: str) -> bool:
        """Remove a claimed-but-unslotted adoption and free its blocks."""
        for i, pa in enumerate(self.queue):
            if not isinstance(pa, _PendingAdopt) or pa.rid != rid:
                continue
            del self.queue[i]
            if pa.mode == "copy":
                # the claimed references live in the SOURCE pool until
                # the copy runs
                pa.source.pool.release(pa.blocks)
            else:
                self.pool.release(pa.blocks)
            self._rids.discard(rid)
            return True
        return False

    # -- live session export and adoption (migrate.py) -------------------
    # A mover runs on this engine's driving thread, the wire sink's
    # contract: the export's gather and the decode windows are ordered on
    # the device by the order they were issued in.
    def exportable_sessions(self) -> List[str]:
        """Rids a mover can export: live slots, and queued adoptions
        whose blocks are in this pool (shared and wire; a copy entry's
        claimed blocks are still the source's, so it finishes here)."""
        live = [r for r in self.rid if r is not None]
        queued = [pa.rid for pa in self.queue
                  if isinstance(pa, _PendingAdopt)
                  and pa.mode in ("shared", "wire")]
        return live + queued

    def _export_pending(self, rid: str) -> SessionExport:
        """Detach a queued adoption into an export: the record holds what
        a slot would have published, and no device state exists yet."""
        for i, pa in enumerate(self.queue):
            if not isinstance(pa, _PendingAdopt) or pa.rid != rid:
                continue
            if pa.mode == "copy":
                raise SessionGoneError(
                    f"session {rid!r} is a cross-pool pending adoption "
                    f"on replica {self.replica_id}; it finishes in place")
            del self.queue[i]
            tail = [int(t) for t in
                    (pa.tail if pa.tail is not None else [pa.first])]
            chain = tuple(pa.chain or self.pool.digests_for_run(pa.blocks))
            handle = self.pool.detach(pa.blocks, seq_len=int(pa.seq_len))
            self._rids.discard(rid)
            frozen = pa.frozen or (self.eos_id is not None
                                   and pa.first == self.eos_id)
            return SessionExport(
                rid=rid, handle=handle, cursor=int(pa.seq_len),
                tail=tuple(tail), remaining=int(pa.num_new) - 1,
                frozen=frozen, chain=chain, block_size=self.block_size)
        raise SessionGoneError(
            f"session {rid!r} is not live on replica {self.replica_id} "
            f"(finished, mid-stream, or never here)")

    def _retire_rows(self, slots: List[int]) -> None:
        for slot in slots:
            self._slot_base.pop(slot, None)
            self._slot_chain.pop(slot, None)
        super()._retire_rows(slots)

    def export_session(self, rid: str) -> SessionExport:
        """Detach a live slot into a :class:`~vtpu_torch.serving.migrate.
        SessionExport`: drain the windows in flight, take the cursor,
        tail and budget, detach the blocks into a one-adoption handle and
        free the slot.  The slot's table row goes to the garbage block and
        its position to 0 in place, before any later window: a captured
        window keeps running the now inactive row, and must not write into
        blocks that belong to the handle.  Raises
        :class:`~vtpu_torch.serving.migrate.SessionGoneError` when the rid
        finished during the drain."""
        while self._inflight:
            self._harvest_oldest()
        self._flush_first_tokens()
        slot = next((i for i in range(self.max_batch)
                     if self.rid[i] == rid), None)
        if slot is None:
            return self._export_pending(rid)
        tail = [int(t) for t in self.out[rid]]
        cursor = self._slot_base.pop(slot) + len(tail) - 1
        remaining = int(self.remaining[slot])
        frozen = bool(self.done_frozen[slot])
        blocks = self._slot_blocks.pop(slot)
        chain = tuple(self._slot_chain.pop(slot, None)
                      or self.pool.digests_for_run(blocks))
        handle = self.pool.detach(blocks, seq_len=cursor)
        # the slot's references moved into the handle: free the slot
        # without releasing them
        self.active[slot] = False
        self.rid[slot] = None
        self.done_frozen[slot] = False
        self.remaining[slot] = 0
        self._rids.discard(rid)
        del self.out[rid]
        idx = torch.as_tensor([slot], device=self.device).long()
        zero = torch.zeros((1, self.nb_max), dtype=torch.int32,
                           device=self.device)
        self.cache["block_table"].index_copy_(0, idx, zero)
        self.cache["pos"].index_copy_(0, idx, zero[:, 0])
        return SessionExport(rid=rid, handle=handle, cursor=cursor,
                             tail=tuple(tail), remaining=remaining,
                             frozen=frozen, chain=chain,
                             block_size=self.block_size)

    def adopt_session(self, export: SessionExport, *,
                      blocks: Optional[List[int]] = None,
                      submitted: float = 0.0) -> None:
        """Adopt a same-pool export: a failed move's restore, or a move
        between engines on one pool.  ``blocks`` is a claim the caller
        already took from the handle; else the handle is claimed here (a
        stale stamp fails).  The slot opens at the cursor with
        ``tail[-1]`` as its next input, through the bind's in-place
        writes.  A cross-pool export adopts over the wire instead."""
        if export.rid in self._rids:
            raise KVHandoffError(f"duplicate request id {export.rid!r}")
        if not export.tail:
            raise KVHandoffError(
                f"session export for {export.rid!r} has an empty tail")
        if export.cursor + export.remaining + 1 > self.model.max_seq:
            raise ValueError(
                f"cursor ({export.cursor}) + remaining ({export.remaining}) "
                f"exceeds max_seq ({self.model.max_seq})")
        if blocks is None:
            blocks = self.pool.adopt(export.handle)  # StaleHandleError
        self._rids.add(export.rid)
        self.queue.append(_PendingAdopt(
            export.rid, list(blocks), int(export.cursor),
            int(export.tail[-1]), int(export.remaining) + 1, "shared",
            None, submitted, tail=[int(t) for t in export.tail],
            frozen=bool(export.frozen)))
        self._admit_pending()

    def start_extract(self, blocks,
                      codec: str = wirecodec.CODEC_FP32) -> HostExtract:
        """Async D2H of exported blocks: the sender half of a session
        move.  Runs on the engine's driving thread, so the gather is
        ordered after the windows before it; detached blocks are never
        written again, so the live pool is the right one to read."""
        return _extract_blocks(wire_leaves(self.cache["layers"]), blocks,
                               codec, self._wire_gathers)

    # -- wire transport (receiver sink) --------------------------------
    # The ReceiverHub drives these: open pre-leases destination blocks
    # (the credit grant), write scatters each chunk as it lands, finish
    # binds the slot, abort releases a partial adoption.  The sink is
    # driven from the thread that runs step() (or under the same outside
    # serialization): a chunk's scatter and a decode window are then
    # ordered on the device by the order they were issued in.
    def wire_layout(self) -> list:
        return pool_layout(wire_leaves(self.cache["layers"]))

    def wire_codecs(self) -> tuple:
        """Codecs this receiver accepts at OPEN negotiation."""
        return wirecodec.SUPPORTED

    def wire_open(self, rid: str, total_blocks: int, layout: list,
                  chunk_blocks: int, codec: str = wirecodec.CODEC_FP32,
                  meta: Optional[dict] = None):
        # everything refused here is a KVHandoffError subclass, so that a
        # hub answers an HTTP peer with the typed error document
        if rid in self._rids:
            raise WireError(f"duplicate request id {rid!r}")
        if layout != self.wire_layout():
            raise PoolMismatchError(
                "wire stream layout does not match this engine's pool "
                "(different model shapes or dtypes)")
        if total_blocks > self.pool.leasable():
            raise PoolMismatchError(
                "handle needs more blocks than this pool can ever lease")
        if meta is not None:
            try:
                seq_len = int(meta["handle"]["seq_len"])
                num_new = int(meta.get("num_new", 1))
            except (KeyError, TypeError, ValueError):
                pass  # malformed meta fails typed at FIN
            else:
                if seq_len + num_new > self.model.max_seq:
                    raise WireError(
                        f"seq_len ({seq_len}) + num_new ({num_new}) "
                        f"exceeds max_seq ({self.model.max_seq})")
        # suffix-only: the OPEN's chain (a plain handoff's or a session's)
        # against this pool's registry; every matched leading block is
        # referenced for the stream instead of shipped, and the count
        # rides the OPEN answer.  A chain of another granularity never
        # matches; at least one block always streams (its FIN adopts)
        sess = (meta or {}).get("session")
        shared: List[int] = []
        skip = 0
        chain = ((sess or {}).get("chain") or (meta or {}).get("chain")
                 or [])
        if chain and total_blocks > 1:
            shared, skip = self.pool.match_and_ref(
                chain, min(len(chain), total_blocks - 1))
        dst = self.pool.lease_upto(total_blocks - skip)
        if not dst:
            if shared:
                self.pool.release(shared)
            return None  # saturated: credits 0, the router backs off
        self._rids.add(rid)
        ctx = {"rid": rid, "dst": dst, "total": total_blocks - skip,
               "chunk_blocks": int(chunk_blocks), "written": 0,
               "closed": False, "codec": str(codec), "slot": None,
               "skip": skip, "shared": shared,
               "opened": time.perf_counter()}
        # speculative adoption: reserve a free slot and publish the
        # prefill's first token (a session: its whole tail) now.  Device
        # state is untouched until FIN (the slot stays inactive, its row
        # on the garbage block), so a rollback is host work only.
        if self.speculative and meta is not None:
            try:
                first = int(meta["first"])
            except (KeyError, TypeError, ValueError):
                return ctx  # malformed meta fails at FIN, typed
            with self._spec_lock:
                slot = next(iter(self._free_slots()), None)
                if slot is not None:
                    self._spec_slots[slot] = rid
                    ctx["slot"] = slot
                    try:
                        self.out[rid] = ([int(t) for t in sess["tail"]]
                                         if sess else [first])
                    except (KeyError, TypeError, ValueError):
                        self.out[rid] = [first]  # malformed: FIN decides
                    self.pool.count(spec_adoptions=1)
                    # the speculative publish is the first token (the
                    # loopback topologies share the sender's ledger; a
                    # remote receiver has no record and this is a no-op)
                    LEDGER.first_token(rid)
        return ctx

    def wire_credits(self, ctx) -> int:
        return len(ctx["dst"])

    def wire_top_up(self, ctx) -> int:
        need = ctx["total"] - len(ctx["dst"])
        if need > 0 and not ctx["closed"]:
            ctx["dst"].extend(self.pool.lease_upto(need))
        return len(ctx["dst"])

    def _wire_leaf_meta(self):
        """``[(n_elem, shape, torch dtype, itemsize)]`` of the pool
        leaves in wire order, fixed for the engine's life."""
        if self._wire_meta is None:
            self._wire_meta = _leaf_meta(wire_leaves(self.cache["layers"]))
        return self._wire_meta

    def wire_write(self, ctx, block_off: int, nblocks: int,
                   payload) -> None:
        """Scatter one received chunk into its pre-leased blocks.  The
        payload goes to the device in one copy and is cut into leaves
        there; under the quantized codecs the dequantization (int4: the
        nibble unpack too) runs on the device, in the scatter's stream
        order."""
        codec = ctx.get("codec")
        meta = self._wire_leaf_meta()
        buf = memoryview(payload)
        expect = _payload_bytes(meta, codec, nblocks)
        if len(buf) != expect:
            raise ValueError(
                f"{codec} chunk payload {len(buf)} bytes != expected "
                f"{expect} (truncated scale or data segment)")
        # the scales are read on the host from the bytes already there:
        # the error bound's input
        if codec in wirecodec.QUANT_CODECS:
            off = 0
            for n_elem, *_ in meta:
                scales = np.frombuffer(buf[off:off + 4 * nblocks], "<f4")
                if scales.size:
                    self.wire_quant_max_scale = max(
                        self.wire_quant_max_scale, float(scales.max()))
                off += 4 * nblocks + _quant_bytes(codec, n_elem, nblocks)
            self.wire_quant_codec = codec
        idx = torch.as_tensor(ctx["dst"][block_off:block_off + nblocks],
                              device=self.device).long()
        scatter_payload(wire_leaves(self.cache["layers"]), meta, idx,
                        chunk_to_device(buf, self.device), codec)
        self.pool.count(handoff_host_bytes=len(buf))
        ctx["written"] = block_off + nblocks

    def _wire_release(self, ctx) -> None:
        """Release every reference a stream's ctx holds: its pre-leased
        blocks and the registry-matched prefix of a suffix-only OPEN."""
        blocks = list(ctx.get("shared") or []) + list(ctx["dst"])
        if blocks:
            self.pool.release(blocks)

    def wire_finish(self, ctx, meta: dict) -> None:
        ctx["closed"] = True
        LEDGER.mark(ctx["rid"], "handoff_done")
        ctx["finished"] = time.perf_counter()
        sess = (meta or {}).get("session")
        try:
            seq_len = int(meta["handle"]["seq_len"])
            first = int(meta.get("first", 0))
            num_new = int(meta.get("num_new", 1))
            submitted = float(meta.get("submitted", 0.0))
            tail = None
            frozen = False
            if sess is not None:
                tail = [int(t) for t in sess["tail"]]
                if not tail:
                    raise ValueError("empty session tail")
                frozen = bool(sess.get("done"))
                first = tail[-1]  # the next decode step's input token
        except (KeyError, TypeError, ValueError) as e:
            self._spec_rollback(ctx)
            self._wire_release(ctx)
            self._rids.discard(ctx["rid"])
            raise WireError(f"malformed wire stream meta: {e}") from e
        if seq_len + num_new > self.model.max_seq:
            # backstop of the wire_open check: never adopt past max_seq
            self._spec_rollback(ctx)
            self._wire_release(ctx)
            self._rids.discard(ctx["rid"])
            raise WireError(
                f"seq_len ({seq_len}) + num_new ({num_new}) exceeds "
                f"max_seq ({self.model.max_seq})")
        # the matched prefix, then the streamed blocks, in table order;
        # the shared references now belong to the slot
        blocks = list(ctx.get("shared") or []) + list(ctx["dst"])
        doc = sess if sess is not None else meta
        chain = doc.get("chain") or []
        # an absent or zero granularity never registers: an unattested
        # chain could name the wrong token spans
        bs = int(doc.get("chain_bs", 0) or 0)
        pa = _PendingAdopt(
            ctx["rid"], blocks, seq_len, first, num_new, "wire", None,
            submitted, tail=tail, frozen=frozen,
            chain=(list(chain)[:len(blocks)]
                   if chain and bs == self.block_size else None))
        slot = ctx.get("slot")
        with self._spec_lock:
            reserved = (slot is not None
                        and self._spec_slots.pop(slot, None) == ctx["rid"])
        if reserved:
            # the slot was this stream's since OPEN: bind now, on the
            # last chunk, without queueing for a free slot
            self._slot_blocks[slot] = list(blocks)
            self._adopt_group([(slot, pa, list(blocks))])
        else:
            self.queue.append(pa)
            self._admit_pending()

    def _spec_rollback(self, ctx) -> None:
        """Retract a speculative reservation: free the slot and
        un-publish the early first token (host only)."""
        slot = ctx.get("slot")
        if slot is None:
            return
        with self._spec_lock:
            if self._spec_slots.pop(slot, None) == ctx["rid"]:
                self.out.pop(ctx["rid"], None)
                self.pool.count(spec_rollbacks=1)
        ctx["slot"] = None

    def wire_abort(self, ctx) -> None:
        if ctx["closed"]:
            return
        ctx["closed"] = True
        self._spec_rollback(ctx)
        self._wire_release(ctx)
        self._rids.discard(ctx["rid"])

    # -- admission: drain claimed handles into free slots ---------------
    def _admit_pending(self) -> None:
        progress = True
        while progress:
            progress = False
            group: List[Tuple[int, _PendingAdopt, List[int]]] = []
            for slot in self._free_slots():
                if not self.queue:
                    break
                if not self._slot_is_free(slot):
                    continue
                pa: _PendingAdopt = self.queue[0]
                if pa.mode == "copy":
                    # head-of-line: the oldest adoption waits for blocks
                    dst = self.pool.try_lease(len(pa.blocks))
                    if dst is None:
                        break
                else:
                    dst = list(pa.blocks)
                self.queue.popleft()
                self._slot_blocks[slot] = dst
                group.append((slot, pa, dst))
            if group:
                self._adopt_group(group)
                progress = True

    def _adopt_group(
            self, group: List[Tuple[int, _PendingAdopt, List[int]]]) -> None:
        # shared and wire adoptions are binds by now (the blocks already
        # hold the K/V in this pool); copies go per source engine
        bindable = [e for e in group if e[1].mode in ("shared", "wire")]
        by_src: Dict[int, list] = {}
        for e in group:
            if e[1].mode == "copy":
                by_src.setdefault(id(e[1].source), []).append(e)
        if bindable:
            self._bind_rows(bindable)
            for mode in ("shared", "wire"):
                sub = [e for e in bindable if e[1].mode == mode]
                if sub:
                    self.pool.count(**{f"handoff_{mode}": len(sub)},
                                    handoff_blocks=sum(len(d)
                                                       for *_, d in sub))
        for sub in by_src.values():
            self._copy_rows(sub)
        # host bookkeeping: the first token is a known int (the prefill
        # harvested it as a token; cache contents never reach the host).
        # A migrated session resumes its whole transcript and EOS state.
        tr = trace.tracing()
        for slot, pa, dst in group:
            tail = pa.tail if pa.tail is not None else [pa.first]
            self.rid[slot] = pa.rid
            self.out[pa.rid] = list(tail)
            self.active[slot] = True
            self.done_frozen[slot] = pa.frozen or (
                self.eos_id is not None and pa.first == self.eos_id)
            self.remaining[slot] = pa.num_new - 1
            self._slot_base[slot] = pa.seq_len - (len(tail) - 1)
            self._slot_chain.pop(slot, None)
            if pa.chain:
                # decode-side prefix adoption (the bind or copy is
                # enqueued above, so later readers see written blocks)
                self.pool.register_prefix(pa.chain[:len(dst)], dst)
                self._slot_chain[slot] = list(pa.chain)
            if pa.submitted:
                _QTFT_HIST.observe(time.perf_counter() - pa.submitted)
            if tr:
                # adoption ends here; without a speculative publish this
                # is also the first token (first_token is idempotent)
                LEDGER.mark(pa.rid, "adopted")
                LEDGER.first_token(pa.rid)
            self._maybe_retire(slot)

    def _bind_rows(self, entries) -> None:
        """Table rows, positions and first tokens of a group of slots,
        written in place into the tensors the decode graphs read."""
        rows = np.zeros((len(entries), self.nb_max), np.int32)
        for r, (_slot, _pa, dst) in enumerate(entries):
            rows[r, :len(dst)] = dst
        dev = self.device
        slots = torch.as_tensor([s for s, *_ in entries], device=dev).long()
        self.cache["block_table"].index_copy_(
            0, slots, torch.as_tensor(rows, device=dev))
        self.cache["pos"].index_copy_(0, slots, torch.as_tensor(
            [pa.seq_len for _s, pa, _d in entries], dtype=torch.int32,
            device=dev))
        self.tok.index_copy_(0, slots, torch.as_tensor(
            [pa.first for _s, pa, _d in entries], dtype=torch.int32,
            device=dev))

    def _copy_rows(self, entries) -> None:
        """Cross-pool adoption: one ``index_select`` of the source pool's
        blocks and one ``index_copy_`` into the leased blocks per leaf,
        then the bind.  Device to device only."""
        src_engine = entries[0][1].source
        src_leaves = src_engine.pool_leaves()
        dst_leaves = wire_leaves(self.cache["layers"])
        src_idx = [b for _s, pa, _d in entries for b in pa.blocks]
        dst_idx = [b for _s, _pa, dst in entries for b in dst]
        si = torch.as_tensor(src_idx, device=src_leaves[0].device).long()
        di = torch.as_tensor(dst_idx, device=self.device).long()
        for src, dst in zip(src_leaves, dst_leaves):
            dst.index_copy_(0, di, src.index_select(0, si).to(
                device=dst.device, dtype=dst.dtype))
        self._bind_rows(entries)
        # the copy is enqueued ahead of any later source-pool write, so
        # the host-side free is safe now
        for _slot, pa, _dst in entries:
            src_engine.pool.release(pa.blocks)
        per_block = sum(int(np.prod(t.shape[1:])) * t.element_size()
                        for t in src_leaves)
        self.pool.count(handoff_copy=len(entries),
                        handoff_blocks=len(src_idx),
                        handoff_device_bytes=len(src_idx) * per_block)

    def stats(self) -> dict:
        out = super().stats()
        out["replica"] = self.replica_id
        out["slots_active_ratio"] = out["active_slots"] / max(
            1, self.max_batch)
        return out
