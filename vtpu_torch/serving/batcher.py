"""Continuous batching for the port's TransformerLM serving path.

``vtpu/serving/batcher.py::ContinuousBatcher`` over the dense KV cache,
and the scheduling core that ``PagedBatcher`` builds on: a fixed
``[max_batch]`` slot array where each slot is an independent request at
its own depth; requests join mid-flight, in batched admission rounds
whose prompts are padded to power-of-two buckets; decode runs in windows
of ``harvest_every`` steps, with up to ``pipeline_depth`` windows in
flight, each carrying the slot->rid snapshot it was dispatched under;
post-EOS tokens are frozen to ``eos_id`` and overshoot past a budget is
dropped at harvest.

On CUDA a window of k decode steps is one captured CUDA graph, the
counterpart of the reference's jitted ``_step_k``: the first window of
each length k runs eagerly (as the first call of a jitted function
traces and compiles, it does the host work of the kernels' first calls:
the build, the shared-memory opt-ins, the occupancy queries, cuBLAS's
handle), and is then captured; every later window of that length is one
replay.  k is a power of two up to ``harvest_every``, so an engine holds
at most log2(harvest_every) + 1 graphs, and releases them with itself.
A capture that fails raises; it never falls back to the eager window.
A graph reads and writes the tensors it was captured with, so the slot
state it touches -- ``tok``, the cache's ``pos``, ``block_table`` and
pools -- is only ever written in place.  ``decode_graph="off"`` keeps the
eager window on the card (for comparisons); on the CPU the window is
always eager.

A window's tokens go device->host with ``non_blocking=True`` into pinned
memory behind a recorded CUDA event (the counterpart of JAX's
``copy_to_host_async``), enqueued right after the window, so the next
replay cannot overwrite a window still in flight; the harvest waits on
that event only.  PyTorch dispatches kernels asynchronously, so the next
window is already queued on the card while the host harvests the
previous one.

Dense admission (the reference's ``_admit_prog``): per prompt-length
bucket, the group's padded prompts prefill in a zero row cache of the
group's row bucket, each row's first token is the argmax at its true
last prompt token, and the rows replace whole rows of the batch cache
(``index_copy_``, in place, for the graphs) with their true positions.
A prompt longer than ``prefill_chunk`` prefills in a row cache of its
own, one chunk per ``step()``.

Observability, at the reference's sites: ``LEDGER.ensure`` at submit,
the ``prefill_start``/``prefill_done`` marks around each admission
forward, ``first_token`` where the host first holds the token (the
harvest's flush), ``token`` and ``finish`` at harvest; the
``decode_window`` span, the dispatch histogram and the windows counter
around the call that enqueues a window (on CUDA, the graph replay).  No
hook sits inside a captured window: host code in a captured region runs
once, at capture.  With tracing off the ledger and spans cost one flag
check; the histograms, gauges and counters always count.

Greedy decoding; every request's tokens are identical to the JAX
engine's on the same weights and schedule (tests/test_torch_dense.py,
tests/test_torch_paged.py).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from vtpu_torch import obs
from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import TransformerLM, bucket_length
from vtpu_torch.ops.layernorm import fused_layernorm
from vtpu_torch.ops.paged_attention import paged_attention_decode
from vtpu_torch.serving.reqtrace import LEDGER
from vtpu_torch.utils import trace

_REG = obs.registry("serving")

# submit() -> the request's first harvested token (queue wait + prefill)
_QTFT_HIST = _REG.histogram(
    "vtpu_batcher_queue_to_first_token_seconds",
    "Latency from submit() to the request's first generated token",
)
# per-window host cost of the wait for tokens and the harvest;
# overlapped=yes: a newer window was already queued on the device
_HARVEST_HIST = _REG.histogram(
    "vtpu_batcher_harvest_overlap_seconds",
    "Host time to materialize and harvest one decode window's tokens",
)
_DISPATCH_HIST = _REG.histogram(
    "vtpu_batcher_window_dispatch_seconds",
    "Host time to enqueue one fused decode window (async dispatch)",
)
_DEPTH_GAUGE = _REG.gauge(
    "vtpu_batcher_dispatch_depth_ratio",
    "In-flight decode windows over the configured pipeline_depth",
)
_ACTIVE_GAUGE = _REG.gauge(
    "vtpu_batcher_slots_active_ratio",
    "Active decode slots over max_batch",
)
_WINDOWS_TOTAL = _REG.counter(
    "vtpu_batcher_windows_dispatched_total",
    "Fused decode windows dispatched to the device",
)


@dataclasses.dataclass
class _Request:
    rid: str
    prompt: np.ndarray  # [s] int32
    num_new: int
    submitted: float = 0.0  # perf_counter at submit()


class _HostCopy:
    """A device->host copy in flight.  On CUDA: a pinned buffer filled
    with ``non_blocking=True`` and the event recorded after it; on the
    CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


def _launch_counts() -> Dict[str, int]:
    """The decode window's kernel launch counters, by wrapper."""
    return {"layernorm": fused_layernorm.launches,
            **{f"paged_{k}": v
               for k, v in paged_attention_decode.launches.items()}}


def _add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counters of :func:`_launch_counts`: a replay
    launches the kernels without their wrappers' Python, which counted
    them once, while the graph was captured."""
    fused_layernorm.launches += delta["layernorm"]
    for k in paged_attention_decode.launches:
        paged_attention_decode.launches[k] += delta[f"paged_{k}"]


@dataclasses.dataclass
class _WindowGraph:
    """A captured window of k decode steps: the graph, the [k, b] token
    buffer it writes, and the kernel launches one replay makes."""

    graph: "torch.cuda.CUDAGraph"
    toks: torch.Tensor
    launches: Dict[str, int]


class ContinuousBatcher:
    """Slot-based continuous batching over the model's KV cache."""

    def __init__(self, model: TransformerLM, max_batch: int,
                 eos_id: Optional[int] = None, prefill_chunk: int = 0,
                 harvest_every: int = 1, pipeline_depth: int = 1,
                 bucket_prefill: bool = True, decode_graph: str = "auto", *,
                 device="cuda"):
        if (model.kv_cache_layout == "paged"
                and type(self) is ContinuousBatcher):
            raise ValueError(
                "paged models need vtpu_torch.serving.paged.PagedBatcher")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(
                f"the model lives on {model.device}, the engine was asked "
                f"for {dev}")
        if decode_graph not in ("auto", "off"):
            raise ValueError(f"decode_graph must be 'auto' or 'off', got "
                             f"{decode_graph!r}")
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.eos_id = eos_id
        # > 0: long prompts prefill in chunks interleaved with decode
        # steps of the other slots (one chunk per step)
        self.prefill_chunk = prefill_chunk
        self.bucket_prefill = bool(bucket_prefill)
        self.prefilling: Dict[int, dict] = {}  # slot -> progress state
        self.cache = model.init_cache(max_batch)
        # last token per slot; one buffer for the engine's life (the
        # decode graphs read and write it)
        self.tok = torch.zeros((max_batch,), dtype=torch.int32,
                               device=self.device)
        # window length k -> its captured graph (CUDA, decode_graph="auto")
        self.decode_graph = decode_graph
        self._graphs: Dict[int, _WindowGraph] = {}
        # host-side slot state (the device never sees it)
        self.active = [False] * max_batch
        self.remaining = [0] * max_batch
        self.done_frozen = [False] * max_batch
        self.rid: List[Optional[str]] = [None] * max_batch
        self.out: Dict[str, List[int]] = {}
        self.queue: collections.deque[_Request] = collections.deque()
        # every rid ever submitted: a finished rid stays taken
        self._rids: Set[str] = set()
        self.harvest_every = max(1, int(harvest_every))
        # windows in flight: (host copy, slot->rid snapshot, k, issued)
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._inflight: collections.deque[
            Tuple[_HostCopy, list, int, float]] = collections.deque()
        # admissions whose first tokens are still in flight:
        # (host copy of [n] firsts, [(slot, req), ...], issued)
        self._pending_first: collections.deque = collections.deque()
        # device->host materialization hook: (host copy, issue time) ->
        # np.ndarray; a transport layer may override it
        self._fetch = lambda hc, issued: hc.numpy()
        self.steps = 0  # decode forwards executed (batch-wide)
        self._row_tmpls: Dict[int, dict] = {}  # rows -> zero row cache

    # ------------------------------------------------------------------
    def _step_k(self, k: int) -> torch.Tensor:
        """k decode steps over every slot; returns the [k, b] tokens and
        leaves the last ones in ``self.tok``.  Finished rows overshoot
        harmlessly: dense writes clamp into the row's own last position;
        paged writes fall off the leased table into the garbage block (or
        clamp into their own last block).  On CUDA the
        returned buffer is the window graph's own, rewritten by its next
        replay: the caller copies it out first."""
        wg = self._graphs.get(k)
        if wg is not None:
            wg.graph.replay()
            _add_launches(wg.launches)
            return wg.toks
        toks = self._run_window(self._tokens_buffer(k))
        if self.device.type == "cuda" and self.decode_graph == "auto":
            self._graphs[k] = self._capture(k)
        return toks

    def _tokens_buffer(self, k: int) -> torch.Tensor:
        return torch.empty((k, self.max_batch), dtype=torch.int32,
                           device=self.device)

    def _run_window(self, toks: torch.Tensor) -> torch.Tensor:
        """The window's forwards, argmaxes and token writes into the
        [k, b] buffer ``toks``; ``self.tok`` is updated in place."""
        tok = self.tok
        for j in range(toks.shape[0]):
            logits = self.model(tok[:, None], self.cache)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
            toks[j] = tok
        self.tok.copy_(tok)
        return toks

    def _capture(self, k: int) -> _WindowGraph:
        """Capture a window of k steps (after an eager window of the same
        length has run).  Capture runs no kernel, so the launches its
        wrappers count are taken back and added at each replay."""
        toks = self._tokens_buffer(k)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._run_window(toks)
        after = _launch_counts()
        _add_launches({n: before[n] - after[n] for n in after})
        return _WindowGraph(graph, toks,
                            {n: after[n] - before[n] for n in after})

    def submit(self, rid: str, prompt, num_new: int) -> None:
        """Queue a request; admitted as soon as a slot frees up."""
        if num_new < 1:
            raise ValueError(f"num_new must be >= 1, got {num_new}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if prompt.size + num_new > self.model.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + num_new ({num_new}) exceeds "
                f"max_seq ({self.model.max_seq})"
            )
        if rid in self._rids:
            raise ValueError(f"duplicate request id {rid!r}")
        self._rids.add(rid)
        LEDGER.ensure(rid)  # direct-submit topologies skip the router
        self.queue.append(_Request(rid, prompt, num_new,
                                   submitted=time.perf_counter()))
        self._admit_pending()

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch)
                if not self.active[i] and i not in self.prefilling]

    def _slot_is_free(self, slot: int) -> bool:
        return not self.active[slot] and slot not in self.prefilling

    def _admit_pending(self) -> None:
        """Drain the queue into every free slot, one batched prefill per
        prompt-length bucket.  Loops because a group may retire at once
        (num_new == 1) and free its slots for the next group."""
        progress = True
        while progress and self.queue:
            progress = False
            group: List[Tuple[int, _Request]] = []
            for slot in self._free_slots():
                if not self.queue:
                    break
                if not self._slot_is_free(slot):
                    continue
                req = self.queue.popleft()
                if 0 < self.prefill_chunk < req.prompt.size:
                    # long prompt: reserve the slot and prefill chunk by
                    # chunk from step().  The cache is its own: prefill
                    # writes it in place, so a shared template could
                    # not hold two prefills at once
                    self.prefilling[slot] = {
                        "req": req, "cache": self.model.init_cache(1),
                        "done": 0, "pf": self._prefill}
                    progress = True
                    continue
                group.append((slot, req))
            if group:
                self._admit_batch(group)
                progress = True

    def _prefill(self, cache: dict, chunk: torch.Tensor):
        return self.model(chunk, cache), cache

    def _bucket_len(self, n: int) -> int:
        if not self.bucket_prefill:
            return n
        return bucket_length(n, self.model.max_seq)

    def _bucket_rows(self, n: int) -> int:
        """Row-count bucket of an admission group (a power of two);
        padding rows are garbage and are dropped at publish."""
        if not self.bucket_prefill:
            return n
        return 1 << (n - 1).bit_length()

    def _row_template(self, rows: int) -> dict:
        """The zero row cache of a ``rows``-row admission group: one per
        row bucket for the engine's life, never the batch cache's
        tensors.  Prefill writes it in place, so it is zeroed before each
        use, as the reference prefills in a fresh zero cache."""
        tmpl = self._row_tmpls.get(rows)
        if tmpl is None:
            tmpl = self._row_tmpls[rows] = self.model.init_cache(rows)
            return tmpl
        tmpl["pos"].zero_()
        for layer in tmpl["layers"]:
            for t in layer.values():
                t.zero_()
        return tmpl

    def _admit_batch(self, group: List[Tuple[int, _Request]]) -> None:
        """Per prompt-length bucket, the reference's ``_admit_prog``:
        prefill the padded group in a zero row cache, argmax each row's
        logits at its true last prompt token (the padding after it is
        causally invisible), and write the rows, their true positions
        and first tokens into the batch state.  No host sync: the first
        tokens are read at the next harvest."""
        by_bucket: Dict[int, List[Tuple[int, _Request]]] = {}
        for slot, req in group:
            by_bucket.setdefault(self._bucket_len(req.prompt.size),
                                 []).append((slot, req))
        dev = self.device
        tr = trace.tracing()
        for blen, sub in by_bucket.items():
            n = len(sub)
            rows = self._bucket_rows(n)
            toks = np.zeros((rows, blen), np.int32)
            for r, (_slot, req) in enumerate(sub):
                toks[r, :req.prompt.size] = req.prompt
            lens = np.asarray([req.prompt.size for _s, req in sub], np.int32)
            tmpl = self._row_template(rows)
            if tr:
                for _slot, req in sub:
                    LEDGER.mark(req.rid, "prefill_start")
            logits = self.model(torch.as_tensor(toks, device=dev), tmpl)
            last = torch.as_tensor(lens - 1, device=dev).long()
            firsts = logits[torch.arange(n, device=dev), last].argmax(
                dim=-1).to(torch.int32)
            if tr:
                # the enqueue boundary: the device's residue shows up in
                # decode_window, at the harvest that reads the token
                for _slot, req in sub:
                    LEDGER.mark(req.rid, "prefill_done")
            # the reference scatters every row and drops the pad rows
            # (slot index max_batch is out of bounds there); index_copy_
            # raises on such an index, so only the group's rows go
            slots = np.asarray([slot for slot, _r in sub], np.int32)
            self._merge_rows(slots, tmpl, lens)
            self.tok.index_copy_(
                0, torch.as_tensor(slots, device=dev).long(), firsts)
            self._queue_first(firsts, sub)

    def _merge_rows(self, slots: np.ndarray, rows_cache,
                    pos: np.ndarray) -> None:
        """Replace whole rows of the batch cache at ``slots`` with the
        first ``len(slots)`` rows of ``rows_cache`` (a slot's previous
        tenant leaves no K/V behind; masking only hides positions >= its
        counter) and publish each row's true position.  In place: the
        decode graphs read these tensors."""
        n = len(slots)
        idx = torch.as_tensor(np.asarray(slots), device=self.device).long()
        for dst, src in zip(self.cache["layers"], rows_cache["layers"]):
            for name, t in dst.items():
                t.index_copy_(0, idx, src[name][:n])
        self.cache["pos"].index_copy_(0, idx, torch.as_tensor(
            np.asarray(pos, np.int32), device=self.device))

    def _on_retire(self, slot: int) -> None:
        """Hook: a slot left decode rotation."""

    def _retire_rows(self, slots: List[int]) -> None:
        for slot in slots:
            self._on_retire(slot)

    def _activate(self, slot: int, req: _Request, logits, row_cache) -> None:
        """Single-row activation tail (chunked-prefill admissions);
        ``logits`` are already sliced to the true last prompt token."""
        self._merge_rows(np.asarray([slot], np.int32), row_cache,
                         np.asarray([req.prompt.size], np.int32))
        first = logits[:, -1].argmax(dim=-1).to(torch.int32)  # [1]
        self.tok[slot] = first[0]
        self._queue_first(first, [(slot, req)])

    def _queue_first(self, firsts: torch.Tensor, items) -> None:
        """Host-side slot bookkeeping shared by batched and chunked
        admission.  ``firsts`` stays on the device; its copy is started
        now and read at the next harvest's flush."""
        self._pending_first.append((_HostCopy(firsts), list(items),
                                    time.perf_counter()))
        for slot, req in items:
            self.rid[slot] = req.rid
            self.out[req.rid] = []
            self.active[slot] = True
            self.done_frozen[slot] = False
            self.remaining[slot] = req.num_new - 1
            self._maybe_retire(slot)

    def _flush_first_tokens(self) -> None:
        """Materialize every pending admission's first token (FIFO): the
        host holds it here, so this is where the ledger's first_token
        mark goes."""
        tr = trace.tracing()
        while self._pending_first:
            firsts, items, issued = self._pending_first.popleft()
            vals = self._fetch(firsts, issued)
            for (slot, req), v in zip(items, vals):
                first = int(v)
                self.out[req.rid].append(first)
                if req.submitted:
                    _QTFT_HIST.observe(time.perf_counter() - req.submitted)
                if tr:
                    LEDGER.first_token(req.rid)
                    if len(self.out[req.rid]) >= req.num_new:
                        # num_new == 1: retired at admission, before
                        # this flush could see the token
                        LEDGER.finish(req.rid)
                # freeze only if the rid still owns the slot
                if (self.rid[slot] == req.rid and self.eos_id is not None
                        and first == self.eos_id):
                    self.done_frozen[slot] = True

    def _advance_prefill(self) -> None:
        """One prefill chunk for the longest-waiting prefilling slot.
        Under ``bucket_prefill`` the tail chunk is padded to the chunk
        length (capped so writes never pass max_seq); the activation
        publishes the true prompt length."""
        if not self.prefilling:
            return
        slot = next(iter(self.prefilling))
        st = self.prefilling[slot]
        req, lo = st["req"], st["done"]
        chunk = req.prompt[lo:lo + self.prefill_chunk]
        real = len(chunk)
        if self.bucket_prefill and real < self.prefill_chunk:
            pad_to = min(self.prefill_chunk, self.model.max_seq - lo)
            if pad_to > real:
                chunk = np.concatenate(
                    [chunk, np.zeros(pad_to - real, np.int32)])
        logits, st["cache"] = st["pf"](
            st["cache"],
            torch.as_tensor(chunk, device=self.device)[None, :])
        st["done"] += real
        if st["done"] >= req.prompt.size:
            del self.prefilling[slot]
            self._pre_activate(slot, st)
            self._activate(slot, req, logits[:, real - 1:real], st["cache"])

    def _pre_activate(self, slot: int, st: dict) -> None:
        """Hook: a chunked admission is about to activate."""

    def _maybe_retire(self, slot: int) -> None:
        if self.remaining[slot] <= 0:
            rid = self.rid[slot]
            self.active[slot] = False
            self.rid[slot] = None
            self._on_retire(slot)
            # an instant retirement whose transcript already holds its
            # tokens (an adoption published the first token) closes its
            # record now; a pending first token closes it at the flush
            if rid is not None and self.out.get(rid) and trace.tracing():
                LEDGER.finish(rid)

    # ------------------------------------------------------------------
    def _inflight_tokens(self) -> int:
        return sum(k for _, _, k, _t in self._inflight)

    def _window(self) -> int:
        """Decode steps to run this round, net of windows in flight; 0 =
        harvest instead.  1 while a chunked prefill is in flight;
        otherwise min(harvest_every, remaining budget) rounded down to a
        power of two."""
        rem = max(
            (self.remaining[i] for i in range(self.max_batch)
             if self.active[i]),
            default=0,
        ) - self._inflight_tokens()
        if rem <= 0:
            return 0
        if self.harvest_every <= 1 or self.prefilling:
            return 1
        k = min(self.harvest_every, rem)
        return 1 << (k.bit_length() - 1)

    def _harvest_oldest(self) -> None:
        """Materialize and account the oldest in-flight window."""
        if not self._inflight:
            return
        toks, rids, _k, issued = self._inflight.popleft()
        overlapped = bool(self._inflight)
        t0 = time.perf_counter()
        self._harvest_window(self._fetch(toks, issued), rids)
        _HARVEST_HIST.observe(time.perf_counter() - t0,
                              overlapped="yes" if overlapped else "no")
        _DEPTH_GAUGE.set(len(self._inflight) / max(1, self.pipeline_depth))
        _ACTIVE_GAUGE.set(sum(self.active) / max(1, self.max_batch))

    def _harvest_window(self, toks_np, rids) -> None:
        """Append a [k, b] window of tokens to each request active in
        ``rids`` (the snapshot taken at dispatch: a slot re-tenanted
        while the window was in flight does not take its tokens), with
        EOS freeze and overshoot drop."""
        self._flush_first_tokens()
        tr = trace.tracing()  # once per window, not per token
        k = toks_np.shape[0]
        finished = []
        for i in range(self.max_batch):
            rid = rids[i]
            if rid is None or self.rid[i] != rid:
                continue  # slot retired (maybe re-tenanted) mid-flight
            for j in range(k):
                if self.remaining[i] <= 0:
                    break
                t = int(toks_np[j, i])
                if self.done_frozen[i]:
                    t = self.eos_id
                elif self.eos_id is not None and t == self.eos_id:
                    self.done_frozen[i] = True
                self.out[rid].append(t)
                self.remaining[i] -= 1
                if tr:
                    LEDGER.token(rid)
            if self.remaining[i] <= 0:
                finished.append(i)
        for i in finished:
            self.active[i] = False
            self.rid[i] = None
        if finished:
            self._retire_rows(finished)
            if tr:
                for i in finished:
                    LEDGER.finish(rids[i])
        self._admit_pending()

    def step(self) -> None:
        """One prefill chunk (if a slot is admitting) + one decode window
        for every active slot; harvest the oldest window once more than
        ``pipeline_depth`` are in flight."""
        self._advance_prefill()
        if not any(self.active):
            if self._inflight:
                self._harvest_oldest()
            elif self.queue:
                self._admit_pending()
            else:
                self._flush_first_tokens()
            return
        k = self._window()
        if k == 0:
            self._harvest_oldest()
            return
        t0 = time.perf_counter()
        # the span records the enqueue of the window (on CUDA, of its
        # graph replay), as the reference's records the async dispatch;
        # {} while tracing is off
        sp = trace.start_span("decode_window", k=k, active=sum(self.active))
        toks = self._step_k(k)
        trace.end_span(sp)
        _DISPATCH_HIST.observe(time.perf_counter() - t0)
        _WINDOWS_TOTAL.inc()
        self.steps += k
        self._inflight.append((_HostCopy(toks), list(self.rid), k,
                               time.perf_counter()))
        _DEPTH_GAUGE.set(len(self._inflight) / max(1, self.pipeline_depth))
        while len(self._inflight) > self.pipeline_depth:
            self._harvest_oldest()

    def run(self) -> Dict[str, List[int]]:
        """Drive until every request has finished and every window is
        drained."""
        while (any(self.active) or self.queue or self.prefilling
               or self._inflight):
            self.step()
        self._flush_first_tokens()
        return self.out

    def stats(self) -> dict:
        return {
            "max_batch": self.max_batch,
            "active_slots": sum(self.active),
            "prefilling_slots": len(self.prefilling),
            "queued": len(self.queue),
            "decode_steps": self.steps,
            "inflight_windows": len(self._inflight),
            "pending_first_tokens": len(self._pending_first),
            "pipeline_depth": self.pipeline_depth,
            "decode_graphs": sorted(self._graphs),
            "completed": len(self.out) - sum(self.active),
        }
