#!/usr/bin/env python3
"""Prefill/decode disaggregation proof for the port: the twin of
``benchmarks/serving_disagg.py`` over ``vtpu_torch``'s engines and Router.

    python -m vtpu_torch.bench.serving_disagg [--smoke] [--device cuda]
        [--sim-seconds 20] [--repeats 3] [--out PATH]
    python -m vtpu_torch.bench.serving_disagg --kv [--smoke] [--out PATH]

The same phases, flags, model configurations and pass/fail rules as the
JAX bench (a broken rule is listed under ``verdict`` and makes the exit
code 1; the run goes on and the artifact is written all the same), and
the same artifact keys (``exactness``, ``wire``,
``wire_int8``, ``shared_prefix``, ``trace``, ``units``, ``arms`` and
``headline``; with ``--kv``: ``codec_curve``, ``spill``, ``restart``,
``torn_journal`` and ``headline``):

- **exactness**: one PrefillEngine and two DecodeEngines behind the
  port's Router serve a mixed stream token for token like a monolithic
  PagedBatcher, and ``vtpu_kv_handoff_host_bytes_total`` does not move
  (the run fails if it does);
- **wire** / **wire_int8**: the loopback wire transport, its hidden
  fraction under prefill compute, and the mid-stream death fuzz;
- **shared_prefix**: the speculative and prefix-cache arms;
- **trace**: tracing off against tracing on; the on arm's five ledger
  stages must sum to the measured TTFT within 5 %, and the off arm must
  record no span;
- **scale**: each program the roles run (a replayed decode window, a
  bucketed prefill, a cross-pool adopt) is timed on the device, with
  CUDA events on a card and the host clock on the CPU, and the
  ``monolithic`` / ``disagg_1/2/4`` / ``disagg_dyn`` arms replay open-loop
  traffic on virtual per-role device clocks charged with those costs.

``--device`` (default ``cuda``) places the engines; ``cpu`` is the
tier-1 smoke.  The artifact names the device it ran on, and a card run
also names its power limit.  Every phase function takes the device from
its caller (``chip_smoke.py`` and the tests call them).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pct(vals, q):
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, int(round(q * (len(s) - 1))))
    return s[idx]


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _model(kw: dict, block_size: int, pool_blocks: int, device):
    """The bench's paged model, f32, weights from the model's own seeded
    init (every call with the same knobs gives the same weights)."""
    from vtpu_torch.models.transformer import TransformerLM

    return TransformerLM(**kw, kv_cache_layout="paged",
                         kv_block_size=block_size,
                         kv_pool_blocks=pool_blocks, device=device)


def _leak_free(pool) -> bool:
    st = pool.stats()
    return (st["leased"] == 0 and st["detached_handles"] == 0
            and st["free"] == st["pool_blocks"] - 1)


def _tokens(rng, vocab, n):
    import numpy as np

    return rng.integers(0, vocab, n).astype(np.int32)


# ---------------------------------------------------------------------------
# Phase 1: real-topology exactness + handoff counters
# ---------------------------------------------------------------------------

def run_exactness(n_requests: int, device="cuda") -> dict:
    import numpy as np

    from vtpu_torch.serving import kvpool
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
    from vtpu_torch.serving.paged import PagedBatcher
    from vtpu_torch.serving.router import Router, RouterReject

    kw = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32)
    m = _model(kw, 8, 33, device)
    rng = np.random.default_rng(5)
    lens = [3, 5, 8, 9, 12, 17, 4, 24]
    news = [4, 6, 2, 8, 1, 5, 7, 3]
    reqs = [(f"r{i}", _tokens(rng, 64, lens[i % len(lens)]),
             news[i % len(news)]) for i in range(n_requests)]

    mono = PagedBatcher(m, 4, eos_id=2, device=device)
    for rid, p, n in reqs:
        mono.submit(rid, p, num_new=n)
    want = mono.run()

    c0 = {
        "handoffs": kvpool.HANDOFF_TOTAL.value(mode="copy"),
        "blocks": kvpool.HANDOFF_BLOCKS.value(),
        "device_bytes": kvpool.HANDOFF_DEVICE_BYTES.value(),
        "host_bytes": kvpool.HANDOFF_HOST_BYTES.value(),
        "stale": kvpool.HANDOFF_STALE.value(),
    }
    pf = PrefillEngine(m, device=device)
    reps = {f"d{i}": DecodeEngine(m, 4, eos_id=2, replica_id=f"d{i}",
                                  device=device) for i in range(2)}
    router = Router(pf, reps)
    shed_retries = 0
    for i, (rid, p, n) in enumerate(reqs):
        while True:  # a 429 client: pump the cluster forward, retry
            try:
                router.submit(f"sess{i % 4}", rid, p, num_new=n)
                break
            except RouterReject:
                shed_retries += 1
                router.pump()
    got = router.drain()
    return {
        "requests": n_requests,
        "token_exact": got == want,
        "handoffs": int(kvpool.HANDOFF_TOTAL.value(mode="copy")
                        - c0["handoffs"]),
        "handoff_blocks": int(kvpool.HANDOFF_BLOCKS.value() - c0["blocks"]),
        "handoff_device_bytes": int(kvpool.HANDOFF_DEVICE_BYTES.value()
                                    - c0["device_bytes"]),
        "handoff_host_bytes": int(kvpool.HANDOFF_HOST_BYTES.value()
                                  - c0["host_bytes"]),
        "stale_rejections": int(kvpool.HANDOFF_STALE.value() - c0["stale"]),
        "shed_retries": shed_retries,
        "pools_leak_free": (_leak_free(pf.pool)
                            and all(_leak_free(d.pool)
                                    for d in reps.values())),
    }


# ---------------------------------------------------------------------------
# Phase 1.5: the wire arm — real bytes over the chunked stream
# ---------------------------------------------------------------------------

def _overlap(lo, hi, spans):
    got = 0.0
    for a, b in spans:
        got += max(0.0, min(hi, b) - max(lo, a))
    return got


def run_wire(n_requests: int, smoke: bool, codec: str = "fp32",
             device="cuda") -> dict:
    """A PrefillEngine feeds a DecodeEngine through the loopback wire
    (the frames HttpKVLink ships): token exactness against the
    monolithic engine (fp32; the quantized codecs report a match
    fraction and the per-element error bound), payload bytes, the
    fraction of each stream's open-to-FIN time hidden under prefill
    compute (a writer thread pumps the streams while the next group
    prefills), and the mid-stream death fuzz, after which both pools
    must be leak-free."""
    import threading

    import numpy as np

    from vtpu_torch.serving import kvpool
    from vtpu_torch.serving import transport as tp
    from vtpu_torch.serving import wirecodec
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
    from vtpu_torch.serving.paged import PagedBatcher

    kw = dict(vocab=128, d_model=192, depth=2, num_heads=4, max_seq=128)
    m = _model(kw, 16, 129, device)
    rng = np.random.default_rng(7)
    lens = [112, 97, 116, 104, 88, 120, 93, 108]  # prefill-heavy prompts
    news = [8, 6, 10, 4, 12, 6, 8, 5]
    reqs = [(f"w{i}", _tokens(rng, 128, lens[i % len(lens)]),
             news[i % len(news)]) for i in range(n_requests)]

    mono = PagedBatcher(m, 8, eos_id=2, device=device)
    for rid, p, n in reqs:
        mono.submit(rid, p, num_new=n)
    want = mono.run()

    pf = PrefillEngine(m, device=device)
    dec = DecodeEngine(m, 8, eos_id=2, replica_id="w0", device=device)
    hub = tp.ReceiverHub(dec)
    rep = tp.WireReplica(tp.LoopbackLink(hub), "w0", local=dec,
                         chunk_blocks=4, codec=codec)

    def drive(requests, per_round=1, measure=None):
        """Open-loop drive, a few prompts a round: each round's streams
        open after its prefill group and push their chunks from a
        writer thread while the next group's prefill computes."""
        staging = list(requests)
        while (staging or pf.queue or rep.idle_senders() or dec.queue
               or any(dec.active) or dec._inflight):
            for rid, p, n in staging[:per_round]:
                pf.submit(rid, p, num_new=n)
            del staging[:per_round]
            stop = threading.Event()

            def _writer():
                while not stop.is_set() and rep.idle_senders():
                    try:
                        rep.pump_streams()
                    except tp.WireError:
                        return
                    if rep.idle_senders():
                        time.sleep(50e-6)  # credit-starved: yield

            w = None
            t0 = time.perf_counter()
            if rep.idle_senders():
                # one pump first: the senders' gathers enqueue ahead of
                # the next prefill forward, their D2H behind it
                rep.pump_streams()
                w = threading.Thread(target=_writer, daemon=True)
                w.start()
            results = pf.step()
            t1 = time.perf_counter()
            if results and measure is not None:
                measure["busy"].append((t0, t1))
            if w is not None:
                stop.set()
                w.join()
            # what the window did not cover drains here, unhidden
            while rep.idle_senders():
                before = tp.TRANSPORT_CHUNKS.value()
                rep.pump_streams()
                if (rep.idle_senders()
                        and tp.TRANSPORT_CHUNKS.value() == before):
                    dec.step()  # starved: retire slots -> credits
            dec.step()
            for res in results:
                rep.submit_handle(res.rid, res.handle, res.first_token,
                                  res.num_new, source=pf,
                                  submitted=res.submitted, admit=False)
                if measure is not None:
                    measure["streams"][res.rid] = rep._senders[-1]

    # warm-up over every program shape on the path (prefill buckets, the
    # wire gather and put, the adoption bind, the decode windows)
    warm = [(f"warm{i}", _tokens(rng, 128, L), 3)
            for i, L in enumerate([97, 104, 112, 120, 88, 116])]
    drive(warm)

    b0 = tp.TRANSPORT_BYTES.value()
    c0 = tp.TRANSPORT_CHUNKS.value()
    h0 = kvpool.HANDOFF_HOST_BYTES.value()
    measure = {"busy": [], "streams": {}}
    # two cool-down prompts keep the prefill tier fed behind the
    # measured set: the hidden fraction is a steady-state property
    cool = [(f"cool{i}", _tokens(rng, 128, L), 3)
            for i, L in enumerate([104, 112])]
    measured_rids = {rid for rid, _p, _n in reqs}
    t_start = time.perf_counter()
    drive(list(reqs) + cool, measure=measure)
    makespan = time.perf_counter() - t_start
    prefill_busy = measure["busy"]
    streams = {rid: s for rid, s in measure["streams"].items()
               if rid in measured_rids}
    dec._flush_first_tokens()
    got = {rid: toks for rid, toks in dec.out.items()
           if rid in measured_rids}
    now = time.perf_counter()
    durations, hidden = [], []
    for rid, s in streams.items():
        lo = s._t0                       # stamped at the OPEN frame
        hi = s.finished_at or now        # stamped at the final ack
        durations.append(hi - lo)
        hidden.append(_overlap(lo, hi, prefill_busy))
    total_d = sum(durations)
    hidden_fraction = (sum(hidden) / total_d) if total_d > 0 else 0.0

    def one_death(kind: str) -> bool:
        """One request through a dying link; True = both pools clean."""
        pfx = PrefillEngine(m, device=device)
        decx = DecodeEngine(m, 4, eos_id=2, device=device)
        hubx = tp.ReceiverHub(decx)
        state = {"n": 0}

        def fault(data):
            fr = tp.decode_frame(data)
            if fr.kind not in tp._DATA_KINDS or fr.seq == 0:
                return
            if kind == "first_chunk" and fr.seq == 1 and state["n"] == 0:
                state["n"] += 1
                raise OSError("torn")
            if kind == "mid_stream" and fr.seq == 2 and state["n"] == 0:
                state["n"] += 1
                raise OSError("torn")
            if kind == "every_frame":
                raise OSError("torn")

        repx = tp.WireReplica(tp.LoopbackLink(hubx, fault=fault), "wx",
                              local=decx, chunk_blocks=1, retries=2,
                              codec=codec)
        pfx.submit("rx", _tokens(rng, 128, 40), 4)
        res = pfx.step()[0]
        try:
            repx.submit_handle(res.rid, res.handle, res.first_token,
                               res.num_new, source=pfx)
            if kind == "receiver_abort":
                hubx.abort_all()         # replica death mid-adoption
                while repx.idle_senders():
                    try:
                        repx.step()
                    except tp.WireError:
                        break
            else:
                while repx.idle_senders():
                    repx.step()
        except tp.WireError:
            pass
        while any(decx.active) or decx._inflight or decx.queue:
            decx.step()
        # a dead stream's speculative reservation is rolled back too
        return (_leak_free(pfx.pool) and _leak_free(decx.pool)
                and not decx._spec_slots)

    fuzz_kinds = ["first_chunk", "mid_stream", "every_frame",
                  "receiver_abort"]
    fuzz = {k: one_death(k) for k in fuzz_kinds}

    bytes_moved = int(tp.TRANSPORT_BYTES.value() - b0)
    matched = sum(
        sum(a == b for a, b in zip(got.get(rid, []), toks))
        for rid, toks in want.items()
    )
    total_toks = sum(len(t) for t in want.values())
    return {
        "requests": n_requests,
        "codec": codec,
        "token_exact": got == want,
        "token_match_fraction": round(matched / max(1, total_toks), 4),
        "quant_error_bound": round(wirecodec.error_bound(
            dec.wire_quant_max_scale, dec.wire_quant_codec), 6),
        "bytes_on_wire": bytes_moved,
        "chunks": int(tp.TRANSPORT_CHUNKS.value() - c0),
        "streams": len(streams),
        "host_bytes_accounted": int(
            kvpool.HANDOFF_HOST_BYTES.value() - h0) == bytes_moved,
        "hidden_fraction": round(hidden_fraction, 4),
        "stream_ms_total": round(1e3 * total_d, 3),
        "prefill_busy_ms_total": round(
            1e3 * sum(b - a for a, b in prefill_busy), 3),
        "makespan_ms": round(1e3 * makespan, 3),
        "pools_leak_free": _leak_free(pf.pool) and _leak_free(dec.pool),
        "death_fuzz": {**fuzz, "leak_free_all": all(fuzz.values())},
    }


# ---------------------------------------------------------------------------
# Phase 1.75: high-fanout shared-prefix workload (codec x prefix cache)
# ---------------------------------------------------------------------------

def _fanout_drive(pf, dec, rep, requests, t_submit, check_first,
                  measure, what):
    """Seed alone, then pairs: the first request drains alone so its
    prefix registers before the fanout arrives."""
    from vtpu_torch.serving import transport as tp

    staging = list(requests)
    per_round = 1
    while (staging or pf.queue or rep.idle_senders()
           or dec.queue or any(dec.active) or dec._inflight):
        for rid, p, n in staging[:per_round]:
            pf.submit(rid, p, num_new=n)
            if measure:
                t_submit[rid] = time.perf_counter()
        del staging[:per_round]
        per_round = 2
        for res in pf.step():
            rep.submit_handle(res.rid, res.handle, res.first_token,
                              res.num_new, source=pf,
                              submitted=res.submitted, admit=False)
            check_first()   # speculative arms publish at OPEN
        stalls = 0
        while rep.idle_senders():
            before = tp.TRANSPORT_CHUNKS.value()
            rep.pump_streams()
            check_first()
            if (rep.idle_senders()
                    and tp.TRANSPORT_CHUNKS.value() == before):
                dec.step()   # starved: retire slots -> credits
                stalls += 1
                if stalls > 10000:
                    raise RuntimeError(f"{what} wedged")
        dec.step()
        check_first()


def run_shared_prefix(smoke: bool, device="cuda") -> dict:
    """Every session's prompt opens with the same 64-token system prefix
    (4 blocks) plus a unique suffix, over the wire, in four arms:
    ``fp32_nospec`` (first token waits for FIN), ``fp32`` (speculative
    adoption + prefix cache, token-exact), ``int8`` (quantized chunks +
    speculation) and ``int8_prefix`` (all three).  Per arm: wire bytes,
    first-token latency, tokens/s, prefix hits and skipped tokens, and
    exactness against a monolithic PagedBatcher."""
    import numpy as np

    from vtpu_torch.serving import kvpool
    from vtpu_torch.serving import transport as tp
    from vtpu_torch.serving import wirecodec
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
    from vtpu_torch.serving.paged import PagedBatcher

    kw = dict(vocab=128, d_model=192, depth=2, num_heads=4, max_seq=128)
    bs = 16
    m = _model(kw, bs, 257, device)
    rng = np.random.default_rng(13)
    prefix = _tokens(rng, 128, 64)  # 4 full blocks
    n_sessions = 6 if smoke else 20
    sufs = [5, 9, 13, 7, 11, 15]
    reqs = []
    for i in range(n_sessions):
        suffix = _tokens(rng, 128, sufs[i % len(sufs)])
        reqs.append((f"f{i}", np.concatenate([prefix, suffix]),
                     4 + (i % 3)))

    mono = PagedBatcher(m, 8, eos_id=2, device=device)
    for rid, p, n in reqs:
        mono.submit(rid, p, num_new=n)
    want = mono.run()
    total_toks = sum(len(t) for t in want.values())

    arms_cfg = [
        ("fp32_nospec", dict(codec="fp32", spec=False, prefix=False)),
        ("fp32", dict(codec="fp32", spec=True, prefix=True)),
        ("int8", dict(codec="int8", spec=True, prefix=False)),
        ("int8_prefix", dict(codec="int8", spec=True, prefix=True)),
    ]
    arms = {}
    for name, cfg in arms_cfg:
        pf = PrefillEngine(m, prefix_cache=cfg["prefix"], device=device)
        dec = DecodeEngine(m, 8, eos_id=2, replica_id="sp0",
                           speculative=cfg["spec"], device=device)
        rep = tp.WireReplica(tp.LoopbackLink(tp.ReceiverHub(dec)), "sp0",
                             local=dec, chunk_blocks=4, codec=cfg["codec"])
        t_submit, t_first = {}, {}

        def check_first():
            for rid in dec.out:
                if rid in t_submit and rid not in t_first:
                    t_first[rid] = time.perf_counter()

        # warm-up with another prefix, over the measured round structure
        warm_prefix = _tokens(rng, 128, 64)
        warm = [(f"warm{name}{i}",
                 np.concatenate([warm_prefix,
                                 _tokens(rng, 128, sufs[i % len(sufs)])]),
                 4 + (i % 3)) for i in range(7)]
        _fanout_drive(pf, dec, rep, warm, t_submit, check_first, False,
                      "shared-prefix arm")
        b0 = tp.TRANSPORT_BYTES.value()
        s0 = kvpool.SPEC_ADOPTIONS.value()
        h0, k0 = pf.prefix_hits, pf.prefix_tokens_skipped
        t0_all = time.perf_counter()
        _fanout_drive(pf, dec, rep, reqs, t_submit, check_first, True,
                      "shared-prefix arm")
        dec._flush_first_tokens()
        makespan = time.perf_counter() - t0_all
        got = {rid: toks for rid, toks in dec.out.items()
               if rid in t_submit}
        matched = sum(
            sum(a == b for a, b in zip(got.get(rid, []), toks))
            for rid, toks in want.items()
        )
        ftl = [1e3 * (t_first[rid] - t_submit[rid]) for rid in t_first]
        arms[name] = {
            **cfg,
            "requests": len(reqs),
            "token_exact": got == want,
            "token_match_fraction": round(matched / max(1, total_toks), 4),
            "quant_error_bound": round(wirecodec.error_bound(
                dec.wire_quant_max_scale, dec.wire_quant_codec), 6),
            "bytes_on_wire": int(tp.TRANSPORT_BYTES.value() - b0),
            "first_token_ms_mean": round(sum(ftl) / max(1, len(ftl)), 3),
            "first_token_ms_p50": round(pct(ftl, 0.50), 3),
            "first_token_ms_p99": round(pct(ftl, 0.99), 3),
            "tokens_per_s": round(total_toks / max(1e-9, makespan), 1),
            "speculative_adoptions": int(
                kvpool.SPEC_ADOPTIONS.value() - s0),
            "prefix_hits": pf.prefix_hits - h0,
            "prefix_tokens_skipped": pf.prefix_tokens_skipped - k0,
            "pools_leak_free": (
                pf.pool.stats()["leased"] == pf.pool.stats()["prefix_blocks"]
                and dec.pool.stats()["leased"] == 0
            ),
        }
    return {
        "config": {"model": kw, "block_size": bs,
                   "prefix_tokens": 64, "sessions": n_sessions},
        "arms": arms,
    }


def run_trace_overhead(smoke: bool, device="cuda") -> dict:
    """Paired tracing-off / tracing-on arms over one shared-prefix fanout
    drive (int8 wire + speculation + prefix cache).  The off arm must
    record no span; in the on arm every completed request's five ledger
    stages must sum to the bench-measured TTFT within 5 %."""
    import collections as _collections

    import numpy as np

    from vtpu_torch.serving import transport as tp
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
    from vtpu_torch.serving.reqtrace import LEDGER, STAGES
    from vtpu_torch.utils import trace

    kw = dict(vocab=128, d_model=192, depth=2, num_heads=4, max_seq=128)
    bs = 16
    m = _model(kw, bs, 257, device)
    rng = np.random.default_rng(29)
    prefix = _tokens(rng, 128, 64)
    n_sessions = 6 if smoke else 20
    sufs = [5, 9, 13, 7, 11, 15]
    telescope = STAGES[:5]

    def mk_reqs(tag):
        return [(f"{tag}{i}",
                 np.concatenate([prefix,
                                 _tokens(rng, 128, sufs[i % len(sufs)])]),
                 4 + (i % 3)) for i in range(n_sessions)]

    arms = {}
    attribution = None
    was_on = trace.tracing()
    try:
        for name, on in (("tracing_off", False), ("tracing_on", True)):
            trace.tracing(on)
            trace.clear()
            LEDGER.clear()
            pf = PrefillEngine(m, prefix_cache=True, device=device)
            dec = DecodeEngine(m, 8, eos_id=2, replica_id="tr0",
                               speculative=True, device=device)
            rep = tp.WireReplica(tp.LoopbackLink(tp.ReceiverHub(dec)),
                                 "tr0", local=dec, chunk_blocks=4,
                                 codec="int8")
            t_submit, t_first = {}, {}

            def check_first():
                for rid in dec.out:
                    if rid in t_submit and rid not in t_first:
                        t_first[rid] = time.perf_counter()

            warm_prefix = _tokens(rng, 128, 64)
            warm = [(f"warm{name}{i}",
                     np.concatenate([warm_prefix, _tokens(
                         rng, 128, sufs[i % len(sufs)])]),
                     4 + (i % 3)) for i in range(7)]
            _fanout_drive(pf, dec, rep, warm, t_submit, check_first, False,
                          "trace arm")
            reqs = mk_reqs(f"tr_{name}_")
            t0 = time.perf_counter()
            _fanout_drive(pf, dec, rep, reqs, t_submit, check_first, True,
                          "trace arm")
            dec._flush_first_tokens()
            makespan = time.perf_counter() - t0
            total = sum(len(dec.out[rid]) for rid in t_submit
                        if rid in dec.out)
            arms[name] = {
                "requests": len(reqs),
                "tokens": total,
                "tokens_per_s": round(total / max(1e-9, makespan), 1),
                "makespan_s": round(makespan, 4),
            }
            if on:
                errs, docs = [], 0
                for rid, ts in t_submit.items():
                    doc = LEDGER.get(rid)
                    if (doc is None or doc["ttft_s"] is None
                            or rid not in t_first):
                        continue
                    docs += 1
                    measured = t_first[rid] - ts
                    ssum = sum(doc["stages"][s] for s in telescope)
                    errs.append(abs(ssum - measured) / max(1e-9, measured))
                counts = _collections.Counter(
                    s["name"] for s in trace.recent_spans(n=2048))
                attribution = {
                    "requests_attributed": docs,
                    "stage_sum_max_rel_err": (round(max(errs), 4)
                                              if errs else None),
                    "stage_sum_mean_rel_err": (round(sum(errs) / len(errs), 4)
                                               if errs else None),
                    "span_counts": dict(counts),
                    "ledger": LEDGER.stats(),
                }
            else:
                arms[name]["spans_recorded"] = len(
                    trace.recent_spans(n=2048))
            trace.tracing(False)
            trace.clear()
            LEDGER.clear()
    finally:
        trace.tracing(was_on)
    off, on_ = arms["tracing_off"], arms["tracing_on"]
    return {
        "config": {"model": kw, "block_size": bs, "prefix_tokens": 64,
                   "sessions": n_sessions},
        "arms": arms,
        "attribution": attribution,
        # > 1.0: tracing on ran slower (reported, not gated)
        "overhead_x": round(on_["makespan_s"] / max(1e-9, off["makespan_s"]),
                            3),
    }


# ---------------------------------------------------------------------------
# K/V memory-hierarchy phases (--kv): per-codec wire curve, host spill
# tier, prefix persistence across a restart, torn-journal fuzz
# ---------------------------------------------------------------------------

KV_CODECS = ("fp32", "int8", "fp8", "int4")


def _mean(vals):
    return sum(vals) / len(vals) if vals else 0.0


def _kv_stack(m, device, codec="fp32", **engine_kw):
    """One serving stack: prefill + speculative decode behind the
    loopback wire (the first token publishes at OPEN, so first-token
    latency is the prefill side's story)."""
    from vtpu_torch.serving import transport as tp
    from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine

    pf = PrefillEngine(m, prefix_cache=True, device=device, **engine_kw)
    dec = DecodeEngine(m, 4, eos_id=2, replica_id="kv0", speculative=True,
                       device=device)
    rep = tp.WireReplica(tp.LoopbackLink(tp.ReceiverHub(dec)), "kv0",
                         local=dec, chunk_blocks=2, codec=codec)
    return pf, dec, rep


def _kv_drive_one(pf, dec, rep, rid, prompt, num_new):
    """Serve ONE request to completion; returns submit -> first-token ms
    (the token host-visible at the decode replica)."""
    from vtpu_torch.serving import transport as tp

    t0 = time.perf_counter()
    t_first = [None]

    def check_first():
        if t_first[0] is None and rid in dec.out:
            t_first[0] = time.perf_counter()

    pf.submit(rid, prompt, num_new=num_new)
    while (pf.queue or rep.idle_senders() or dec.queue
           or any(dec.active) or dec._inflight):
        for res in pf.step():
            rep.submit_handle(res.rid, res.handle, res.first_token,
                              res.num_new, source=pf,
                              submitted=res.submitted, admit=False)
            check_first()
        stalls = 0
        while rep.idle_senders():
            before = tp.TRANSPORT_CHUNKS.value()
            rep.pump_streams()
            check_first()
            if (rep.idle_senders()
                    and tp.TRANSPORT_CHUNKS.value() == before):
                dec.step()
                stalls += 1
                if stalls > 10000:
                    raise RuntimeError("kv arm wedged")
        dec.step()
        check_first()
    return 1e3 * ((t_first[0] or time.perf_counter()) - t0)


def run_kv_spill(smoke: bool, device="cuda") -> dict:
    """A working set of registered prefixes larger than the device pool:
    lease pressure demotes cold prefixes to quantized host buffers, and a
    later hit onloads them back.  First-token latency of spilled hits
    against device-resident hits on identical request shapes."""
    import numpy as np

    from vtpu_torch.serving.paged import PagedBatcher

    kw = dict(vocab=128, d_model=128, depth=2, num_heads=4, max_seq=192)
    bs = 16
    pool_blocks = 18           # 17 leasable: the device fits ~3 prefixes
    n_pfx = 5 if smoke else 8  # 4-block prefixes: 20/32-block working set
    m = _model(kw, bs, pool_blocks, device)
    m_big = m.clone(kv_pool_blocks=257)
    rng = np.random.default_rng(31)
    prefixes = [_tokens(rng, 128, 64) for _ in range(n_pfx)]
    suf_len, num_new = 11, 4

    def mk(tag, i):
        return (f"{tag}{i}",
                np.concatenate([prefixes[i], _tokens(rng, 128, suf_len)]),
                num_new)

    pop_reqs = [mk("p", i) for i in range(n_pfx)]
    meas_reqs = {i: mk("m", i) for i in range(n_pfx)}

    mono = PagedBatcher(m_big, 4, eos_id=2, device=device)
    for rid, p, n in meas_reqs.values():
        mono.submit(rid, p, num_new=n)
    want = mono.run()

    pf, dec, rep = _kv_stack(m, device, host_spill=True)
    # warm every program on the path, demote and onload included
    warm_pfx = [_tokens(rng, 128, 64) for _ in range(2)]
    for i, wp in enumerate(warm_pfx):
        _kv_drive_one(pf, dec, rep, f"kwarm{i}",
                      np.concatenate([wp, _tokens(rng, 128, suf_len)]),
                      num_new)
    pf._demote_for(pf.pool.leasable())
    _kv_drive_one(pf, dec, rep, "kwarmhit",
                  np.concatenate([warm_pfx[0], _tokens(rng, 128, suf_len)]),
                  num_new)
    pf.pool.evict_prefixes_for(pf.pool.leasable())

    d0, o0 = pf.spill_demotions, pf.spill_onloads
    for r in pop_reqs:
        _kv_drive_one(pf, dec, rep, *r)
    # newest first: device-resident prefixes measure before the spilled
    # tail (touching a spilled one demotes an already measured victim)
    samples = {"device": [], "spilled": [], "miss": []}
    for i in range(n_pfx - 1, -1, -1):
        h0, on0 = pf.prefix_hits, pf.spill_onloads
        ms = _kv_drive_one(pf, dec, rep, *meas_reqs[i])
        if pf.spill_onloads > on0:
            samples["spilled"].append(ms)
        elif pf.prefix_hits > h0:
            samples["device"].append(ms)
        else:
            samples["miss"].append(ms)

    dec._flush_first_tokens()
    want = {rid: list(t) for rid, t in want.items()}
    got = {rid: list(dec.out.get(rid, [])) for rid in want}
    total = sum(len(t) for t in want.values())
    matched = sum(sum(a == b for a, b in zip(got[rid], toks))
                  for rid, toks in want.items())
    st = pf.pool.stats()
    ratio = (round(_mean(samples["spilled"])
                   / max(1e-9, _mean(samples["device"])), 2)
             if samples["spilled"] and samples["device"] else None)
    return {
        "config": {"model": kw, "block_size": bs,
                   "pool_blocks": pool_blocks, "prefixes": n_pfx,
                   "prefix_blocks_each": 4,
                   "spill_codec": pf._spill_codec},
        "working_set_blocks": n_pfx * 4,
        "device_leasable_blocks": pf.pool.leasable(),
        "overcommit": n_pfx * 4 > pf.pool.leasable(),
        "demotions": pf.spill_demotions - d0,
        "onloads": pf.spill_onloads - o0,
        "spilled_runs": st["spilled_runs"],
        "spilled_blocks": st["spilled_blocks"],
        "token_exact": got == want,
        "token_match_fraction": round(matched / max(1, total), 4),
        "ftl_ms_device_hit": [round(v, 3) for v in samples["device"]],
        "ftl_ms_spilled_hit": [round(v, 3) for v in samples["spilled"]],
        "ftl_ms_miss": [round(v, 3) for v in samples["miss"]],
        "spilled_vs_device_ftl_x": ratio,
        "pools_leak_free": (st["leased"] == st["prefix_blocks"]
                            and dec.pool.stats()["leased"] == 0),
    }


def run_kv_restart(smoke: bool, device="cuda") -> dict:
    """Generation 1 registers a 12-block system prefix, demotes it into
    the journal and dies; generation 2 rehydrates the journal at start
    and serves a fanout sharing that prefix, its first hit an onload.
    The cold arm is the same fanout on a fresh engine without
    persistence.  Headline: the first hit's first-token latency, cold
    recompute over rehydrated onload."""
    import shutil
    import tempfile

    import numpy as np

    from vtpu_torch.serving.paged import PagedBatcher

    kw = dict(vocab=128, d_model=256, depth=3, num_heads=4, max_seq=256)
    bs = 16
    m = _model(kw, bs, 65, device)
    rng = np.random.default_rng(47)
    prefix = _tokens(rng, 128, 192)       # 12 blocks
    warm_prefix = _tokens(rng, 128, 192)  # same shape
    suf_len, num_new = 11, 4
    fanout = 4 if smoke else 8

    def fan(tag, pfx, k=None):
        return [(f"{tag}{i}",
                 np.concatenate([pfx, _tokens(rng, 128, suf_len)]), num_new)
                for i in range(k if k is not None else fanout)]

    meas_reqs = fan("r", prefix)
    cold_reqs = fan("c", prefix)
    mono = PagedBatcher(m, 4, eos_id=2, device=device)
    for rid, p, n in meas_reqs + cold_reqs:
        mono.submit(rid, p, num_new=n)
    want = {rid: list(t) for rid, t in mono.run().items()}

    d = tempfile.mkdtemp(prefix="vtpu-kv-restart-")
    try:
        pf1, dec1, rep1 = _kv_stack(m, device, host_spill=True,
                                    persist_dir=d)
        _kv_drive_one(pf1, dec1, rep1, "seed",
                      np.concatenate([prefix, _tokens(rng, 128, suf_len)]),
                      num_new)
        pf1._demote_for(pf1.pool.leasable())
        journaled_blocks = pf1._persist.blocks_journaled
        pf1._persist.close()
        leak1 = (pf1.pool.stats()["leased"]
                 == pf1.pool.stats()["prefix_blocks"]
                 and dec1.pool.stats()["leased"] == 0)

        pf2, dec2, rep2 = _kv_stack(m, device, host_spill=True,
                                    persist_dir=d)
        st0 = pf2.pool.stats()
        rehydrated_runs = st0["spilled_runs"]
        rehydrated_blocks = st0["spilled_blocks"]
        # warm generation 2 on another prefix over the measured path
        for rid, p, n in fan("w", warm_prefix, k=2):
            _kv_drive_one(pf2, dec2, rep2, rid, p, n)
        pf2._demote_for(pf2.pool.leasable())
        _kv_drive_one(pf2, dec2, rep2, "whot",
                      np.concatenate([warm_prefix,
                                      _tokens(rng, 128, suf_len)]), num_new)
        o0 = pf2.spill_onloads
        ftl_rehydrated = [_kv_drive_one(pf2, dec2, rep2, rid, p, n)
                          for rid, p, n in meas_reqs]
        onloaded = pf2.spill_onloads - o0
        dec2._flush_first_tokens()

        pf3, dec3, rep3 = _kv_stack(m, device)
        for rid, p, n in fan("v", warm_prefix, k=2):
            _kv_drive_one(pf3, dec3, rep3, rid, p, n)
        ftl_cold = [_kv_drive_one(pf3, dec3, rep3, rid, p, n)
                    for rid, p, n in cold_reqs]
        dec3._flush_first_tokens()

        got2 = {rid: list(dec2.out.get(rid, []))
                for rid, _p, _n in meas_reqs}
        got3 = {rid: list(dec3.out.get(rid, []))
                for rid, _p, _n in cold_reqs}
        w2 = {rid: want[rid] for rid in got2}
        w3 = {rid: want[rid] for rid in got3}
        total2 = sum(len(t) for t in w2.values())
        matched2 = sum(sum(a == b for a, b in zip(got2[rid], toks))
                       for rid, toks in w2.items())
        leak = all(
            p_.pool.stats()["leased"] == p_.pool.stats()["prefix_blocks"]
            and d_.pool.stats()["leased"] == 0
            for p_, d_ in ((pf2, dec2), (pf3, dec3))
        ) and leak1
        return {
            "config": {"model": kw, "block_size": bs,
                       "prefix_blocks": 12, "fanout": fanout,
                       "spill_codec": pf2._spill_codec},
            "journaled_blocks": journaled_blocks,
            "rehydrated_runs": rehydrated_runs,
            "rehydrated_blocks": rehydrated_blocks,
            "rehydrated_onloads": onloaded,
            "ftl_ms_rehydrated": [round(v, 3) for v in ftl_rehydrated],
            "ftl_ms_cold": [round(v, 3) for v in ftl_cold],
            "first_hit_ftl_ms_rehydrated": round(ftl_rehydrated[0], 3),
            "first_hit_ftl_ms_cold": round(ftl_cold[0], 3),
            "restart_ftl_speedup_x": round(
                ftl_cold[0] / max(1e-9, ftl_rehydrated[0]), 2),
            "fanout_ftl_ms_mean_rehydrated": round(_mean(ftl_rehydrated), 3),
            "fanout_ftl_ms_mean_cold": round(_mean(ftl_cold), 3),
            "token_match_fraction_rehydrated": round(
                matched2 / max(1, total2), 4),
            "token_exact_cold": got3 == w3,
            "pools_leak_free": leak,
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_kv_torn_journal(device="cuda") -> dict:
    """A crash mid-append leaves a truncated segment tail and a garbage
    index line; the restarted replica must rehydrate exactly the valid
    subset, onload a surviving run and stay leak-free."""
    import shutil
    import tempfile

    import numpy as np

    from vtpu_torch.serving import kvpersist

    kw = dict(vocab=128, d_model=64, depth=2, num_heads=4, max_seq=128)
    m = _model(kw, 16, 33, device)
    rng = np.random.default_rng(53)
    prefixes = [_tokens(rng, 128, 32) for _ in range(3)]  # 2 blocks each
    d = tempfile.mkdtemp(prefix="vtpu-kv-torn-")
    try:
        pf1, dec1, rep1 = _kv_stack(m, device, host_spill=True,
                                    persist_dir=d)
        for i, pfx in enumerate(prefixes):
            _kv_drive_one(pf1, dec1, rep1, f"t{i}",
                          np.concatenate([pfx, _tokens(rng, 128, 9)]), 3)
        pf1._demote_for(pf1.pool.leasable())
        pf1._persist.close()
        idx = os.path.join(d, kvpersist.INDEX_NAME)
        seg = os.path.join(d, kvpersist.SEGMENTS_NAME)
        with open(idx) as f:
            journaled_runs = sum(1 for _ in f)
        with open(seg, "r+b") as f:
            f.truncate(max(0, os.path.getsize(seg) - 100))
        with open(idx, "a") as f:
            f.write('{"torn index line\n')

        pf2, dec2, rep2 = _kv_stack(m, device, host_spill=True,
                                    persist_dir=d)
        rehydrated = pf2.pool.stats()["spilled_runs"]
        o0 = pf2.spill_onloads
        _kv_drive_one(pf2, dec2, rep2, "survivor",
                      np.concatenate([prefixes[0], _tokens(rng, 128, 9)]), 3)
        leak = (pf2.pool.stats()["leased"]
                == pf2.pool.stats()["prefix_blocks"]
                and dec2.pool.stats()["leased"] == 0)
        ok = (journaled_runs == 3
              and rehydrated == journaled_runs - 1
              and pf2.spill_onloads == o0 + 1
              and leak)
        return {
            "journaled_runs": journaled_runs,
            "rehydrated_runs": rehydrated,
            "expected_rehydrated": journaled_runs - 1,
            "survivor_onloads": pf2.spill_onloads - o0,
            "pools_leak_free": leak,
            "ok": ok,
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _verdict(failures: list) -> dict:
    """The run's pass/fail doc: every rule the bench broke, in order.
    The artifact is written either way; the exit code is 1 on any."""
    for msg in failures:
        print(msg, file=sys.stderr)
    return {"ok": not failures, "failures": list(failures)}


def _progress(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def kv_main(args, smoke: bool, device, card: dict) -> int:
    n = 6 if smoke else 16
    fails: list = []
    curve = {}
    for c in KV_CODECS:
        _progress(f"[bench-kv] codec curve: {c} wire...")
        curve[c] = run_wire(n, smoke, codec=c, device=device)
    fp32_bytes = curve["fp32"]["bytes_on_wire"]
    for c, r in curve.items():
        r["wire_byte_reduction_x"] = round(
            fp32_bytes / max(1, r["bytes_on_wire"]), 2)
    if not curve["fp32"]["token_exact"]:
        fails.append("bench-kv: fp32 wire diverged from monolithic")
    for c, r in curve.items():
        if not r["pools_leak_free"] or not r["death_fuzz"]["leak_free_all"]:
            fails.append(f"bench-kv: {c} wire leaked blocks")
        if not r["host_bytes_accounted"]:
            fails.append(f"bench-kv: {c} wire host bytes not accounted")
    for c, floor in (("int8", 3.5), ("fp8", 3.5), ("int4", 6.0)):
        if curve[c]["wire_byte_reduction_x"] < floor:
            fails.append(f"bench-kv: {c} wire-byte reduction only "
                         f"{curve[c]['wire_byte_reduction_x']:.2f}x "
                         f"(< {floor}x)")

    _progress("[bench-kv] host-DRAM spill tier...")
    spill = run_kv_spill(smoke, device=device)
    if not spill["overcommit"]:
        fails.append("bench-kv: spill working set fits the device pool -- "
                     "arm proves nothing")
    if spill["demotions"] < 1 or spill["onloads"] < 1:
        fails.append("bench-kv: spill arm never demoted/onloaded")
    if not spill["ftl_ms_spilled_hit"] or not spill["ftl_ms_device_hit"]:
        fails.append("bench-kv: spill arm missing a hit class "
                     f"(device={len(spill['ftl_ms_device_hit'])}, "
                     f"spilled={len(spill['ftl_ms_spilled_hit'])})")
    if not spill["pools_leak_free"]:
        fails.append("bench-kv: spill arm leaked blocks")
    if spill["token_match_fraction"] < 0.9:
        fails.append(f"bench-kv: spill arm token match "
                     f"{spill['token_match_fraction']} (< 0.9)")
    if not smoke and (spill["spilled_vs_device_ftl_x"] or 0.0) > 2.0:
        fails.append(f"bench-kv: spilled-hit FTL "
                     f"{spill['spilled_vs_device_ftl_x']:.2f}x "
                     f"device-resident (> 2x)")

    _progress("[bench-kv] prefix persistence across restart...")
    restart = run_kv_restart(smoke, device=device)
    if restart["rehydrated_runs"] < 1 or restart["rehydrated_onloads"] < 1:
        fails.append("bench-kv: restart arm never rehydrated/onloaded")
    if not restart["pools_leak_free"]:
        fails.append("bench-kv: restart arm leaked blocks")
    if not restart["token_exact_cold"]:
        fails.append("bench-kv: cold restart arm diverged from monolithic")
    if not smoke and restart["restart_ftl_speedup_x"] < 3.0:
        fails.append(f"bench-kv: rehydrated first-hit FTL only "
                     f"{restart['restart_ftl_speedup_x']:.2f}x better than "
                     f"cold recompute (< 3x)")

    _progress("[bench-kv] torn-journal fuzz...")
    torn = run_kv_torn_journal(device=device)
    if not torn["ok"]:
        fails.append(f"bench-kv: torn-journal fuzz failed: {torn}")

    headline = {
        "codec_curve": {
            c: {"bytes_on_wire": r["bytes_on_wire"],
                "wire_byte_reduction_x": r["wire_byte_reduction_x"],
                "token_match_fraction": r["token_match_fraction"],
                "quant_error_bound": r["quant_error_bound"]}
            for c, r in curve.items()
        },
        "int4_wire_byte_reduction_x": curve["int4"]["wire_byte_reduction_x"],
        "spilled_vs_device_ftl_x": spill["spilled_vs_device_ftl_x"],
        "restart_ftl_speedup_x": restart["restart_ftl_speedup_x"],
        "first_hit_ftl_ms_rehydrated": restart[
            "first_hit_ftl_ms_rehydrated"],
        "first_hit_ftl_ms_cold": restart["first_hit_ftl_ms_cold"],
        "torn_journal_ok": torn["ok"],
    }
    res = {
        "metric": "serving_kv_hierarchy",
        **card,
        "smoke": smoke,
        "codec_curve": curve,
        "spill": spill,
        "restart": restart,
        "torn_journal": torn,
        "headline": headline,
        "verdict": _verdict(fails),
        "measured": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    _write(args.out, res)
    print(json.dumps({"headline": headline, "verdict": res["verdict"]}))
    return 0 if res["verdict"]["ok"] else 1


# ---------------------------------------------------------------------------
# Phase 2a: unit calibration (the port's own programs, timed)
# ---------------------------------------------------------------------------

MODEL_KW = dict(vocab=128, d_model=64, depth=2, num_heads=4, max_seq=128)
BS = 16
MAX_BATCH = 8
HARVEST = 4
ROWS_FULL = (1, 2, 4, 8)
ROWS_SMOKE = (1, 8)
BLENS = (16, 64)


def device_timer(device, repeats: int):
    """``best(fn, reps)``: the least mean seconds of ``reps`` calls over
    ``repeats`` tries.  On a card the calls are bracketed by CUDA events
    (device time, after a warm call); on the CPU by the host clock."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        def best(fn, reps):
            b = float("inf")
            for _ in range(max(2, repeats)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
                b = min(b, start.elapsed_time(end) / 1e3 / reps)
            return b
        return best

    def best(fn, reps):
        b = float("inf")
        for _ in range(max(2, repeats)):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            b = min(b, (time.perf_counter() - t0) / reps)
        return b
    return best


def calibrate(rows_set, repeats: int, device="cuda") -> dict:
    """Time the programs the roles run, at the sim model's shapes: the
    decode window of HARVEST steps over every slot (on a card the
    replayed CUDA graph), one bucketed prefill forward per (rows, blen)
    and one cross-pool adopt per row bucket.  Garbage table rows send
    every write to the garbage block: the cost is set by the shapes."""
    import numpy as np

    from vtpu_torch.serving.disagg import (
        DecodeEngine,
        PrefillEngine,
        _PendingAdopt,
    )
    from vtpu_torch.serving.paged import pool_prefill

    nb_max = MODEL_KW["max_seq"] // BS
    pool_blocks = 1 + MAX_BATCH * nb_max
    m = _model(MODEL_KW, BS, pool_blocks, device)
    dec = DecodeEngine(m, MAX_BATCH, harvest_every=HARVEST, device=device)
    pf = PrefillEngine(m, device=device)
    best = device_timer(device, repeats)
    units: dict = {}

    def win():
        dec._step_k(HARVEST)

    win()  # the eager window (and, on a card, the capture)
    win()
    units["decode_window_s"] = best(win, 8)

    zero_row = np.zeros((nb_max,), np.int32)
    for rows in rows_set:
        for blen in BLENS:
            items = [(np.zeros((max(1, blen - 1),), np.int32), 0, zero_row)
                     for _ in range(rows)]

            def pfill(items=items, rows=rows, blen=blen):
                pool_prefill(m, pf._live_layers(), items, rows, blen)

            pfill()
            units[f"prefill_{rows}x{blen}_s"] = best(pfill, 4)

    # the cross-pool adopt (the handoff's device cost) per row bucket, a
    # handle of nb_max blocks a row; each call leases fresh blocks on
    # both sides, copies and binds, and hands them back
    for rows_n in rows_set:
        def adopt(rows_n=rows_n):
            entries = []
            for slot in range(rows_n):
                src = pf.pool.lease(nb_max)
                dst = dec.pool.lease(nb_max)
                entries.append((slot, _PendingAdopt(
                    f"cal{slot}", src, 1, 0, 1, "copy", pf, 0.0), dst))
            dec._copy_rows(entries)
            for _s, _pa, dst in entries:
                dec.pool.release(dst)

        adopt()
        units[f"adopt_{rows_n}_s"] = best(adopt, 8)
    return units


def prefill_unit(units: dict, rows: int, blen: int) -> float:
    """Measured cost of the nearest calibrated (rows, blen) program
    (rows round up to the next calibrated row bucket)."""
    cands = sorted({int(k.split("_")[1].split("x")[0])
                    for k in units if k.startswith("prefill_")})
    rows_b = next((r for r in cands if r >= rows), cands[-1])
    return units[f"prefill_{rows_b}x{blen}_s"]


def adopt_unit(units: dict, rows: int) -> float:
    cands = sorted(int(k.split("_")[1]) for k in units
                   if k.startswith("adopt_"))
    rows_b = next((r for r in cands if r >= rows), cands[-1])
    return units[f"adopt_{rows_b}_s"]


# ---------------------------------------------------------------------------
# Phase 2b: the virtual-device-clock arms (the JAX bench's simulation,
# unchanged: plain host arithmetic over the measured units)
# ---------------------------------------------------------------------------

def gen_workload(sim_s: float, units: dict, overload: float,
                 burst_period: float, burst_size: int, seed: int = 9):
    """Open-loop mixed traffic: a steady decode-heavy stream at
    ``overload`` x one engine's decode token capacity, plus periodic
    bursts of long prompts.  Returns (requests by arrival, burst
    windows)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = units["decode_window_s"]
    cap_tok = MAX_BATCH * HARVEST / w          # one engine, decode only
    news = [12, 16, 24, 32, 20]
    rate = overload * cap_tok / (sum(news) / len(news))  # requests/s
    reqs = []
    t, i = 0.0, 0
    while t < sim_s:
        reqs.append({"t": t, "rid": f"d{i}", "sess": f"s{i % 64}",
                     "blen": 16, "num_new": news[i % len(news)],
                     "kind": "steady"})
        t += float(rng.exponential(1.0 / rate))
        i += 1
    bursts = []
    t = burst_period / 2
    while t < sim_s:
        for _j in range(burst_size):
            reqs.append({"t": t, "rid": f"p{i}", "sess": f"b{i}",
                         "blen": 64, "num_new": 8, "kind": "burst"})
            i += 1
        bursts.append((t, t + burst_period / 2))
        t += burst_period
    reqs.sort(key=lambda r: r["t"])
    return reqs, bursts


class _Slot:
    __slots__ = ("rid", "remaining", "last_t", "kind")

    def __init__(self, rid, remaining, last_t, kind):
        self.rid = rid
        self.remaining = remaining
        self.last_t = last_t
        self.kind = kind


def _sim_decode_unit(stream, units, cap, adopt_mode: bool):
    """One decode device fed by ``stream``.  ``adopt_mode`` charges the
    adopt per admission group (a disaggregated replica); otherwise each
    group charges its bucketed prefill programs (the monolithic engine).
    Returns (tokens, last_token_t, gaps, shed)."""
    t = 0.0
    queue: list = []
    slots: list = []
    idx = 0
    tokens = 0
    shed = 0
    gaps = []  # (gap_amortized_s, mid_t, kind)
    last_token_t = 0.0
    w = units["decode_window_s"]
    n = len(stream)
    while idx < n or queue or slots:
        while idx < n and stream[idx]["t"] <= t:
            if len(queue) >= cap:
                shed += 1
            else:
                queue.append(stream[idx])
            idx += 1
        if not slots and not queue:
            if idx < n:
                t = stream[idx]["t"]
                continue
            break
        free = MAX_BATCH - len(slots)
        if queue and free:
            group = queue[:free]
            del queue[:len(group)]
            if adopt_mode:
                t += adopt_unit(units, _pow2(len(group)))
            else:
                by_blen = {}
                for r in group:
                    by_blen.setdefault(r["blen"], []).append(r)
                for blen, sub in by_blen.items():
                    t += prefill_unit(units, _pow2(len(sub)), blen)
            for r in group:
                tokens += 1
                last_token_t = t
                slots.append(_Slot(r["rid"], r["num_new"] - 1, t,
                                   r["kind"]))
        t += w
        done = []
        for s in slots:
            k = min(HARVEST, s.remaining)
            if k > 0:
                # ITL samples from full windows only (a final ragged
                # window is a completion artifact every arm shares)
                if k == HARVEST:
                    gaps.append(((t - s.last_t) / k, t, s.kind))
                tokens += k
                s.remaining -= k
                s.last_t = t
                last_token_t = t
            if s.remaining <= 0:
                done.append(s)
        for s in done:
            slots.remove(s)
    return tokens, last_token_t, gaps, shed


def _sim_prefill_device(reqs, units):
    """A dedicated prefill device: bucketed group admission off the
    arrival queue; returns each request's handoff-ready time."""
    t = 0.0
    idx = 0
    ready = []
    n = len(reqs)
    queue: list = []
    while idx < n or queue:
        while idx < n and reqs[idx]["t"] <= t:
            queue.append(reqs[idx])
            idx += 1
        if not queue:
            if idx < n:
                t = reqs[idx]["t"]
                continue
            break
        group = queue[:MAX_BATCH]
        del queue[:len(group)]
        by_blen = {}
        for r in group:
            by_blen.setdefault(r["blen"], []).append(r)
        for blen, sub in by_blen.items():
            t += prefill_unit(units, _pow2(len(sub)), blen)
        for r in group:
            ready.append(dict(r, t=t))
    return ready


def _sim_prefill_dynamic(reqs, units, max_devices: int,
                         high: int = 8, low: int = 2, cooldown: int = 2):
    """A shared prefill tier scaling 1..max_devices on its backlog (the
    Router's prefill-scaling policy on the virtual clock)."""
    t = 0.0
    idx = 0
    ready = []
    queue: list = []
    n = len(reqs)
    active = 1
    transitions = 0
    cool = 0
    weighted_active = 0.0
    last_t = 0.0
    while idx < n or queue:
        while idx < n and reqs[idx]["t"] <= t:
            queue.append(reqs[idx])
            idx += 1
        if not queue:
            if idx < n:
                weighted_active += active * (reqs[idx]["t"] - t)
                t = reqs[idx]["t"]
                continue
            break
        backlog = len(queue)
        if cool > 0:
            cool -= 1
        elif backlog > high * active and active < max_devices:
            active += 1
            transitions += 1
            cool = cooldown
        elif backlog < low * active and active > 1:
            active -= 1
            transitions += 1
            cool = cooldown
        group = queue[:MAX_BATCH * active]
        del queue[:len(group)]
        per_dev = [group[i::active] for i in range(active)]
        elapsed = 0.0
        for sub in per_dev:
            if not sub:
                continue
            by_blen = {}
            for r in sub:
                by_blen.setdefault(r["blen"], []).append(r)
            cost = sum(prefill_unit(units, _pow2(len(s)), blen)
                       for blen, s in by_blen.items())
            elapsed = max(elapsed, cost)
        weighted_active += active * elapsed
        t += elapsed
        last_t = t
        for r in group:
            ready.append(dict(r, t=t))
    return ready, {
        "max_devices": max_devices,
        "transitions": transitions,
        "mean_active": round(weighted_active / max(1e-9, last_t), 2),
    }


def _hash_pick(sess: str, n: int) -> int:
    return int.from_bytes(hashlib.md5(sess.encode()).digest()[:4],
                          "big") % n


def sim_arm(reqs, bursts, units, n_replicas: int,
            dyn_prefill: int = 0) -> dict:
    """``n_replicas == 0``: the monolithic arm; else one prefill device a
    replica feeding ``n_replicas`` decode replicas behind session
    affinity, or with ``dyn_prefill > 0`` one shared prefill tier
    autoscaling 1..dyn_prefill devices."""
    cap = 3 * MAX_BATCH  # the Router's default backlog policy
    scale = None
    if n_replicas == 0:
        streams = [_sim_decode_unit(reqs, units, cap, adopt_mode=False)]
    elif dyn_prefill > 0:
        ready, scale = _sim_prefill_dynamic(reqs, units, dyn_prefill)
        per_rep = [[] for _ in range(n_replicas)]
        for r in ready:
            per_rep[_hash_pick(r["sess"], n_replicas)].append(r)
        streams = []
        for sub in per_rep:
            sub.sort(key=lambda r: r["t"])
            streams.append(_sim_decode_unit(sub, units, cap,
                                            adopt_mode=True))
    else:
        per_rep = [[] for _ in range(n_replicas)]
        for r in reqs:
            per_rep[_hash_pick(r["sess"], n_replicas)].append(r)
        streams = []
        for sub in per_rep:
            ready = _sim_prefill_device(sub, units)
            ready.sort(key=lambda r: r["t"])
            streams.append(_sim_decode_unit(ready, units, cap,
                                            adopt_mode=True))
    tokens = sum(s[0] for s in streams)
    last_t = max((s[1] for s in streams), default=0.0)
    gaps = [g for s in streams for g in s[2]]
    shed = sum(s[3] for s in streams)
    itl = [g for g, _, _ in gaps]
    burst_itl = [g for g, mid, kind in gaps
                 if kind == "steady"
                 and any(lo <= mid <= hi for lo, hi in bursts)]
    out = {
        "replicas": n_replicas,
        "requests": len(reqs),
        "shed": shed,
        "tokens": tokens,
        "makespan_s": round(last_t, 3),
        "tokens_per_s": round(tokens / max(1e-9, last_t), 1),
        "decode_itl_p50_ms": round(1e3 * pct(itl, 0.50), 3),
        "decode_itl_p99_ms": round(1e3 * pct(itl, 0.99), 3),
        "burst_itl_p99_ms": round(1e3 * pct(burst_itl, 0.99), 3),
        "burst_itl_samples": len(burst_itl),
    }
    if scale is not None:
        out["prefill_scale"] = scale
    return out


# ---------------------------------------------------------------------------

def card_doc(device) -> dict:
    """Where the run ran: ``platform`` (``gpu`` or ``cpu``), the device's
    name, and on a card its power limit as nvidia-smi reads it."""
    import torch

    from vtpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "device": "cpu", "power_limit": None}
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "not read"
    return {"platform": "gpu",
            "device": torch.cuda.get_device_name(dev),
            "power_limit": power}


def _write(path: str, res: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long sanity pass: tiny exactness stream, "
                         "reduced calibration, short sim")
    ap.add_argument("--sim-seconds", type=float, default=20.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--overload", type=float, default=2.5,
                    help="steady decode stream as a multiple of one "
                         "engine's decode token capacity")
    ap.add_argument("--burst-period", type=float, default=2.0)
    ap.add_argument("--burst-size", type=int, default=24)
    ap.add_argument("--kv", action="store_true",
                    help="run the K/V memory-hierarchy phases instead "
                         "(codec curve, host spill tier, persistence "
                         "across a restart, torn-journal fuzz)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default cuda; cpu for "
                         "the smoke)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: docs/artifacts/"
                         "serving_disagg_torch.json, or "
                         "serving_kv_torch.json with --kv)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(
            REPO, "docs", "artifacts",
            "serving_kv_torch.json" if args.kv
            else "serving_disagg_torch.json")
    card = card_doc(args.device)
    device = args.device
    smoke = bool(args.smoke)
    if args.kv:
        return kv_main(args, smoke, device, card)
    sim_s = 1.5 if smoke else args.sim_seconds
    fails: list = []
    _progress("[bench-disagg] phase 1: real-topology exactness...")
    exact = run_exactness(8 if smoke else 24, device=device)
    if not exact["token_exact"]:
        fails.append("bench-disagg: disaggregated transcripts diverged "
                     "from monolithic")
    if exact["handoff_host_bytes"] != 0:
        fails.append("bench-disagg: K/V bytes crossed the host on the "
                     "adopt path")

    _progress("[bench-disagg] phase 1.5: wire transport...")
    wire = run_wire(8 if smoke else 24, smoke, device=device)
    if not wire["token_exact"]:
        fails.append("bench-disagg: wire transcripts diverged from "
                     "monolithic")
    if not wire["pools_leak_free"] or not wire["death_fuzz"][
            "leak_free_all"]:
        fails.append("bench-disagg: wire transport leaked blocks")
    if not wire["host_bytes_accounted"]:
        fails.append("bench-disagg: wire host bytes not accounted in the "
                     "handoff family")
    if not smoke and wire["hidden_fraction"] < 0.8:
        fails.append(f"bench-disagg: wire stream time only "
                     f"{wire['hidden_fraction']:.0%} hidden under prefill "
                     f"compute (< 80%)")

    _progress("[bench-disagg] phase 1.6: wire transport, int8 codec...")
    wire_int8 = run_wire(8 if smoke else 24, smoke, codec="int8",
                         device=device)
    if not wire_int8["pools_leak_free"] or not wire_int8["death_fuzz"][
            "leak_free_all"]:
        fails.append("bench-disagg: int8 wire transport leaked blocks")
    if not wire_int8["host_bytes_accounted"]:
        fails.append("bench-disagg: int8 wire host bytes not accounted")
    reduction = wire["bytes_on_wire"] / max(1, wire_int8["bytes_on_wire"])
    if reduction < 3.5:
        fails.append(f"bench-disagg: int8 codec wire-byte reduction only "
                     f"{reduction:.2f}x (< 3.5x)")
    if not smoke and wire_int8["hidden_fraction"] < 0.8:
        fails.append(f"bench-disagg: int8 wire hidden fraction "
                     f"{wire_int8['hidden_fraction']:.0%} below 80%")

    _progress("[bench-disagg] phase 1.75: shared-prefix fanout...")
    shared_prefix = run_shared_prefix(smoke, device=device)
    spa = shared_prefix["arms"]
    if not (spa["fp32"]["token_exact"]
            and spa["fp32_nospec"]["token_exact"]):
        fails.append("bench-disagg: fp32 shared-prefix arm diverged from "
                     "monolithic")
    if (spa["fp32"]["prefix_hits"] < 1
            or spa["fp32"]["prefix_tokens_skipped"] <= 0):
        fails.append("bench-disagg: prefix cache never hit in the "
                     "shared-prefix arm")
    if not all(a["pools_leak_free"] for a in spa.values()):
        fails.append("bench-disagg: shared-prefix arm leaked blocks")

    _progress("[bench-disagg] phase 1.8: request-tracing overhead...")
    trace_res = run_trace_overhead(smoke, device=device)
    attr = trace_res["attribution"]
    if trace_res["arms"]["tracing_off"]["spans_recorded"] != 0:
        fails.append("bench-disagg: tracing-off arm recorded spans -- the "
                     "dark hot path is not a no-op")
    if not attr or not attr["requests_attributed"]:
        fails.append("bench-disagg: tracing-on arm produced no "
                     "attribution records")
    elif attr["stage_sum_max_rel_err"] > 0.05:
        fails.append(f"bench-disagg: stage segments sum to within "
                     f"{attr['stage_sum_max_rel_err']:.1%} of measured "
                     f"TTFT (> 5%)")

    _progress("[bench-disagg] phase 2: calibrating program costs...")
    units = calibrate(ROWS_SMOKE if smoke else ROWS_FULL,
                      2 if smoke else args.repeats, device=device)
    reqs, bursts = gen_workload(
        sim_s, units, args.overload, args.burst_period,
        max(4, args.burst_size // (4 if smoke else 1)))
    arms = {"monolithic": sim_arm(reqs, bursts, units, 0)}
    for n in (1, 2, 4):
        arms[f"disagg_{n}"] = sim_arm(reqs, bursts, units, n)
    arms["disagg_dyn"] = sim_arm(reqs, bursts, units, 4, dyn_prefill=4)

    mono, d4 = arms["monolithic"], arms["disagg_4"]
    headline = {
        "tokens_per_s_x_disagg_4": round(
            d4["tokens_per_s"] / max(1e-9, mono["tokens_per_s"]), 2),
        "mono_itl_p50_ms": mono["decode_itl_p50_ms"],
        "disagg_4_burst_itl_p99_ms": d4["burst_itl_p99_ms"],
        "burst_p99_within_mono_p50": (
            d4["burst_itl_p99_ms"] <= mono["decode_itl_p50_ms"]),
        "wire_hidden_fraction": wire["hidden_fraction"],
        "wire_bytes": wire["bytes_on_wire"],
        "int8_wire_byte_reduction_x": round(reduction, 2),
        "int8_hidden_fraction": wire_int8["hidden_fraction"],
        "int8_token_match_fraction": wire_int8["token_match_fraction"],
        "int8_quant_error_bound": wire_int8["quant_error_bound"],
        "prefix_hits": spa["int8_prefix"]["prefix_hits"],
        "prefix_tokens_skipped": spa["int8_prefix"]["prefix_tokens_skipped"],
        "ftl_ms_baseline_fp32_nospec": spa["fp32_nospec"][
            "first_token_ms_mean"],
        "ftl_ms_speculative_fp32": spa["fp32"]["first_token_ms_mean"],
        "dyn_mean_prefill_devices": arms["disagg_dyn"][
            "prefill_scale"]["mean_active"],
        "trace_off_tokens_per_s": trace_res["arms"]["tracing_off"][
            "tokens_per_s"],
        "trace_on_tokens_per_s": trace_res["arms"]["tracing_on"][
            "tokens_per_s"],
        "trace_overhead_x": trace_res["overhead_x"],
        "trace_stage_sum_max_rel_err": (attr or {}).get(
            "stage_sum_max_rel_err"),
    }
    res = {
        "metric": "serving_disaggregation",
        **card,
        "smoke": smoke,
        "timebase": (
            "virtual per-role device clocks charged with the measured "
            "device times of the port's own programs (CUDA events on a "
            "card, the host clock on the CPU); a disaggregated deployment "
            "gives each role its own card"),
        "config": {
            "model": MODEL_KW, "block_size": BS, "max_batch": MAX_BATCH,
            "harvest_every": HARVEST, "sim_seconds": sim_s,
            "overload": args.overload,
            "burst_period_s": args.burst_period,
            "burst_size": args.burst_size,
        },
        "exactness": exact,
        "wire": wire,
        "wire_int8": wire_int8,
        "shared_prefix": shared_prefix,
        "trace": trace_res,
        "units": {k: round(v, 9) for k, v in units.items()},
        "arms": arms,
        "headline": headline,
        "verdict": _verdict(fails),
        "measured": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    _write(args.out, res)
    print(json.dumps({"exactness": exact, "headline": headline,
                      "verdict": res["verdict"],
                      "arms": {k: {kk: v[kk] for kk in
                                   ("tokens_per_s", "decode_itl_p50_ms",
                                    "decode_itl_p99_ms",
                                    "burst_itl_p99_ms", "shed")}
                               for k, v in arms.items()}}))
    return 0 if res["verdict"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
