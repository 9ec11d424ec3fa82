"""The port's prefix registry and chain adoption against the JAX package.

- ``vtpu_torch.serving.prefix.chain_digests`` gives the JAX package's
  digests byte for byte (a chain crosses packages in the OPEN document);
- a seeded differential fuzz drives the same sequence of lease, register,
  match, evict, demote, store, rehydrate, detach and release through
  ``vtpu.serving.kvpool.BlockPool`` and the port's: every return value,
  every ``stats()`` key the JAX pool has, and the JAX pool's eviction,
  demotion and rehydration counters agree; the claim check refuses a
  second claim over a registry-pinned block;
- ``PrefillEngine(prefix_cache=True)`` prefills only the suffix and gives
  the tokens of prefix-off and of the JAX engines, in f32 at depth 2;
- the JAX package's unchanged Router hands its digest chain to torch
  engines, and the decode replica registers it;
- a JAX prefill streams suffix-only into a torch decode engine over the
  wire, and a torch prefill into a JAX decode engine, at depth 12 (the
  wire's leaf order, tests/test_torch_wire.py).
"""

import numpy as np
import pytest

from torch_parity import jax_params, port_of
from vtpu_torch.serving import kvpool as tkv
from vtpu_torch.serving import transport as ttp
from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
from vtpu_torch.serving.paged import PagedBatcher
from vtpu_torch.serving.prefix import chain_digests

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32)
BS = 8
POOL = 33


def _leak_free(pool) -> bool:
    st = pool.stats()
    return (st["leased"] == 0 and st["detached_handles"] == 0
            and st["free"] == st["pool_blocks"] - 1)


def _only_pins(pool) -> bool:
    """Every lease released: what is leased is the registry's."""
    st = pool.stats()
    return (st["leased"] == st["prefix_blocks"]
            and st["detached_handles"] == 0)


def _teardown_clean(pool) -> bool:
    """Leak-free once the registry lets go of its pins."""
    pool.evict_prefixes_for(pool.leasable())
    return _leak_free(pool)


# -- digests ----------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("block_size", [1, 3, 8, 16])
def test_chain_digests_equal_jax(seed, block_size):
    from vtpu.serving.prefix import chain_digests as jax_chain

    rng = np.random.default_rng(seed)
    for n in (0, 1, block_size - 1, block_size, 5 * block_size + 2):
        toks = rng.integers(-(1 << 40), 1 << 40, max(n, 0)).tolist()
        assert chain_digests(toks, block_size) == jax_chain(toks,
                                                            block_size)
        assert chain_digests(np.asarray(toks, np.int64), block_size) == \
            jax_chain(toks, block_size)
    assert chain_digests([1, 2], 0) == jax_chain([1, 2], 0) == []


# -- the registry, differential -------------------------------------------
JAX_STATS = ("pool_blocks", "leased", "free", "detached_handles",
             "prefix_runs", "prefix_blocks", "spilled_runs",
             "spilled_blocks", "spilled_bytes")


def _counters():
    from vtpu.serving import kvpool as jkv

    return {"prefix_evictions": jkv.PREFIX_EVICTIONS.value(),
            "spill_demotions": jkv.SPILL_DEMOTIONS.value(),
            "spill_rehydrations": jkv.SPILL_REHYDRATIONS.value()}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- compared by class name
        return ("raised", type(e).__name__)


def _norm(v):
    """Return values in one form: lists, tuples of the two packages'
    dataclasses and handles compared as plain data."""
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if hasattr(v, "to_wire"):
        doc = v.to_wire()
        doc.pop("pool")
        return doc
    return v


@pytest.mark.parametrize("seed", range(6))
def test_registry_fuzz_agrees_with_jax_pool(seed):
    """One seeded sequence of pool operations through both pools: the
    same answers, the same stats and the same counts, step by step."""
    from vtpu.serving.kvpool import BlockPool as JaxPool

    rng = np.random.default_rng(seed)
    cap = int(rng.integers(3, 12))
    spill_cap = int(rng.integers(40, 400))
    jp = JaxPool(25, 4, pool_id="fuzz", prefix_cap=cap,
                 spill_max_bytes=spill_cap)
    tp = tkv.BlockPool(25, 4, pool_id="fuzz", prefix_cap=cap,
                       spill_max_bytes=spill_cap)
    # prompts in three families sharing leading blocks
    bases = [rng.integers(0, 50, 24) for _ in range(3)]
    chains = []
    for b in bases:
        for cut in (4, 12, 20):
            tail = rng.integers(0, 50, 4)
            chains.append(chain_digests(list(b[:cut]) + list(tail), 4))
    leases, handles = [], []
    j0 = _counters()
    for step in range(300):
        op = rng.integers(0, 11)
        chain = chains[int(rng.integers(0, len(chains)))]
        if op == 0:
            n = int(rng.integers(1, 6))
            a, b = jp.try_lease(n), tp.try_lease(n)
            assert a == b
            if a is not None:
                leases.append(a)
        elif op == 1 and leases:
            blocks = leases.pop(int(rng.integers(0, len(leases))))
            assert _outcome(lambda: jp.release(blocks)) == \
                _outcome(lambda: tp.release(blocks))
        elif op == 2 and leases:
            blocks = leases[int(rng.integers(0, len(leases)))]
            assert _outcome(lambda: jp.register_prefix(chain, blocks)) == \
                _outcome(lambda: tp.register_prefix(chain, blocks))
        elif op == 3:
            mb = int(rng.integers(0, 7))
            a, b = jp.match_and_ref(chain, mb), tp.match_and_ref(chain, mb)
            assert a == b
            if a[1]:
                leases.append(a[0])  # the match's references, to release
        elif op == 4:
            need = int(rng.integers(0, 30))
            assert jp.evict_prefixes_for(need) == tp.evict_prefixes_for(need)
        elif op == 5:
            a, b = jp.demotion_candidate(), tp.demotion_candidate()
            assert a == b
            if a is not None:
                payload = bytes(rng.integers(0, 256, 8 * len(a[1]),
                                             dtype=np.uint8))
                jp.store_spilled(a[0], payload, "int8")
                tp.store_spilled(a[0], payload, "int8")
        elif op == 6:
            payload = bytes(rng.integers(0, 256, int(rng.integers(1, 90)),
                                         dtype=np.uint8))
            k = int(rng.integers(0, len(chain) + 1))
            assert jp.rehydrate_spilled(chain[:k], payload, "int4") == \
                tp.rehydrate_spilled(chain[:k], payload, "int4")
        elif op == 7:
            mb = int(rng.integers(0, 7))
            assert _norm(jp.match_spilled(chain, mb)) == \
                _norm(tp.match_spilled(chain, mb))
            for inc in (True, False):
                assert jp.prefix_match_depth(chain, include_spilled=inc) \
                    == tp.prefix_match_depth(chain, include_spilled=inc)
        elif op == 8 and leases:
            blocks = leases[int(rng.integers(0, len(leases)))]
            assert jp.digests_for_run(blocks) == tp.digests_for_run(blocks)
            a = _outcome(lambda: jp.detach(blocks, 4 * len(blocks)))
            b = _outcome(lambda: tp.detach(blocks, 4 * len(blocks)))
            assert _norm(a) == _norm(b)
            if a[0] == "ok":
                leases.remove(blocks)
                handles.append((a[1], b[1]))
        elif op == 9 and handles:
            jh, th = handles.pop(int(rng.integers(0, len(handles))))
            if rng.integers(0, 2):
                assert jp.adopt(jh) == tp.adopt(th)
                leases.append(list(jh.blocks))
            else:
                jp.release_handle(jh)
                tp.release_handle(th)
        else:
            assert sorted(jp.known_chains()) == sorted(tp.known_chains())
        js, ts = jp.stats(), tp.stats()
        assert {k: js[k] for k in JAX_STATS} == \
            {k: ts[k] for k in JAX_STATS}, f"step {step}"
        j = _counters()
        assert {k: j[k] - j0[k] for k in j} == \
            {k: ts[k] for k in j}, f"step {step}"
    for blocks in leases:
        jp.release(blocks)
        tp.release(blocks)
    for jh, th in handles:
        jp.release_handle(jh)
        tp.release_handle(th)
    assert jp.evict_prefixes_for(24) and tp.evict_prefixes_for(24)
    assert _leak_free(tp) and jp.stats()["leased"] == 0


def test_claim_check_refuses_a_claim_over_a_pinned_block():
    """A registered lease holds two references a block (its own and the
    registry's pin): the pin is not claimable, so one lease still mints
    only one claim ticket, while a prefix shared by a second lease
    detaches once more."""
    pool = tkv.BlockPool(9, 4)
    blocks = pool.lease(2)
    pool.register_prefix(["a", "b"], blocks)
    assert pool.stats()["prefix_blocks"] == 2
    h = pool.detach(blocks, seq_len=8)
    with pytest.raises(tkv.KVHandoffError):
        pool.detach(blocks, seq_len=8)
    shared, k = pool.match_and_ref(["a", "b", "c"], 2)
    assert (shared, k) == (blocks, 2)
    h2 = pool.detach(shared, seq_len=8)  # the sharer's own reference
    pool.release_handle(h)
    pool.release_handle(h2)
    assert _only_pins(pool)
    assert _teardown_clean(pool)


def test_register_needs_live_references_and_cap_evicts():
    pool = tkv.BlockPool(9, 4, prefix_cap=2)
    with pytest.raises(tkv.DoubleReleaseError):
        pool.register_prefix(["a"], [3])
    blocks = pool.lease(3)
    pool.register_prefix(["a", "b", "c"], blocks)  # 3 runs, cap 2
    st = pool.stats()
    assert st["prefix_runs"] == 2 and st["prefix_evictions"] == 1
    assert pool.prefix_match_depth(["a"], include_spilled=False) == 0
    assert pool.prefix_match_depth(["a", "b"], include_spilled=False) == 2
    pool.release(blocks)
    assert _teardown_clean(pool)
    off = tkv.BlockPool(9, 4, prefix_cap=0)
    off.register_prefix(["a"], off.lease(1))
    assert off.stats()["prefix_runs"] == 0


# -- engines at depth 2 ----------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    from vtpu.models.transformer import TransformerLM as JaxLM

    jm = JaxLM(**KW, kv_cache_layout="paged", kv_block_size=BS,
               kv_pool_blocks=POOL)
    params = jax_params(jm)
    return {"jm": jm, "params": params, "tm": port_of(jm, params)}


def prefix_requests(seed=41, n=6):
    """tests/test_disagg.py's prefix-cache prompts: one 2-block prefix and
    suffixes of 3 to 5 tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, 16).astype(np.int32)
    return [(f"s{i}", np.concatenate(
        [prefix, rng.integers(0, 64, 3 + (i % 3)).astype(np.int32)]), 3)
        for i in range(n)]


def run_monolithic(tm, reqs):
    eng = PagedBatcher(tm, max_batch=4, eos_id=2, device="cpu")
    for rid, p, n in reqs:
        eng.submit(rid, p, num_new=n)
    return eng.run()


def _drive(pf, dec, batch, src, chain=False):
    for rid, p, n in batch:
        pf.submit(rid, p, n)
    while pf.queue or dec.queue or any(dec.active) or dec._inflight:
        for res in pf.step():
            dec.submit_handle(res.rid, res.handle, res.first_token,
                              res.num_new, source=src,
                              chain=list(res.chain) if chain else None)
        dec.step()
    dec._flush_first_tokens()


def test_prefix_cache_skips_recompute_token_exact(ref):
    """Wave 1 registers the prefix; wave 2 matches it and prefills only
    its suffix.  Tokens equal prefix-off, the monolithic engine and the
    JAX engines; only the registry's pins stay leased."""
    from vtpu.serving.disagg import DecodeEngine as JDec
    from vtpu.serving.disagg import PrefillEngine as JPf

    reqs = prefix_requests()
    want = run_monolithic(ref["tm"], reqs)
    got = {}
    for on in (False, True):
        pf = PrefillEngine(ref["tm"], prefix_cache=on, device="cpu")
        dec = DecodeEngine(ref["tm"], 4, eos_id=2, device="cpu")
        _drive(pf, dec, reqs[:2], pf)
        _drive(pf, dec, reqs[2:], pf)
        got[on] = dict(dec.out)
        assert _leak_free(dec.pool)
        if on:
            st = pf.stats()
            assert st["prefix_hits"] == 4 and st["prefix_misses"] == 2
            assert pf.prefix_tokens_skipped == 4 * 16
            assert st["prefix_runs"] == 2
            assert st["leased"] == st["prefix_blocks"] == 2
            assert _teardown_clean(pf.pool)
        else:
            assert pf.stats()["prefix_hits"] == 0 and _leak_free(pf.pool)
    assert got[True] == got[False] == want
    jpf = JPf(ref["jm"], ref["params"], prefix_cache=True)
    jdec = JDec(ref["jm"], ref["params"], max_batch=4, eos_id=2)
    _drive(jpf, jdec, reqs[:2], jpf)
    _drive(jpf, jdec, reqs[2:], jpf)
    assert dict(jdec.out) == want
    assert jpf.prefix_hits == 4


def test_suffix_prefill_writes_the_same_blocks(ref):
    """A hit's suffix prefill (rewound to the matched position) writes the
    prompt's K/V as a full prefill does, in f32."""
    import torch

    reqs = prefix_requests(seed=5, n=2)
    kv = {}
    for on in (False, True):
        pf = PrefillEngine(ref["tm"], prefix_cache=on, device="cpu")
        res = []
        for rid, p, n in reqs:
            pf.submit(rid, p, n)
            res.extend(pf.step())
        if on:  # the hit shares the first request's prefix blocks
            assert res[1].handle.blocks[:2] == res[0].handle.blocks[:2]
        # each leaf's rows token-major, cut at the prompt (past it, a
        # padded bucket's writes differ and decode overwrites them)
        kv[on] = [torch.cat([t[list(r.handle.blocks)].transpose(1, 2)
                             .reshape(-1, *t.shape[1:2], t.shape[3])[:p.size]
                             for t in pf.pool_leaves()])
                  for r, (_rid, p, _n) in zip(res, reqs)]
    for a, b in zip(kv[False], kv[True]):
        assert torch.allclose(a, b, atol=1e-5, rtol=0)


def test_prefix_registry_yields_under_lease_pressure(ref):
    """A tight pool whose blocks the registry pins: admission evicts
    least recently used runs instead of wedging."""
    tight = port_of(ref["jm"], ref["params"], kv_pool_blocks=9)
    pf = PrefillEngine(tight, prefix_cache=True, device="cpu")
    rng = np.random.default_rng(43)
    for i in range(4):
        pf.submit(f"t{i}", rng.integers(0, 64, 17).astype(np.int32), 3)
        res = pf.step()
        assert len(res) == 1, "admission must not wedge on pinned blocks"
        pf.pool.release_handle(res[0].handle)
    st = pf.stats()
    assert st["prefix_evictions"] > 0
    assert _only_pins(pf.pool) and _teardown_clean(pf.pool)


def test_foreign_block_size_chain_is_recomputed_or_dropped(ref):
    """A chain of another granularity is recomputed at the prefill and
    never registered at a decode engine adopting from a prefill of
    another block size."""
    reqs = prefix_requests(n=1)
    pf = PrefillEngine(ref["tm"], prefix_cache=True, device="cpu")
    rid, p, n = reqs[0]
    pf.submit(rid, p, n, chain=chain_digests(p.tolist(), 4))  # 4 != 8
    (res,) = pf.step()
    assert list(res.chain) == chain_digests(p.tolist(), BS)
    dec = DecodeEngine(ref["tm"], 2, eos_id=2, device="cpu")

    class Other:  # a source of another block size, same pool
        pool, block_size = pf.pool, 4

        @staticmethod
        def pool_leaves():
            return pf.pool_leaves()

    dec.submit_handle(rid, res.handle, res.first_token, n, source=Other,
                      chain=list(res.chain))
    assert dec.pool.stats()["prefix_runs"] == 0
    dec.run()
    assert _leak_free(dec.pool) and _teardown_clean(pf.pool)


def test_router_hands_its_chain_to_torch_engines(ref):
    """The JAX package's unchanged Router over a torch prefill with the
    prefix cache and two torch decode replicas: the router digests each
    prompt, the prefill takes that chain, the replica (accepts_chain)
    registers it; tokens equal the monolithic engine's."""
    from vtpu.serving.router import Router

    reqs = prefix_requests(seed=17, n=6)
    want = run_monolithic(ref["tm"], reqs)
    pf = PrefillEngine(ref["tm"], prefix_cache=True, device="cpu")
    reps = {f"d{i}": DecodeEngine(ref["tm"], 4, eos_id=2,
                                  replica_id=f"d{i}", device="cpu")
            for i in range(2)}
    assert all(r.accepts_chain for r in reps.values())
    router = Router(pf, reps)
    router.submit("sess0", *reqs[0][:2], num_new=reqs[0][2])
    router.pump()
    for i, (rid, p, n) in enumerate(reqs[1:], 1):
        router.submit(f"sess{i % 2}", rid, p, num_new=n)
    assert router.drain() == want
    assert pf.prefix_hits >= 4
    assert sum(r.pool.stats()["prefix_runs"] for r in reps.values()) >= 2
    for eng in reps.values():
        assert _only_pins(eng.pool) and _teardown_clean(eng.pool)
    assert _only_pins(pf.pool) and _teardown_clean(pf.pool)


# -- suffix-only streams across packages, depth 12 --------------------------
def _recording_skips(dec):
    """Record each wire OPEN's negotiated skip on ``dec``."""
    skips, inner = [], dec.wire_open

    def wire_open(*a, **kw):
        ctx = inner(*a, **kw)
        skips.append(ctx["skip"] if ctx else None)
        return ctx

    dec.wire_open = wire_open
    return skips


def _stream_waves(pf, dec, rep, reqs):
    """Wave 1 (one request) to FIN, then the rest with their chains; the
    decode engine drained after each wave."""
    for batch in (reqs[:1], reqs[1:]):
        for rid, p, n in batch:
            pf.submit(rid, p, n)
        for r in pf.run():
            rep.submit_handle(r.rid, r.handle, r.first_token, r.num_new,
                              source=pf, admit=False, chain=list(r.chain))
        while rep.idle_senders():
            rep.pump_streams()
        while any(dec.active) or dec.queue or dec._inflight:
            dec.step()
        dec._flush_first_tokens()
    return dict(dec.out)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_suffix_only_stream_across_packages_depth_12(direction):
    """A JAX prefill with the prefix cache streams into a torch decode
    engine (the JAX sender into the port's hub), and a torch prefill into
    a JAX decode engine (the port's sender into the JAX hub), fp32: the
    first stream ships every block and the receiver registers the chain;
    the later ones skip the 2-block prefix and ship only the suffix;
    tokens equal the monolithic engine's, and nothing leaks."""
    from vtpu.models.transformer import TransformerLM as JaxLM
    from vtpu.serving import transport as jtp
    from vtpu.serving.disagg import DecodeEngine as JDec
    from vtpu.serving.disagg import PrefillEngine as JPf

    jm = JaxLM(**dict(KW, depth=12), kv_cache_layout="paged",
               kv_block_size=BS, kv_pool_blocks=POOL)
    params = jax_params(jm)
    tm = port_of(jm, params)
    reqs = prefix_requests(seed=29, n=4)
    want = run_monolithic(tm, reqs)
    if direction == "jax_to_torch":
        pf = JPf(jm, params, prefix_cache=True)
        dec = DecodeEngine(tm, 4, eos_id=2, device="cpu")
        rep = jtp.WireReplica(jtp.LoopbackLink(ttp.ReceiverHub(dec)), "w0",
                              chunk_blocks=1)
    else:
        pf = PrefillEngine(tm, prefix_cache=True, device="cpu")
        dec = JDec(jm, params, max_batch=4, eos_id=2)
        rep = ttp.WireReplica(ttp.LoopbackLink(jtp.ReceiverHub(dec)), "w0",
                              chunk_blocks=1)
    skips = _recording_skips(dec)
    assert _stream_waves(pf, dec, rep, reqs) == want
    assert skips == [0, 2, 2, 2]
    assert pf.prefix_hits == 3
    st = dec.pool.stats()
    assert st["prefix_runs"] >= 2
    assert st["leased"] == st["prefix_blocks"] and st["detached_handles"] == 0
    pst = pf.pool.stats()
    assert pst["leased"] == pst["prefix_blocks"]
    assert pst["detached_handles"] == 0
