"""The port's disaggregated engines (vtpu_torch/serving/disagg.py) on the
CPU, in f32, at tests/test_disagg.py's size: the shared-pool and
cross-pool topologies give exactly the tokens of the port's monolithic
PagedBatcher and of the JAX package's PrefillEngine/DecodeEngine on the
same weights, over shared × (pipeline_depth, harvest_every); handles
round-trip, stale stamps and missing sources are refused, raw prompts
too; adoption waits for blocks; purge frees a claim; the JAX package's
unchanged Router drives two torch decode replicas token-exactly.  The
prefix cache, the host spill tier and session moves have files of their
own: tests/test_torch_{prefix,spill,session}.py.

The JAX side runs once, in a module-scoped fixture, so its compiles do
not repeat.
"""

import numpy as np
import pytest

from torch_parity import jax_params, port_of
from vtpu_torch.serving import kvpool as tkv
from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
from vtpu_torch.serving.kvpool import (
    KVHandle,
    KVHandoffError,
    PoolMismatchError,
    StaleHandleError,
)
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32)
BS = 8
POOL = 33  # 32 leasable blocks
MATRIX = [(0, 1), (1, 4)]


def fuzz_requests(seed=3, n=10):
    """tests/test_disagg.py's requests: prompt lengths across the
    power-of-two buckets, budgets from instant retire (1) up."""
    rng = np.random.default_rng(seed)
    lens = [3, 4, 5, 7, 8, 9, 12, 16, 17, 24]
    news = [1, 2, 5, 8, 3, 6, 4, 7, 2, 5]
    return [(f"r{i}", rng.integers(0, 64, lens[i % len(lens)]).astype(
        np.int32), news[i % len(news)]) for i in range(n)]


def _drive(pf, dec, reqs, src):
    for rid, p, n in reqs:
        pf.submit(rid, p, num_new=n)
    while pf.queue or dec.queue or any(dec.active) or dec._inflight:
        for res in pf.step():
            dec.submit_handle(res.rid, res.handle, res.first_token,
                              res.num_new, source=src)
        dec.step()
    return dec.out


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its weights in the port, and the JAX engines' tokens
    for every case of the matrix (monolithic and disaggregated)."""
    from vtpu.models.transformer import TransformerLM as JaxLM
    from vtpu.serving.disagg import DecodeEngine as JDec
    from vtpu.serving.disagg import PrefillEngine as JPf
    from vtpu.serving.paged import PagedBatcher as JPaged

    jm = JaxLM(**KW, kv_cache_layout="paged", kv_block_size=BS,
               kv_pool_blocks=POOL)
    params = jax_params(jm)
    reqs = fuzz_requests()
    mono = JPaged(jm, params, max_batch=4, eos_id=2)
    for rid, p, n in reqs:
        mono.submit(rid, p, num_new=n)
    out = {"mono": mono.run()}
    for shared in (True, False):
        for depth, harvest in MATRIX:
            dec = JDec(jm, params, max_batch=4, eos_id=2,
                       pipeline_depth=depth, harvest_every=harvest)
            pf = JPf(jm, params, shared_with=dec if shared else None)
            out[shared, depth, harvest] = _drive(
                pf, dec, reqs, None if shared else pf)
    return {"jm": jm, "params": params, "tm": port_of(jm, params),
            "out": out}


def run_monolithic(tm, reqs, **kw):
    eng = PagedBatcher(tm, max_batch=4, eos_id=2, device="cpu", **kw)
    for rid, p, n in reqs:
        eng.submit(rid, p, num_new=n)
    return eng.run()


def _leak_free(pool) -> bool:
    st = pool.stats()
    return (st["leased"] == 0 and st["detached_handles"] == 0
            and st["free"] == st["pool_blocks"] - 1)


def test_monolithic_engines_agree(ref):
    assert run_monolithic(ref["tm"], fuzz_requests()) == ref["out"]["mono"]


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared-pool", "cross-pool"])
@pytest.mark.parametrize("pipeline_depth,harvest_every", MATRIX)
def test_disagg_token_exact_fuzz_matrix(ref, shared, pipeline_depth,
                                        harvest_every):
    """Disaggregated tokens equal the monolithic engine's and the JAX
    engines' over both adoption modes, the sync harvest and the
    windowed pipelined one; no cache byte crossed the host."""
    tm = ref["tm"]
    reqs = fuzz_requests()
    dec = DecodeEngine(tm, 4, eos_id=2, pipeline_depth=pipeline_depth,
                       harvest_every=harvest_every, device="cpu")
    pf = PrefillEngine(tm, shared_with=dec if shared else None,
                       device="cpu")
    got = _drive(pf, dec, reqs, None if shared else pf)
    assert got == run_monolithic(tm, reqs)
    assert got == ref["out"][shared, pipeline_depth, harvest_every]
    st = dec.pool.stats()
    assert st["handoff_host_bytes"] == 0
    assert st["handoff_shared" if shared else "handoff_copy"] == len(reqs)
    assert st["handoff_device_bytes"] == (0 if shared else
                                          st["handoff_blocks"]
                                          * 2 * 2 * 4 * BS * 8 * 4)
    assert _leak_free(dec.pool) and _leak_free(pf.pool)


def test_handle_round_trip_across_two_pools(ref):
    """A handle through its wire document (the JAX package's reads it
    too) adopts across two pools and decoding continues exactly."""
    from vtpu.serving.kvpool import KVHandle as JaxHandle

    tm = ref["tm"]
    reqs = fuzz_requests(seed=11, n=6)
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    dec = DecodeEngine(tm, 4, eos_id=2, device="cpu")
    for rid, p, n in reqs:
        pf.submit(rid, p, num_new=n)
    while pf.queue or dec.queue or any(dec.active) or dec._inflight:
        for res in pf.step():
            doc = res.handle.to_wire()
            assert JaxHandle.from_wire(doc).to_wire() == doc
            rebuilt = KVHandle.from_wire(doc)
            assert rebuilt == res.handle
            dec.submit_handle(res.rid, rebuilt, res.first_token,
                              res.num_new, source=pf)
        dec.step()
    assert dec.out == want
    assert _leak_free(pf.pool) and _leak_free(dec.pool)


def test_stale_handle_rejected_on_live_engines(ref):
    tm = ref["tm"]
    pf = PrefillEngine(tm, device="cpu")
    a = DecodeEngine(tm, 2, eos_id=2, device="cpu")
    b = DecodeEngine(tm, 2, eos_id=2, device="cpu")
    pf.submit("x", np.array([1, 2, 3], np.int32), 3)
    res = pf.step()[0]
    a.submit_handle("x", res.handle, res.first_token, res.num_new, source=pf)
    with pytest.raises(StaleHandleError):
        b.submit_handle("x", res.handle, res.first_token, res.num_new,
                        source=pf)
    assert pf.pool.stats()["handoff_stale"] == 1
    while any(a.active) or a.queue or a._inflight:
        a.step()
    assert len(a.out["x"]) == 3
    assert _leak_free(pf.pool) and _leak_free(a.pool) and _leak_free(b.pool)


def test_cross_pool_adopt_requires_the_source(ref):
    tm = ref["tm"]
    pf = PrefillEngine(tm, device="cpu")
    dec = DecodeEngine(tm, 2, device="cpu")
    pf.submit("y", np.array([1, 2], np.int32), 2)
    res = pf.step()[0]
    with pytest.raises(PoolMismatchError):
        dec.submit_handle("y", res.handle, res.first_token, res.num_new)
    other = PrefillEngine(tm, device="cpu")
    with pytest.raises(PoolMismatchError):
        dec.submit_handle("y", res.handle, res.first_token, res.num_new,
                          source=other)
    # the failed adoptions did not consume the handle
    dec.submit_handle("y", res.handle, res.first_token, res.num_new,
                      source=pf)
    dec.run()
    assert _leak_free(pf.pool) and _leak_free(dec.pool)


def test_decode_engine_rejects_raw_prompts(ref):
    dec = DecodeEngine(ref["tm"], 2, device="cpu")
    with pytest.raises(TypeError):
        dec.submit("r", np.array([1, 2], np.int32), 2)


def test_adoption_backpressure_waits_for_blocks(ref):
    """A decode replica with a tiny pool adopts head-of-line as its blocks
    free: backpressure, not failure."""
    tm = ref["tm"]
    tight = port_of(ref["jm"], ref["params"], kv_pool_blocks=5)
    pf = PrefillEngine(tm, device="cpu")
    dec = DecodeEngine(tight, 4, eos_id=2, device="cpu")
    reqs = [(f"b{i}", np.arange(1, 10, dtype=np.int32) + i, 3)
            for i in range(4)]
    want = run_monolithic(tm, reqs)
    for rid, p, n in reqs:
        pf.submit(rid, p, num_new=n)
    for res in pf.run():
        dec.submit_handle(res.rid, res.handle, res.first_token,
                          res.num_new, source=pf)
    assert len(dec.queue) > 0 or sum(dec.active) < 4  # somebody waited
    while any(dec.active) or dec.queue or dec._inflight:
        dec.step()
    assert dec.out == want
    assert _leak_free(pf.pool) and _leak_free(dec.pool)


def test_prefill_backpressure_is_fifo(ref):
    """A prefill pool that leases one request at a time completes them in
    order, one a round, and frees nothing it does not own."""
    tm = port_of(ref["jm"], ref["params"], kv_pool_blocks=3)
    pf = PrefillEngine(tm, device="cpu")
    for i in range(3):
        pf.submit(f"q{i}", np.arange(1, 12, dtype=np.int32) + i, 4)
    first = pf.step()
    assert [r.rid for r in first] == ["q0"] and pf.stats()["queued"] == 2
    assert pf.step() == []  # the head waits: nothing released yet
    pf.pool.release_handle(first[0].handle)
    assert [r.rid for r in pf.step()] == ["q1"]
    assert pf.purge("q2") and not pf.purge("q2")
    assert pf.run() == []


def test_router_end_to_end_multi_replica_exact(ref):
    """The JAX package's unchanged Router: one torch prefill and two torch
    decode replicas behind session affinity, token-exact against the
    monolithic engine, nothing leaked."""
    from vtpu.serving.router import Router

    tm = ref["tm"]
    reqs = fuzz_requests(seed=23, n=8)
    want = run_monolithic(tm, reqs)
    pf = PrefillEngine(tm, device="cpu")
    reps = {f"d{i}": DecodeEngine(tm, 4, eos_id=2, replica_id=f"d{i}",
                                  device="cpu") for i in range(2)}
    router = Router(pf, reps)
    for i, (rid, p, n) in enumerate(reqs):
        router.submit(f"sess{i % 3}", rid, p, num_new=n)
    assert router.drain() == want
    assert _leak_free(pf.pool)
    for eng in reps.values():
        assert _leak_free(eng.pool)
    assert sum(e.pool.stats()["handoff_copy"] for e in reps.values()) == 8


def test_router_drives_a_colocated_pair(ref):
    from vtpu.serving.router import Router

    tm = ref["tm"]
    reqs = fuzz_requests(seed=5, n=6)
    dec = DecodeEngine(tm, 4, eos_id=2, device="cpu")
    pf = PrefillEngine(tm, shared_with=dec, device="cpu")
    router = Router(pf, {"d0": dec})
    for i, (rid, p, n) in enumerate(reqs):
        router.submit(f"s{i}", rid, p, num_new=n)
    assert router.drain() == run_monolithic(tm, reqs)
    assert _leak_free(dec.pool)
    assert dec.pool.stats()["handoff_shared"] == 6


def test_purge_pending_frees_claimed_entry(ref):
    tm = ref["tm"]
    pf = PrefillEngine(tm, device="cpu")
    dec = DecodeEngine(tm, 4, eos_id=2, device="cpu")
    pf.submit("r0", np.arange(7, dtype=np.int32) % 64, 3)
    res = pf.step()[0]
    dec.submit_handle(res.rid, res.handle, res.first_token, res.num_new,
                      source=pf, admit=False)
    assert len(dec.queue) == 1
    assert dec.purge_pending("r0") is True
    assert len(dec.queue) == 0
    dec.admit_pending()
    assert not any(dec.active)          # no slot consumed
    assert _leak_free(pf.pool) and _leak_free(dec.pool)
    # the rid is reusable at the decode engine after the purge
    pf.submit("r0b", np.arange(5, dtype=np.int32) % 64, 2)
    res2 = pf.step()[0]
    dec.submit_handle("r0", res2.handle, res2.first_token, res2.num_new,
                      source=pf)
    while any(dec.active) or dec._inflight or dec.queue:
        dec.step()
    dec._flush_first_tokens()
    assert len(dec.out["r0"]) == 2
    assert _leak_free(pf.pool) and _leak_free(dec.pool)


def test_shared_prefill_has_no_pool_of_its_own(ref):
    tm = ref["tm"]
    dec = DecodeEngine(tm, 2, device="cpu")
    pf = PrefillEngine(tm, shared_with=dec, device="cpu")
    assert pf.pool is dec.pool
    with pytest.raises(PoolMismatchError):
        pf.pool_leaves()
    small = port_of(ref["jm"], ref["params"], kv_block_size=4,
                    max_seq=32)
    with pytest.raises(PoolMismatchError):
        PrefillEngine(small, shared_with=dec, device="cpu")


def test_submit_validation(ref):
    tm = ref["tm"]
    pf = PrefillEngine(tm, device="cpu")
    with pytest.raises(ValueError):
        pf.submit("a", np.arange(30, dtype=np.int32), 3)  # > max_seq
    with pytest.raises(ValueError):
        pf.submit("a", np.array([], np.int32), 3)
    with pytest.raises(ValueError):
        pf.submit("a", np.array([1], np.int32), 0)
    pf.submit("a", np.array([1, 2], np.int32), 2)
    with pytest.raises(ValueError):
        pf.submit("a", np.array([1, 2], np.int32), 2)  # duplicate
    res = pf.step()[0]
    dec = DecodeEngine(tm, 2, device="cpu")
    with pytest.raises(ValueError):
        dec.submit_handle("a", res.handle, res.first_token, 31, source=pf)
    dec.submit_handle("a", res.handle, res.first_token, 2, source=pf)
    with pytest.raises(ValueError):
        dec.submit_handle("a", res.handle, res.first_token, 2, source=pf)
    dec.run()


# -- the pool's handle surface ---------------------------------------------
def test_pool_handle_protocol():
    pool = tkv.BlockPool(9, 8)
    other = tkv.BlockPool(9, 8)
    assert pool.pool_id != other.pool_id
    blocks = pool.lease(3)
    h = pool.detach(blocks, seq_len=20)
    with pytest.raises(KVHandoffError):
        pool.detach(blocks, seq_len=20)  # one claim ticket per lease
    with pytest.raises(PoolMismatchError):
        other.adopt(h)
    assert pool.adopt(h) == blocks
    with pytest.raises(StaleHandleError):
        pool.adopt(h)
    h2 = pool.detach(blocks, seq_len=20)
    assert h2.stamp == h.stamp + 1
    pool.release_handle(h2)
    with pytest.raises(tkv.DoubleReleaseError):
        pool.release(blocks)
    st = pool.stats()
    assert (st["leased"], st["detached_handles"], st["handoff_stale"]) == (
        0, 0, 1)
    with pytest.raises(KVHandoffError):
        KVHandle.from_wire({"pool": "p", "blocks": [1]})
    with pytest.raises(KeyError):
        pool.count(no_such_counter=1)


def test_shared_block_may_back_one_claim_per_reference():
    pool = tkv.BlockPool(5, 8)
    blocks = pool.lease(2)
    pool.ref(blocks)                     # a second reference (sharing)
    h1 = pool.detach(blocks, seq_len=9)
    h2 = pool.detach(blocks, seq_len=9)  # one claim per reference
    with pytest.raises(KVHandoffError):
        pool.detach(blocks, seq_len=9)
    pool.release_handle(h1)
    pool.release_handle(h2)
    assert pool.stats()["free"] == 4
