"""The port's host spill tier and prefix persistence against the JAX
package, on the CPU, in f32 at tests/test_kvspill.py's size.

- ``vtpu_torch.serving.kvpersist.PrefixStore``: round trip (the last
  record a digest wins), a foreign signature dropped, a torn tail and a
  garbage index line skipped, the pair rotation; the same appends give
  the JAX store's bytes, and each package's store loads the other's;
- the pool's host tier: demotion candidates, eviction order, byte cap,
  known chains;
- the engines: under lease pressure the prefill engine demotes (int8) and
  onloads on a revisit, token for token as the monolithic engine and as
  the JAX engines driven the same way (tests/test_kvspill.py:189); an
  onloaded block is the dequantized payload bit for bit, within the
  codec's bound of the block it was demoted from; a journal written by a
  JAX ``PrefillEngine`` rehydrates a torch one, and the other way round,
  with equal tokens.

The port's drive helpers are this file's: ``benchmarks/serving_disagg.py``
drives JAX engines (and the JAX side of the parity runs uses it).
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import jax_params, port_of
from vtpu_torch.serving import kvpool as tkv
from vtpu_torch.serving import transport as ttp
from vtpu_torch.serving import wirecodec
from vtpu_torch.serving.disagg import DecodeEngine, PrefillEngine
from vtpu_torch.serving.kvpersist import PrefixStore
from vtpu_torch.serving.paged import PagedBatcher
from vtpu_torch.serving.prefix import chain_digests

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=64)
BS = 8


def _register(pool, chain, n):
    """Lease, register, release: a prefix run's life in the engine."""
    blocks = pool.try_lease(n)
    assert blocks is not None
    pool.register_prefix(chain, blocks)
    pool.release(blocks)
    return blocks


# -- PrefixStore --------------------------------------------------------------
def test_prefix_store_round_trip_and_last_wins(tmp_path):
    store = PrefixStore(str(tmp_path / "d"), sig="s1")
    store.append(["a", "b"], b"\x01" * 40, "int8", 16)
    store.append(["x"], b"\x02" * 20, "int4", 16)
    store.append(["a", "b"], b"\x03" * 40, "int8", 16)  # same digest
    assert not store.dead and store.blocks_journaled == 5
    store.close()
    got = {c[-1]: (c, p, co, bs) for c, p, co, bs in
           PrefixStore(str(tmp_path / "d"), sig="s1").load()}
    assert set(got) == {"b", "x"}
    assert got["b"] == (("a", "b"), b"\x03" * 40, "int8", 16)
    assert got["x"] == (("x",), b"\x02" * 20, "int4", 16)


def test_prefix_store_foreign_sig_dropped(tmp_path):
    store = PrefixStore(str(tmp_path / "d"), sig="s1")
    store.append(["a"], b"\x01" * 8, "int8", 16)
    store.close()
    assert PrefixStore(str(tmp_path / "d"), sig="OTHER").load() == []
    assert len(PrefixStore(str(tmp_path / "d"), sig="s1").load()) == 1


def test_prefix_store_torn_tail_and_garbage_index(tmp_path):
    store = PrefixStore(str(tmp_path / "d"))
    for i in range(3):
        store.append([f"c{i}"], bytes([i]) * 64, "int8", 16)
    store.close()
    seg = tmp_path / "d" / "prefix_segments.bin"
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 10)  # a torn last record
    with open(tmp_path / "d" / "prefix_index.jsonl", "a") as f:
        f.write('{"half a reco\n')              # a torn index append
    got = PrefixStore(str(tmp_path / "d")).load()
    assert sorted(c[-1] for c, *_ in got) == ["c0", "c1"]


def test_prefix_store_pair_rotation(tmp_path):
    store = PrefixStore(str(tmp_path / "d"), max_bytes=200)
    store.append(["r0"], b"\x00" * 120, "int8", 16)
    store.append(["r1"], b"\x01" * 120, "int8", 16)  # rotates the pair
    store.close()
    for name in ("prefix_segments.bin.1", "prefix_index.jsonl.1"):
        assert (tmp_path / "d" / name).exists()
    got = PrefixStore(str(tmp_path / "d")).load()
    assert sorted(c[-1] for c, *_ in got) == ["r0", "r1"]


def test_prefix_store_bytes_equal_the_jax_store(tmp_path):
    """The same appends through both packages' stores write the same
    files, and each store loads what the other wrote."""
    from vtpu.serving.kvpersist import PrefixStore as JaxStore

    rng = np.random.default_rng(3)
    runs = [([f"d{i}", f"e{i}"][:1 + i % 2],
             bytes(rng.integers(0, 256, 30 + i, dtype=np.uint8)),
             ("int8", "fp8", "int4")[i % 3]) for i in range(7)]
    stores = {"torch": PrefixStore(str(tmp_path / "t"), sig="ab12",
                                   max_bytes=120),
              "jax": JaxStore(str(tmp_path / "j"), sig="ab12",
                              max_bytes=120)}
    for store in stores.values():
        for chain, payload, codec in runs:
            store.append(chain, payload, codec, 8)
        store.close()
    for name in ("prefix_index.jsonl", "prefix_segments.bin",
                 "prefix_index.jsonl.1", "prefix_segments.bin.1"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    assert sorted(PrefixStore(str(tmp_path / "j"), sig="ab12").load()) == \
        sorted(JaxStore(str(tmp_path / "t"), sig="ab12").load())


# -- the pool's host tier -------------------------------------------------------
def test_demotion_candidate_lru_maximal():
    pool = tkv.BlockPool(17, 8)
    _register(pool, ["a", "b", "c"], 3)
    _register(pool, ["x", "y"], 2)
    chain, run = pool.demotion_candidate()
    assert chain == ["a", "b", "c"] and len(run) == 3  # LRU first
    pool.store_spilled(chain, b"\x01" * 24, "int8")
    chain2, run2 = pool.demotion_candidate()
    assert chain2 == ["x", "y"] and len(run2) == 2
    pool.store_spilled(chain2, b"\x02" * 16, "int8")
    assert pool.demotion_candidate() is None
    assert pool.stats()["spill_demotions"] == 2


def test_store_spilled_frees_blocks_and_serves_matches():
    pool = tkv.BlockPool(17, 8)
    _register(pool, ["a", "b", "c"], 3)
    assert pool.free_blocks() == 13
    pool.store_spilled(["a", "b", "c"], b"\x07" * 24, "int8")
    assert pool.free_blocks() == 16          # the pins dropped
    chain, payload, codec, k = pool.match_spilled(["a", "b", "c", "d"], 8)
    assert (tuple(chain), payload, codec, k) == (
        ("a", "b", "c"), b"\x07" * 24, "int8", 3)
    assert pool.match_spilled(["a", "b", "c"], 8) is not None  # a copy
    assert pool.match_spilled(["a", "b", "c"], 2) is None      # too deep
    assert pool.prefix_match_depth(["a", "b", "c"]) == 3
    assert pool.prefix_match_depth(["a", "b", "c"],
                                   include_spilled=False) == 0


def test_evict_prefers_spilled_backed_over_lru():
    pool = tkv.BlockPool(17, 8)
    _register(pool, ["x", "y", "z"], 3)      # older, not spilled
    _register(pool, ["a", "b", "c"], 3)
    pool.store_spilled(["a", "b", "c"], b"\x03" * 24, "int8")
    _register(pool, ["a", "b", "c"], 3)      # onloaded again
    assert pool.evict_prefixes_for(13)
    assert pool.prefix_match_depth(["x", "y", "z"],
                                   include_spilled=False) == 3
    assert pool.prefix_match_depth(["a", "b", "c"],
                                   include_spilled=False) == 0
    assert pool.prefix_match_depth(["a", "b", "c"]) == 3  # the host copy


def test_spill_byte_cap_lru_eviction_and_replace():
    pool = tkv.BlockPool(5, 8, spill_max_bytes=100)
    assert pool.rehydrate_spilled(["a"], b"\x01" * 60, "int8")
    assert pool.rehydrate_spilled(["b"], b"\x02" * 60, "int8")
    st = pool.stats()
    assert st["spilled_runs"] == 1 and st["spilled_bytes"] == 60
    assert pool.match_spilled(["b"], 8) is not None
    assert pool.match_spilled(["a"], 8) is None
    assert pool.rehydrate_spilled(["b"], b"\x04" * 80, "int8")
    st = pool.stats()
    assert st["spilled_runs"] == 1 and st["spilled_bytes"] == 80
    assert pool.rehydrate_spilled(["c"], b"\x05" * 500, "int8")  # kept
    assert pool.stats()["spilled_runs"] == 1
    assert not pool.rehydrate_spilled([], b"\x05", "int8")
    assert pool.stats()["spill_rehydrations"] == 4


def test_known_chains_and_tier_counts():
    pool = tkv.BlockPool(17, 8)
    _register(pool, ["d1", "d2"], 2)
    pool.rehydrate_spilled(["s1", "s2", "s3"], b"\x09" * 24, "int8")
    chains = pool.known_chains()
    assert ("s1", "s2", "s3") in chains and ("d1", "d2") in chains
    pool.set_disk_blocks(5)
    st = pool.stats()
    assert (st["pool_blocks"], st["spilled_blocks"], st["disk_blocks"],
            st["prefix_blocks"]) == (17, 3, 5, 2)
    pool.close()
    pool.close()  # idempotent, and the pool stays usable
    assert pool.prefix_match_depth(["d1", "d2"]) == 2


# -- the engines ----------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """The JAX models of tests/test_kvspill.py's size (a 13-block and a
    33-block pool, a 65-block one for the monolithic engine), one set of
    weights, and their ports."""
    from vtpu.models.transformer import TransformerLM as JaxLM

    jm = {n: JaxLM(**KW, kv_cache_layout="paged", kv_block_size=BS,
                   kv_pool_blocks=n) for n in (13, 33, 65)}
    params = jax_params(jm[13])
    return {"jm": jm, "params": params,
            "tm": {n: port_of(m, params) for n, m in jm.items()}}


def kv_stack(tm, codec="fp32", **engine_kw):
    """One serving stack: a prefill engine with the prefix cache and a
    speculative decode engine behind the loopback wire (the port's twin
    of benchmarks/serving_disagg.py::_kv_stack)."""
    pf = PrefillEngine(tm, prefix_cache=True, device="cpu", **engine_kw)
    dec = DecodeEngine(tm, 4, eos_id=2, replica_id="kv0", device="cpu")
    rep = ttp.WireReplica(ttp.LoopbackLink(ttp.ReceiverHub(dec)), "kv0",
                          local=dec, chunk_blocks=2, codec=codec)
    return pf, dec, rep


def kv_drive_one(pf, dec, rep, rid, prompt, num_new) -> None:
    """Serve one request to its end (the twin of ``_kv_drive_one``)."""
    hub = rep.link.hub
    pf.submit(rid, prompt, num_new=num_new)
    while (pf.queue or rep.idle_senders() or dec.queue or any(dec.active)
           or dec._inflight):
        for res in pf.step():
            rep.submit_handle(res.rid, res.handle, res.first_token,
                              res.num_new, source=pf,
                              submitted=res.submitted, admit=False)
        stalls = 0
        while rep.idle_senders():
            before = hub.stats().get("chunks", 0)
            rep.pump_streams()
            if rep.idle_senders() and hub.stats().get("chunks", 0) == before:
                dec.step()  # starved: retire slots for credits
                stalls += 1
                assert stalls < 10000, "kv drive wedged"
        dec.step()
    dec._flush_first_tokens()


def spill_requests(seed=5):
    """tests/test_kvspill.py's working set: four 3-block prefixes (12
    blocks, a 12-block pool) with 5-token suffixes, and a revisit of the
    first."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 64, 24).astype(np.int32) for _ in range(4)]
    reqs = [(f"r{i}", np.concatenate(
        [prefixes[i], rng.integers(0, 64, 5).astype(np.int32)]), 3)
        for i in range(4)]
    revisit = ("rv0", np.concatenate(
        [prefixes[0], rng.integers(0, 64, 5).astype(np.int32)]), 3)
    return reqs, revisit


def run_monolithic(tm, reqs):
    eng = PagedBatcher(tm, max_batch=4, eos_id=2, device="cpu")
    for rid, p, n in reqs:
        eng.submit(rid, p, num_new=n)
    return {rid: list(t) for rid, t in eng.run().items()}


def test_engine_spill_demote_onload_token_exact(models):
    """A working set larger than the prefill pool: the engine demotes
    under lease pressure and onloads on the revisit; every transcript
    equals the monolithic engine's and the JAX engines' driven the same
    way; the pools come back leak-free, the host copies kept."""
    from benchmarks.serving_disagg import _kv_drive_one, _kv_stack

    reqs, revisit = spill_requests()
    want = run_monolithic(models["tm"][65], reqs + [revisit])
    pf, dec, rep = kv_stack(models["tm"][13], host_spill=True)
    for r in reqs:
        kv_drive_one(pf, dec, rep, *r)
    assert pf.spill_demotions >= 1
    onloads = pf.spill_onloads
    kv_drive_one(pf, dec, rep, *revisit)
    assert pf.spill_onloads == onloads + 1
    got = {rid: list(dec.out[rid]) for rid in want}
    assert got == want
    jpf, jdec, jrep = _kv_stack(models["jm"][13], models["params"],
                                host_spill=True)
    for r in reqs + [revisit]:
        _kv_drive_one(jpf, jdec, jrep, *r)
    jdec._flush_first_tokens()
    assert {rid: list(jdec.out[rid]) for rid in want} == want
    assert (pf.spill_demotions, pf.spill_onloads) == \
        (jpf.spill_demotions, jpf.spill_onloads)
    st = pf.stats()
    assert st["spill_demotions"] == pf.spill_demotions
    assert st["spilled_runs"] >= 1
    assert pf.pool.evict_prefixes_for(pf.pool.leasable())
    st = pf.pool.stats()
    assert st["leased"] == 0 and st["free"] == st["pool_blocks"] - 1
    assert st["spilled_runs"] >= 1  # the host copies survive
    assert dec.pool.stats()["leased"] == 0


@pytest.mark.parametrize("codec", wirecodec.QUANT_CODECS)
def test_onloaded_blocks_are_the_dequantized_payload(models, monkeypatch,
                                                     codec):
    """An onload writes exactly the payload's dequantization (numpy's
    parse, scaled in f32, bit for bit), and each block within the codec's
    bound of the block demoted; the demotion's payload is the numpy
    twin's encoding of those blocks."""
    monkeypatch.setenv("VTPU_KV_SPILL_CODEC", codec)
    tm = models["tm"][13]
    pf = PrefillEngine(tm, prefix_cache=True, host_spill=True,
                       device="cpu")
    reqs, revisit = spill_requests(seed=9)
    demoted = {}
    inner = pf.pool.store_spilled

    def store_spilled(chain, payload, c):
        # the run's blocks still hold the K/V demoted: keep a copy
        run = next(r for d, r in pf.pool._prefix_runs.items()
                   if d == chain[-1])
        demoted[tuple(chain)] = [t[list(run)].clone()
                                 for t in pf.pool_leaves()]
        inner(chain, payload, c)

    pf.pool.store_spilled = store_spilled
    for rid, p, n in reqs + [revisit]:
        pf.submit(rid, p, n)
        for res in pf.run():
            pf.pool.release_handle(res.handle)
    assert pf.spill_demotions >= 1 and pf.spill_onloads == 1
    # the revisit onloaded its prefix's run (its chain is the prefix's)
    chain = tuple(chain_digests(revisit[1].tolist(), BS))
    assert chain in demoted
    _c, payload, got_codec, k = pf.pool.match_spilled(list(chain), 8)
    assert got_codec == codec and k == len(chain)
    run = pf.pool._prefix_runs[chain[-1]]
    meta = [(int(np.prod(t.shape[1:])), tuple(t.shape[1:]), np.float32)
            for t in pf.pool_leaves()]
    parsed = wirecodec.split_payload(payload, meta, k, codec)
    for (scales, q), leaf, src in zip(parsed, pf.pool_leaves(),
                                      demoted[chain]):
        want_q, want_s = wirecodec.quantize_blocks_for(src.numpy(), codec)
        if codec == "fp8":
            assert np.array_equal(q, want_q)
        else:
            assert np.array_equal(q, want_q.astype(np.int8))
        assert scales.tobytes() == np.asarray(want_s, "<f4").tobytes()
        s = torch.from_numpy(scales.copy()).reshape((k,) + (1,) * 3)
        if codec == "fp8":
            from vtpu_torch.ops.quant import _e4m3_to_f32

            deq = _e4m3_to_f32(torch.from_numpy(q.copy())) * s
        else:
            deq = torch.from_numpy(q.astype(np.float32)) * s
        onloaded = leaf[list(run)]
        assert torch.equal(onloaded, deq.to(onloaded.dtype))
        bound = wirecodec.error_bound(float(scales.max()), codec)
        assert float((onloaded - src).abs().max()) <= bound


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_rehydrates_across_packages(models, tmp_path, writer):
    """A journal written by one package's PrefillEngine (a demotion under
    ``persist_dir``) rehydrates the other package's engine at start: its
    host tier holds the run, the first revisit onloads it, and the tokens
    equal the monolithic engine's and those of the writer's package
    rehydrated from the same journal."""
    from benchmarks.serving_disagg import _kv_drive_one, _kv_stack

    d = str(tmp_path / "persist")
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 64, 24).astype(np.int32)
    seed = ("seed", np.concatenate(
        [prefix, rng.integers(0, 64, 5).astype(np.int32)]), 3)
    req = ("f0", np.concatenate(
        [prefix, rng.integers(0, 64, 5).astype(np.int32)]), 3)
    want = run_monolithic(models["tm"][65], [req])
    jm, params, tm = models["jm"][33], models["params"], models["tm"][33]
    if writer == "jax":
        w = _kv_stack(jm, params, host_spill=True, persist_dir=d)
        _kv_drive_one(*w, *seed)
    else:
        w = kv_stack(tm, host_spill=True, persist_dir=d)
        kv_drive_one(*w, *seed)
    assert w[0]._demote_for(w[0].pool.leasable())
    assert w[0]._persist.blocks_journaled == 3
    w[0]._persist.close()
    got = {}
    for reader in ("torch", "jax"):
        if reader == "torch":
            pf, dec, rep = kv_stack(tm, host_spill=True, persist_dir=d)
        else:
            pf, dec, rep = _kv_stack(jm, params, host_spill=True,
                                     persist_dir=d)
        st = pf.pool.stats()
        assert st["spilled_runs"] == 1 and st["spilled_blocks"] == 3
        if reader == "torch":
            assert st["disk_blocks"] == 3 and st["spill_rehydrations"] == 1
        (kv_drive_one if reader == "torch" else _kv_drive_one)(
            pf, dec, rep, *req)
        dec._flush_first_tokens()
        assert pf.spill_onloads == 1
        got[reader] = {req[0]: list(dec.out[req[0]])}
    assert got["torch"] == got["jax"] == want


def test_spill_needs_a_standalone_pool_and_the_prefix_cache(models,
                                                            monkeypatch):
    tm = models["tm"][13]
    dec = DecodeEngine(tm, 2, device="cpu")
    assert not PrefillEngine(tm, shared_with=dec, prefix_cache=True,
                             host_spill=True, device="cpu").host_spill
    assert not PrefillEngine(tm, host_spill=True, device="cpu").host_spill
    monkeypatch.setenv("VTPU_KV_HOST_SPILL", "1")
    monkeypatch.setenv("VTPU_KV_SPILL_CODEC", "fp32")  # not a spill codec
    pf = PrefillEngine(tm, prefix_cache=True, device="cpu")
    assert pf.host_spill and pf._spill_codec == "int8"
