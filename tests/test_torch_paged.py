"""The port's PagedBatcher against vtpu's on the CPU: the same weights
and requests give the same tokens over the scheduling matrix
(pipeline_depth x harvest_every x prefill_chunk), with EOS, prefix
caching and block backpressure, and every case returns its blocks."""

import numpy as np
import pytest

from torch_parity import jax_params, port_of
from vtpu.models.transformer import TransformerLM as JaxLM
from vtpu.serving.paged import PagedBatcher as JaxPaged
from vtpu_torch.serving import kvpool
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=64, depth=2, num_heads=4, max_seq=64,
          kv_cache_layout="paged", kv_block_size=8)


def _requests(seed: int, n: int = 5, shared_prefix: int = 0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, shared_prefix).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 64, int(rng.integers(3, 13))).astype(np.int32)
        reqs.append((f"r{i}", np.concatenate([prefix, tail]),
                     int(rng.integers(4, 9))))
    return reqs


def _serve(eng, reqs, steps_between: int = 0):
    for rid, prompt, n in reqs:
        eng.submit(rid, prompt, num_new=n)
        for _ in range(steps_between):
            eng.step()
    return eng.run()


def _both(reqs, model_kw=None, eng_kw=None, steps_between=0):
    jm = JaxLM(**KW, **(model_kw or {}))
    params = jax_params(jm)
    tm = port_of(jm, params)
    jeng = JaxPaged(jm, params, **(eng_kw or {}))
    teng = PagedBatcher(tm, device="cpu", **(eng_kw or {}))
    free0 = teng.pool_stats()["free"]
    want = _serve(jeng, reqs, steps_between)
    got = _serve(teng, reqs, steps_between)
    return want, got, jeng, teng, free0


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("harvest", [1, 3])
@pytest.mark.parametrize("depth", [0, 1])
def test_token_identical_over_scheduling_matrix(depth, harvest, chunk):
    reqs = _requests(seed=depth * 4 + harvest * 2 + chunk)
    want, got, _j, teng, free0 = _both(
        reqs, model_kw=dict(num_kv_heads=2, pos_embedding="rope",
                            kv_pool_blocks=25),
        eng_kw=dict(max_batch=3, pipeline_depth=depth,
                    harvest_every=harvest, prefill_chunk=chunk))
    assert got == want
    assert all(len(got[rid]) == n for rid, _p, n in reqs)
    assert teng.pool_stats()["free"] == free0
    assert teng.pool_stats()["leased"] == 0


def test_eos_freeze_token_identical():
    """The int8 pool through the kernel path, with an EOS that some rows
    hit (rows freeze to it)."""
    reqs = _requests(seed=11, n=4)
    model_kw = dict(kv_cache_dtype="int8", paged_kernel="on",
                    kv_pool_blocks=17)
    # pick an EOS that is emitted mid-stream (the port's own run without
    # one is the cheap probe; the comparison below is against vtpu)
    jm = JaxLM(**KW, **model_kw)
    probe = _serve(PagedBatcher(port_of(jm, jax_params(jm)), max_batch=2,
                                device="cpu"), reqs)
    eos = next(t for rid, _p, _n in reqs for t in probe[rid][1:-1])
    want, got, _j, teng, free0 = _both(reqs, model_kw,
                                       dict(max_batch=2, eos_id=eos,
                                            harvest_every=2))
    assert got == want
    assert any(eos in toks for toks in got.values())
    assert teng.pool_stats()["free"] == free0


def test_prefix_cache_token_identical():
    reqs = _requests(seed=5, n=5, shared_prefix=16)
    want, got, jeng, teng, free0 = _both(
        reqs, dict(kv_pool_blocks=12),
        dict(max_batch=2, prefix_cache=2), steps_between=1)
    assert got == want
    assert (teng.pool_stats()["registered_prefixes"]
            == jeng.pool_stats()["registered_prefixes"] > 0)
    # registry pins are all that is still leased; evicting them frees all
    while teng._evict_prefix(keep=[]):
        pass
    assert teng.pool_stats()["free"] == free0


def test_block_backpressure_token_identical():
    """A pool smaller than the demand: admissions wait for blocks."""
    reqs = _requests(seed=9, n=5)
    jm = JaxLM(**KW, kv_pool_blocks=6)
    params = jax_params(jm)
    teng = PagedBatcher(port_of(jm, params), max_batch=4, device="cpu")
    for rid, prompt, n in reqs:
        teng.submit(rid, prompt, num_new=n)
    assert teng.queue  # slots are free, blocks are not
    got = teng.run()
    want = _serve(JaxPaged(jm, params, max_batch=4), reqs)
    assert got == want
    assert teng.pool_stats()["free"] == 5


def test_engine_validation():
    jm = JaxLM(**KW, kv_pool_blocks=3)
    params = jax_params(jm)
    tm = port_of(jm, params)
    with pytest.raises(ValueError, match="pool"):
        PagedBatcher(tm.clone(kv_pool_blocks=0), max_batch=2, device="cpu")
    eng = PagedBatcher(tm, max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="lease"):
        eng.submit("x", np.zeros(20, np.int32), num_new=4)  # needs 3
    eng.submit("a", np.zeros(4, np.int32), num_new=2)
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit("a", np.zeros(4, np.int32), num_new=2)
    pool = kvpool.BlockPool(4, 8)
    blocks = pool.lease(2)
    pool.release(blocks)
    with pytest.raises(kvpool.DoubleReleaseError):
        pool.release(blocks)
    assert pool.lease_upto(5) == [3, 1, 2] and pool.free_blocks() == 0
