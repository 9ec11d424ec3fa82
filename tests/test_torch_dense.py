"""The port's dense KV-cache layout against vtpu's on the CPU: decode
logits and cache contents against flax's ``decode=True`` (MHA and GQA,
learned and rope, window, native and int8, chunked prefill), the
whole-write clamp of ``jax.lax.dynamic_update_slice``, the dense
``ContinuousBatcher``'s tokens against the JAX engine's over the
scheduling matrix of ``tests/test_batcher.py``, and the dense engine
against the port's ``PagedBatcher`` on the same weights.

The ``cuda``-marked test holds the int8 cache's codec on the card
against the CPU (``python -m pytest tests/test_torch_dense.py -m cuda
--noconftest``; it imports JAX only inside the CPU tests' fixtures)."""

import numpy as np
import pytest
import torch

from vtpu_torch.models import transformer as ttf
from vtpu_torch.serving.batcher import ContinuousBatcher
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=64, depth=2, num_heads=4, max_seq=64,
          kv_cache_layout="dense")
# the JAX engine tests' model (tests/test_batcher.py::make_model)
ENGINE_KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32,
                 kv_cache_layout="dense")
TOL = 1e-5        # f32 logits, native cache
TOL_INT8 = 1e-4   # as the int8 paged tests (tests/test_torch_transformer.py)
# after a level flip: the two frameworks' f32 K or V can differ by an ulp
# at a rounding tie of the int8 grid, and one level (one scale, ~1e-2 of
# the vector's absmax) then moves the logits by ~1e-3
TOL_INT8_FLIP = 5e-3


@pytest.fixture(scope="module")
def jx():
    """JAX and the parity helpers, imported here so that the file also
    collects where JAX is absent (the card's machine)."""
    import jax
    import jax.numpy as jnp

    import torch_parity
    from vtpu.models import transformer as jtf
    from vtpu.serving import ContinuousBatcher as JaxBatcher

    return dict(jax=jax, jnp=jnp, jtf=jtf, JaxBatcher=JaxBatcher,
                params=torch_parity.jax_params, port_of=torch_parity.port_of)


def _jax_layers(jtf_cache, depth: int):
    """flax's dense cache ``{"h<i>": {"attn": {k, v, ...}}}`` as numpy."""
    return [{n: np.asarray(a) for n, a in jtf_cache[f"h{i}"]["attn"].items()}
            for i in range(depth)]


def _port_layers(cache):
    return [{n: t.numpy().copy() for n, t in layer.items()}
            for layer in cache["layers"]]


def _jax_run(jx, jm, params, feeds, pos_after=None):
    """Feed ``feeds`` (a list of [b, s] token blocks) through flax's
    decode path; ``pos_after[i]``, when set, rewinds the counter after
    feed i.  Returns the logits of each feed, the cache after each feed
    (as numpy layers) and the final cache."""
    jnp = jx["jnp"]
    cache = jx["jtf"]._zero_cache(jm, jnp.asarray(feeds[0]))
    out, seen = [], []
    for i, toks in enumerate(feeds):
        logits, mut = jm.apply({"params": params, "cache": cache},
                               jnp.asarray(toks), decode=True,
                               mutable=["cache"])
        cache = mut["cache"]
        if pos_after and pos_after.get(i) is not None:
            cache = jx["jtf"].set_cache_pos(cache, pos_after[i])
        out.append(np.asarray(logits))
        seen.append(_jax_layers(cache, jm.depth))
    return out, seen, cache


def _port_run(tm, feeds, pos_after=None):
    cache = tm.init_cache(feeds[0].shape[0])
    out, seen = [], []
    for i, toks in enumerate(feeds):
        out.append(tm(torch.from_numpy(np.ascontiguousarray(toks)),
                      cache).numpy())
        if pos_after and pos_after.get(i) is not None:
            ttf.set_cache_pos(cache, pos_after[i])
        seen.append(_port_layers(cache))
    return out, seen, cache


def _assert_logits(want, got, jseen, tseen, cache_dtype):
    """Each feed's logits within TOL (native) or TOL_INT8; an int8 cache
    may hold a level one off flax's where the f32 input sat at a rounding
    tie (at most 1 in 1000 levels), and from that feed on the logits are
    held to TOL_INT8_FLIP."""
    flipped = False
    for w, g, jl, tl in zip(want, got, jseen, tseen):
        assert g.dtype == np.float32 and g.shape == w.shape
        if cache_dtype == "int8":
            for a, b in zip(jl, tl):
                for name in ("k", "v"):
                    d = np.abs(a[name].astype(int) - b[name].astype(int))
                    assert d.max() <= 1 and d.mean() <= 1e-3, name
                    flipped |= bool(d.any())
            tol = TOL_INT8_FLIP if flipped else TOL_INT8
        else:
            tol = TOL
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("n_kv", [0, 2], ids=["mha", "gqa"])
def test_dense_decode_logits_and_cache_match_jax(jx, n_kv, pos,
                                                 cache_dtype):
    """A bucketed prefill (5 tokens padded to 8, counter rewound to 5),
    then six one-token steps: every step's logits and, at the end, every
    cache tensor equal flax's."""
    jm = jx["jtf"].TransformerLM(**KW, num_kv_heads=n_kv, pos_embedding=pos,
                                 kv_cache_dtype=cache_dtype)
    params = jx["params"](jm)
    tm = jx["port_of"](jm, params)
    rng = np.random.default_rng(7)
    prompt = np.zeros((2, 8), np.int32)
    prompt[:, :5] = rng.integers(0, 64, (2, 5))
    feeds = [prompt] + [rng.integers(0, 64, (2, 1)).astype(np.int32)
                        for _ in range(6)]
    want, jseen, jcache = _jax_run(jx, jm, params, feeds, {0: 5})
    got, tseen, tcache = _port_run(tm, feeds, {0: 5})
    _assert_logits(want, got, jseen, tseen, cache_dtype)
    tol = TOL_INT8 if cache_dtype == "int8" else TOL
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert set(tcache) == {"pos", "layers"}
    for jl, tl in zip(_jax_layers(jcache, KW["depth"]), _port_layers(tcache)):
        assert jl.keys() == tl.keys()
        for name in jl:
            assert tl[name].dtype == jl[name].dtype, name
            if cache_dtype != "int8" or name not in ("k", "v"):
                np.testing.assert_allclose(tl[name], jl[name], atol=tol,
                                           rtol=1e-6)


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
@pytest.mark.parametrize("n_kv", [0, 2], ids=["mha", "gqa"])
def test_dense_window_and_chunked_prefill_match_jax(jx, n_kv, cache_dtype):
    """attn_window 4 with a prefill fed in chunks of 3 (positions cross
    the window in the prefill and in the steps)."""
    jm = jx["jtf"].TransformerLM(**KW, num_kv_heads=n_kv,
                                 pos_embedding="rope", attn_window=4,
                                 kv_cache_dtype=cache_dtype)
    params = jx["params"](jm)
    tm = jx["port_of"](jm, params)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 64, (2, 9)).astype(np.int32)
    feeds = [prompt[:, lo:lo + 3] for lo in range(0, 9, 3)]
    feeds += [rng.integers(0, 64, (2, 1)).astype(np.int32) for _ in range(5)]
    want, jseen, _ = _jax_run(jx, jm, params, feeds)
    got, tseen, _ = _port_run(tm, feeds)
    _assert_logits(want, got, jseen, tseen, cache_dtype)


def test_write_clamp_matches_jax(jx):
    """``dynamic_update_slice`` clamps the START of an s-token write into
    [0, max_seq - s]: a 6-token prefill at position 12 of a 16-long
    cache lands at 10, over real K/V, and a one-token step at position
    18 (a finished row past max_seq) lands at 15.  The port writes the
    same cache."""
    jm = jx["jtf"].TransformerLM(**dict(KW, max_seq=16), num_kv_heads=2,
                                 pos_embedding="rope")
    params = jx["params"](jm)
    tm = jx["port_of"](jm, params)
    rng = np.random.default_rng(3)
    feeds = [rng.integers(0, 64, (2, 12)).astype(np.int32),
             rng.integers(0, 64, (2, 6)).astype(np.int32),
             rng.integers(0, 64, (2, 1)).astype(np.int32)]
    want, _js, jcache = _jax_run(jx, jm, params, feeds)
    got, _ts, tcache = _port_run(tm, feeds)
    assert tcache["pos"].tolist() == [19, 19]
    for jl, tl in zip(_jax_layers(jcache, KW["depth"]), _port_layers(tcache)):
        for name in jl:
            np.testing.assert_allclose(tl[name], jl[name], atol=TOL, rtol=0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    # the clamp moved the second write back over the first's last 2
    # positions: what stands at 10-11 is the second write's
    k = tcache["layers"][0]["k"]
    fresh = tm.init_cache(2)
    tm(torch.from_numpy(feeds[0]), fresh)
    first = fresh["layers"][0]["k"]
    assert not torch.equal(k[:, :, 10:12], first[:, :, 10:12])
    assert torch.equal(k[:, :, :10], first[:, :, :10])


def test_clone_to_dense_shares_weights():
    m = ttf.TransformerLM(**dict(KW, kv_cache_layout="paged",
                                 kv_block_size=8), device="cpu")
    d = m.clone(kv_cache_layout="dense", kv_cache_dtype="int8")
    assert d.wte.weight is m.wte.weight
    cache = d.init_cache(3)
    assert set(cache) == {"pos", "layers"}
    layer = cache["layers"][0]
    assert layer["k"].shape == (3, 4, 64, 16)
    assert layer["k"].dtype == torch.int8
    assert layer["k_scale"].shape == (3, 4, 64, 1)
    assert layer["k_scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="kv_cache_layout"):
        m.clone(kv_cache_layout="ring")


# -- the dense engine ------------------------------------------------------
def _prompts(n, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, ln).astype(np.int32) for ln in lens[:n]]


def _drive(eng, reqs, steps_between=0):
    for rid, prompt, n in reqs:
        eng.submit(rid, prompt, num_new=n)
        for _ in range(steps_between):
            eng.step()
    return eng.run()


@pytest.fixture(scope="module")
def engine_models(jx):
    """One flax model and its port per model config, for the engine
    tests (each JAX engine compiles its own programs)."""
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            jm = jx["jtf"].TransformerLM(**dict(ENGINE_KW, **kw))
            params = jx["params"](jm)
            cache[key] = (jm, params, jx["port_of"](jm, params))
        return cache[key]

    return get


def _both(jx, engine_models, reqs, model_kw=None, eng_kw=None,
          steps_between=0):
    jm, params, tm = engine_models(**(model_kw or {}))
    want = _drive(jx["JaxBatcher"](jm, params, **eng_kw), reqs,
                  steps_between)
    teng = ContinuousBatcher(tm, device="cpu", **eng_kw)
    got = _drive(teng, reqs, steps_between)
    return want, got, teng


def _reqs(lens, budgets, seed=1):
    return [(f"r{i}", p, n) for i, (p, n) in
            enumerate(zip(_prompts(len(lens), lens, seed), budgets))]


@pytest.mark.parametrize("harvest", [1, 4, 8])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_engine_token_identical_over_pipeline_matrix(jx, engine_models,
                                                     depth, harvest):
    """pipeline_depth x harvest_every, four requests through two slots
    (admission mid-decode, budgets that end mid-window)."""
    reqs = _reqs([3, 5, 4, 6], [7, 4, 6, 3])
    want, got, teng = _both(jx, engine_models, reqs, eng_kw=dict(
        max_batch=2, pipeline_depth=depth, harvest_every=harvest))
    assert got == want
    assert all(len(got[rid]) == n for rid, _p, n in reqs)
    assert teng.steps < sum(n for *_r, n in reqs)


@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_engine_token_identical_over_model_knobs(jx, engine_models, pos,
                                                 cache_dtype):
    reqs = _reqs([3, 5, 4, 6, 9], [7, 4, 6, 3, 5], seed=4)
    want, got, _ = _both(jx, engine_models, reqs,
                         model_kw=dict(pos_embedding=pos, num_kv_heads=2,
                                       kv_cache_dtype=cache_dtype),
                         eng_kw=dict(max_batch=3, harvest_every=2))
    assert got == want


@pytest.mark.parametrize("harvest", [1, 4])
def test_engine_chunked_prefill_token_identical(jx, engine_models, harvest):
    """A long admission prefills one chunk per step while a running
    slot decodes (two chunked prompts in flight at once)."""
    reqs = _reqs([3, 12, 10, 4], [10, 6, 5, 4], seed=11)
    want, got, teng = _both(jx, engine_models, reqs, eng_kw=dict(
        max_batch=3, prefill_chunk=3, harvest_every=harvest),
        steps_between=1)
    assert got == want
    assert not teng.prefilling


@pytest.mark.parametrize("bucket", [True, False])
def test_engine_bucketing_token_identical(jx, engine_models, bucket):
    reqs = _reqs([3, 5, 4, 6, 2, 7], [5, 6, 4, 7, 3, 2], seed=17)
    want, got, teng = _both(jx, engine_models, reqs,
                            eng_kw=dict(max_batch=4, bucket_prefill=bucket))
    assert got == want
    if bucket:  # the row buckets cached, one zero cache each
        assert set(teng._row_tmpls) <= {1, 2, 4}


def test_engine_eos_freeze_and_instant_retirement(jx, engine_models):
    """An EOS hit mid-stream freezes its row; num_new=1 requests retire
    at admission and the queue refills their slots."""
    jm, params, tm = engine_models()
    reqs = _reqs([4, 4, 3, 3, 3, 3], [4, 6, 1, 5, 1, 3], seed=21)
    probe = _drive(ContinuousBatcher(tm, max_batch=2, device="cpu"), reqs)
    eos = probe["r1"][2]  # emitted mid-stream by r1
    want, got, _ = _both(jx, engine_models, reqs,
                         eng_kw=dict(max_batch=2, eos_id=eos,
                                     harvest_every=4))
    assert got == want
    assert got["r1"][2:] == [eos] * 4
    assert len(got["r2"]) == 1 and len(got["r4"]) == 1


def test_engine_mid_flight_admission_and_rerun(jx, engine_models):
    """A request admitted while another is three steps deep, then a
    second batch of requests on the same engine after ``run()``."""
    jm, params, tm = engine_models()
    first = _reqs([4, 4], [8, 5], seed=7)
    second = [(f"s{i}", p, n) for i, (_r, p, n) in
              enumerate(_reqs([6, 3, 5], [4, 7, 3], seed=8))]
    outs = []
    for eng in (jx["JaxBatcher"](jm, params, max_batch=4, harvest_every=4),
                ContinuousBatcher(tm, max_batch=4, harvest_every=4,
                                  device="cpu")):
        eng.submit(*first[0])
        for _ in range(3):
            eng.step()
        eng.submit(*first[1])
        eng.run()
        outs.append(_drive(eng, second))
    assert outs[1] == outs[0]
    assert set(outs[1]) == {"r0", "r1", "s0", "s1", "s2"}


def test_engine_chunked_tail_pad_stays_below_max_seq(jx, engine_models):
    """max_seq 16, prefill_chunk 6, prompt 13: the tail chunk at lo=12
    pads to at most 4 tokens (a longer pad's write would clamp back over
    the prompt's K/V)."""
    reqs = _reqs([13], [3], seed=31)
    want, got, _ = _both(jx, engine_models, reqs,
                         model_kw=dict(max_seq=16),
                         eng_kw=dict(max_batch=2, prefill_chunk=6))
    assert got == want
    jm, params, _tm = engine_models(max_seq=16)
    solo = jx["jtf"].generate(jm, params, jx["jnp"].asarray(reqs[0][1])[None],
                              num_new=3)
    assert got["r0"] == np.asarray(solo)[0].tolist()


def test_engine_duplicate_and_bad_requests(engine_models):
    _jm, _p, tm = engine_models()
    eng = ContinuousBatcher(tm, max_batch=2, prefill_chunk=3, device="cpu")
    p = np.arange(10, dtype=np.int32)
    eng.submit("x", p, num_new=2)
    assert eng.prefilling  # mid-admission
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit("x", p, num_new=2)
    eng.run()
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit("x", p, num_new=2)  # a finished rid stays taken
    with pytest.raises(ValueError, match="num_new"):
        eng.submit("y", p, num_new=0)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit("y", np.zeros(30, np.int32), num_new=8)
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit("y", np.zeros(0, np.int32), num_new=2)
    with pytest.raises(ValueError, match="PagedBatcher"):
        ContinuousBatcher(tm.clone(kv_cache_layout="paged"), max_batch=2,
                          device="cpu")


def test_engine_slot_state_keeps_its_tensors(engine_models):
    """The decode graphs read the batch cache, ``pos`` and ``tok`` at
    their addresses: admission, chunked activation and retirement write
    them in place, and the row templates never alias them."""
    _jm, _p, tm = engine_models(num_kv_heads=2, kv_cache_dtype="int8")
    eng = ContinuousBatcher(tm, max_batch=3, harvest_every=2,
                            prefill_chunk=5, device="cpu")
    tensors = [eng.tok, eng.cache["pos"]] + [
        t for layer in eng.cache["layers"] for t in layer.values()]
    ptrs = [t.data_ptr() for t in tensors]
    out = _drive(eng, _reqs([3, 9, 4, 12, 2, 7], [4, 5, 3, 6, 2, 5],
                            seed=5), steps_between=1)
    assert len(out) == 6
    now = [eng.tok, eng.cache["pos"]] + [
        t for layer in eng.cache["layers"] for t in layer.values()]
    assert all(a is b for a, b in zip(tensors, now))
    assert [t.data_ptr() for t in now] == ptrs
    tmpl_ptrs = {t.data_ptr() for c in eng._row_tmpls.values()
                 for layer in c["layers"] for t in layer.values()}
    assert tmpl_ptrs and not tmpl_ptrs & set(ptrs)


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_dense_engine_equals_paged_engine(engine_models, cache_dtype):
    """The same weights and requests through the dense ContinuousBatcher
    and the paged PagedBatcher (a pool of 1 + 3·4 blocks of 8): the same
    tokens (the gather path reads the dense path's dtypes)."""
    _jm, _p, tm = engine_models(num_kv_heads=2, pos_embedding="rope",
                                kv_cache_dtype=cache_dtype)
    reqs = _reqs([3, 5, 4, 6, 9, 2], [7, 4, 6, 3, 5, 8], seed=2)
    kw = dict(max_batch=3, harvest_every=2, prefill_chunk=4, device="cpu")
    dense = _drive(ContinuousBatcher(tm, **kw), reqs, steps_between=1)
    paged_model = tm.clone(kv_cache_layout="paged", kv_block_size=8,
                           kv_pool_blocks=13)
    paged = _drive(PagedBatcher(paged_model, **kw), reqs, steps_between=1)
    assert dense == paged


# -- on the card -----------------------------------------------------------
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's int8 codec)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int8_cache_codec_same_on_card_and_cpu(cuda_card):
    """``quantize_int8`` divides by a tensor, so the card writes the
    CPU's scales and levels bit for bit (a division by a Python scalar
    becomes a reciprocal multiply on CUDA)."""
    from vtpu_torch.ops.quant import quantize_int8

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 8, 37, 128), generator=gen) * torch.logspace(
        -3, 3, 37)[None, None, :, None]
    cpu = quantize_int8(x, axis=-1)
    card = quantize_int8(x.to(cuda_card), axis=-1)
    assert torch.equal(card.scale.cpu(), cpu.scale)
    assert torch.equal(card.q.cpu(), cpu.q)
