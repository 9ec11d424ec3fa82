"""The port's ``generate`` (sampled), ``generate_beam`` and
``generate_speculative`` against vtpu's on the CPU, on the same weights.

Beam and speculative tokens equal JAX's (and speculative's equal greedy
``generate``, with the same count of verify forwards).  Sampled tokens
cannot equal JAX's threefry draws (ROADMAP C), so sampling is held by
its own properties: ``top_k=1`` is greedy, a seeded generator reproduces
its tokens, no token falls outside its step's top k, and 20,000 draws
from a fixed logit vector fit its softmax (chi-square).  JAX is imported
inside a fixture, so the file also collects without it."""

import numpy as np
import pytest
import torch

from vtpu_torch.models import transformer as ttf

KW = dict(vocab=64, d_model=64, depth=2, num_heads=4, max_seq=64,
          kv_cache_layout="dense")
# a beam's candidates at a step tie within f32 rounding below this
# margin, where the two frameworks' log-softmax may order them apart
BEAM_MARGIN = 1e-4


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    import torch_parity
    from vtpu.models import transformer as jtf

    return dict(jnp=jnp, jtf=jtf, params=torch_parity.jax_params,
                port_of=torch_parity.port_of)


def _pair(jx, **kw):
    jm = jx["jtf"].TransformerLM(**dict(KW, **kw))
    params = jx["params"](jm)
    return jm, params, jx["port_of"](jm, params)


def _prompt(b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, (b, s)).astype(
        np.int32)


# -- beam ------------------------------------------------------------------
@pytest.mark.parametrize("cfg,seed", [
    (dict(), 1),
    (dict(num_kv_heads=2, pos_embedding="rope"), 2),
    (dict(num_kv_heads=2, pos_embedding="rope", kv_cache_dtype="int8"), 3),
], ids=["mha-learned", "gqa-rope", "gqa-rope-int8"])
def test_beam_matches_jax(jx, monkeypatch, cfg, seed):
    """Beam 4, two prompts, 8 new tokens.  The seeds are ones whose
    candidates are at least BEAM_MARGIN apart at the beam's cut at every
    step (checked here): there the order is the model's, not rounding's."""
    jm, params, tm = _pair(jx, **cfg)
    prompt = _prompt(2, 6, seed)
    margins = []
    top = ttf._top

    def recording_top(x, k):
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        margins.append(float((vals[:, k - 1] - vals[:, k]).min()))
        return top(x, k)

    monkeypatch.setattr(ttf, "_top", recording_top)
    got = ttf.generate_beam(tm, prompt, num_new=8, beam=4, device="cpu")
    want = np.asarray(jx["jtf"].generate_beam(jm, params,
                                              jx["jnp"].asarray(prompt),
                                              num_new=8, beam=4))
    assert len(margins) == 8 and min(margins) > BEAM_MARGIN, margins
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_one_is_greedy_and_ties_break_low():
    m = ttf.TransformerLM(**KW, device="cpu")
    prompt = _prompt(3, 5, 4)
    np.testing.assert_array_equal(
        ttf.generate_beam(m, prompt, 7, beam=1, device="cpu").numpy(),
        ttf.generate(m, prompt, 7, device="cpu").numpy())
    vals, idx = ttf._top(torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]]), 2)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[3.0, 3.0]]


# -- speculative -----------------------------------------------------------
def _draft_of(jx, jm, params, tm, depth: int = 1):
    """A draft of the target's first ``depth`` blocks with its embedding,
    ln_f and head (flax params: the target's minus the later blocks)."""
    keep = {k: v for k, v in params.items()
            if not (k.startswith("h") and k[1:].isdigit()
                    and int(k[1:]) >= depth)}
    jd = jm.clone(depth=depth)
    return jd, keep, jx["port_of"](jd, keep)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(num_kv_heads=2, pos_embedding="rope", kv_cache_dtype="int8"),
    dict(kv_cache_layout="paged", kv_block_size=8, paged_kernel="on"),
    dict(kv_cache_layout="paged", kv_block_size=8, kv_cache_dtype="int8",
         pos_embedding="rope", paged_kernel="off"),
], ids=["dense", "dense-gqa-int8", "paged-kernel", "paged-int8-gather"])
@pytest.mark.parametrize("k", [2, 4])
def test_speculative_matches_jax_and_greedy(jx, cfg, k):
    jm, params, tm = _pair(jx, num_heads=4, **cfg)
    jd, dparams, td = _draft_of(jx, jm, params, tm)
    prompt = _prompt(2, 7, 5 + k)
    got, stats = ttf.generate_speculative(tm, td, prompt, num_new=12, k=k,
                                          return_stats=True, device="cpu")
    want, jstats = jx["jtf"].generate_speculative(
        jm, params, jd, dparams, jx["jnp"].asarray(prompt), num_new=12, k=k,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == jstats
    greedy = ttf.generate(tm, prompt, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    # a draft that is the target accepts every proposal
    _t, full = ttf.generate_speculative(tm, tm, prompt, 12, k=k,
                                        return_stats=True, device="cpu")
    assert full["verify_forwards"] == -(-11 // (k + 1))


# -- sampling --------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(kv_cache_layout="paged", kv_block_size=8, pos_embedding="rope"),
], ids=["dense", "paged"])
def test_top_k_one_is_greedy_against_jax(jx, cfg):
    jm, params, tm = _pair(jx, **cfg)
    prompt = _prompt(2, 6, 8)
    want = np.asarray(jx["jtf"].generate(jm, params,
                                         jx["jnp"].asarray(prompt),
                                         num_new=9, prefill_chunk=4,
                                         eos_id=7))
    gen = torch.Generator().manual_seed(0)
    got = ttf.generate(tm, prompt, 9, temperature=0.8, prefill_chunk=4,
                       eos_id=7, top_k=1, generator=gen, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _replayed_logits(tm, prompt, toks):
    """The logits each sampled token was drawn from: the prompt, then
    the sampled tokens fed back one by one."""
    cache = tm.init_cache(prompt.shape[0])
    out = [tm(torch.from_numpy(prompt), cache)[:, -1]]
    for t in range(toks.shape[1] - 1):
        out.append(tm(toks[:, t:t + 1], cache)[:, -1])
    return torch.stack(out, dim=1)  # [b, n, V]


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(kv_cache_layout="paged", kv_block_size=8, kv_cache_dtype="int8"),
], ids=["dense", "paged-int8"])
def test_sampling_reproduces_and_stays_in_top_k(cfg):
    tm = ttf.TransformerLM(**dict(KW, **cfg), device="cpu",
                           generator=torch.Generator().manual_seed(3))
    prompt = _prompt(4, 5, 9)

    def draw(seed, top_k=5):
        return ttf.generate(tm, prompt, 16, temperature=1.5, top_k=top_k,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")

    a, b, c = draw(11), draw(11), draw(12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    logits = _replayed_logits(tm, prompt, a) / 1.5
    kth = torch.topk(logits, 5, dim=-1).values[..., -1]
    picked = logits.gather(-1, a.long()[..., None])[..., 0]
    assert bool((picked >= kth).all())
    # without top_k the draws leave the top 5 somewhere
    wide = draw(11, top_k=0)
    logits = _replayed_logits(tm, prompt, wide) / 1.5
    kth = torch.topk(logits, 5, dim=-1).values[..., -1]
    assert bool((logits.gather(-1, wide.long()[..., None])[..., 0]
                 < kth).any())


def test_sampling_eos_freezes_rows():
    tm = ttf.TransformerLM(**KW, device="cpu")
    prompt = _prompt(6, 4, 10)
    gen = torch.Generator().manual_seed(5)
    free = ttf.generate(tm, prompt, 12, temperature=2.0,
                        generator=gen, device="cpu")
    eos = int(free[0, 2])
    out = ttf.generate(tm, prompt, 12, temperature=2.0, eos_id=eos,
                       generator=torch.Generator().manual_seed(5),
                       device="cpu")
    for row in out.tolist():
        if eos in row:
            i = row.index(eos)
            assert row[i:] == [eos] * (12 - i)
    assert out[0, 2:].tolist() == [eos] * 10


def test_sample_tokens_fits_softmax():
    """20,000 draws over a fixed 8-way logit vector at temperature 0.7
    against softmax(logits / 0.7): chi-square p > 1e-3."""
    from scipy.stats import chisquare

    logits = torch.tensor([1.2, -0.3, 0.0, 2.1, 0.7, -1.5, 0.4, 1.9])
    n = 20_000
    gen = torch.Generator().manual_seed(1234)
    toks = ttf.sample_tokens(logits.expand(n, 8), 0.7, 0, gen)
    assert toks.dtype == torch.int32
    counts = np.bincount(toks.numpy(), minlength=8)
    p = torch.softmax(logits.double() / 0.7, dim=-1).numpy()
    expected = p / p.sum() * n
    assert chisquare(counts, expected).pvalue > 1e-3
    # top_k keeps the k largest (a tie at the k-th value stays in)
    tied = torch.tensor([[3.0, 1.0, 3.0, 2.0, 2.0]])
    draws = ttf.sample_tokens(tied.expand(4000, 5), 1.0, 3,
                              torch.Generator().manual_seed(0))
    assert set(draws.tolist()) == {0, 2, 3, 4}


# -- errors ----------------------------------------------------------------
def test_errors_match_jax(jx):
    dense = _pair(jx)
    paged = _pair(jx, kv_cache_layout="paged", kv_block_size=8)
    pooled = _pair(jx, kv_cache_layout="paged", kv_block_size=8,
                   kv_pool_blocks=9)
    p4 = np.zeros((1, 4), np.int32)
    jt, jn = jx["jtf"], jx["jnp"]

    def both(jax_call, port_call):
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value).replace("vtpu_torch.", "vtpu.") == str(
            want.value)

    jm, params, tm = dense
    both(lambda: jt.generate(jm, params, jn.asarray(p4), 3, temperature=0.5),
         lambda: ttf.generate(tm, p4, 3, temperature=0.5, device="cpu"))
    for num_new, prompt in ((0, p4), (70, p4)):
        both(lambda: jt.generate_beam(jm, params, jn.asarray(prompt),
                                      num_new),
             lambda: ttf.generate_beam(tm, prompt, num_new, device="cpu"))
    jp, pp, tp = paged
    both(lambda: jt.generate_beam(jp, pp, jn.asarray(p4), 3),
         lambda: ttf.generate_beam(tp, p4, 3, device="cpu"))
    jq, pq, tq = pooled
    both(lambda: jt.generate(jq, pq, jn.asarray(p4), 3),
         lambda: ttf.generate(tq, p4, 3, device="cpu"))
    for target, draft in ((pooled, dense), (dense, pooled)):
        both(lambda: jt.generate_speculative(
                target[0], target[1], draft[0], draft[1], jn.asarray(p4), 3),
             lambda: ttf.generate_speculative(target[2], draft[2], p4, 3,
                                              device="cpu"))
    both(lambda: jt.generate_speculative(jm, params, jm, params,
                                         jn.asarray(p4), 56, k=4),
         lambda: ttf.generate_speculative(tm, tm, p4, 56, k=4, device="cpu"))
