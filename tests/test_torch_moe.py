"""The port's MoE against the JAX package on the CPU: the routing,
dispatch, combine and aux-loss functions of ``vtpu_torch.parallel.moe``
against ``vtpu.parallel.moe``, and ``TransformerLM(mlp="moe")`` against
flax (full forward, dense and paged decode on native and int8 caches,
the sown load-balance loss, PagedBatcher tokens, a training step and the
capacity knob)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtpu.parallel.moe as jmoe
import vtpu_torch.parallel.moe as tmoe
from test_torch_transformer import _jax_decode, _port_decode
from torch_parity import jax_params, port_of, to_np
from vtpu.models import transformer as jtf
from vtpu.serving.paged import PagedBatcher as JaxPaged
from vtpu_torch.models import transformer as ttf
from vtpu_torch.serving.paged import PagedBatcher

KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32,
          mlp="moe", n_experts=4, moe_top_k=2)


def _data(seed: int, t: int = 24, d: int = 8, h: int = 16, e: int = 4,
          zero_router: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    rw = (np.zeros((d, e), np.float32) if zero_router
          else rng.standard_normal((d, e)).astype(np.float32))
    wi = (rng.standard_normal((e, d, h)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((e, h, d)) * 0.1).astype(np.float32)
    return x, rw, wi, wo


def _both(fn_j, fn_t, arrays):
    return fn_j(*map(jnp.asarray, arrays)), fn_t(*map(torch.from_numpy,
                                                      arrays))


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["random", "tied"])
@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_jax(top_k, renorm, zero_router):
    """Top-k ids and gates; a zero router ties every logit, and both
    packages then take the lowest expert indices."""
    x, rw, _, _ = _data(0, zero_router=zero_router)
    (je, jg), (te, tg) = _both(
        lambda a, b: jmoe._route(a, b, top_k, renorm),
        lambda a, b: tmoe._route(a, b, top_k, renorm), (x, rw))
    np.testing.assert_array_equal(to_np(te), np.asarray(je))
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), atol=1e-6)
    if zero_router:
        assert set(to_np(te).tolist()) == set(range(top_k))


@pytest.mark.parametrize("capacity", [3, 48], ids=["overflow", "roomy"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_and_combine_match_jax(top_k, capacity):
    """The send buffer (dropped slots accumulate a zero at (0, 0), so
    expert 0's first real slot keeps its token), the slot indices and
    the combined output."""
    x, rw, wi, wo = _data(1)
    t, d = x.shape
    ef_j, gate_j = jmoe._route(jnp.asarray(x), jnp.asarray(rw), top_k, False)
    ef_t, gate_t = tmoe._route(torch.from_numpy(x), torch.from_numpy(rw),
                               top_k, False)
    js = jmoe._dispatch(jnp.asarray(x), ef_j, 4, capacity, top_k)
    ts = tmoe._dispatch(torch.from_numpy(x), ef_t, 4, capacity, top_k)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    if capacity == 3:
        assert not bool(ts[3].all())  # some slot really dropped
    back = np.random.default_rng(2).standard_normal(
        (4, capacity, d)).astype(np.float32)
    jo = jmoe._combine(jnp.asarray(back), *js[1:], gate_j, t, top_k, d)
    to = tmoe._combine(torch.from_numpy(back), *ts[1:], gate_t, t, top_k, d)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=1e-6)


@pytest.mark.parametrize("capacity", [0, 3], ids=["lossless", "overflow"])
@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_local_matches_jax(top_k, renorm, capacity):
    x, rw, wi, wo = _data(3)
    (jo, (jl, jef)), (to, (tl, tef)) = _both(
        lambda *a: jmoe.moe_ffn_local(*a, capacity=capacity, top_k=top_k,
                                      renormalize=renorm, return_aux=True),
        lambda *a: tmoe.moe_ffn_local(*a, capacity=capacity, top_k=top_k,
                                      renormalize=renorm, return_aux=True),
        (x, rw, wi, wo))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-5)
    np.testing.assert_array_equal(to_np(tef), np.asarray(jef))
    # the same routing gives the same aux loss
    np.testing.assert_allclose(
        float(tmoe.load_balance_loss(tl, tef, 4)),
        float(jmoe.load_balance_loss(jl, jef, 4)), atol=1e-6)


def test_overflow_drops_to_zero_like_jax():
    """Every token routed to expert 0 with capacity 1: one token keeps
    its update, the rest fall through with zero."""
    t, d = 8, 4
    x = np.ones((t, d), np.float32)
    rw = np.zeros((d, 4), np.float32)
    rw[:, 0] = 1.0
    wi = np.full((4, d, 4), 0.1, np.float32)
    wo = np.full((4, 4, d), 0.1, np.float32)
    jo, to = _both(lambda *a: jmoe.moe_ffn_local(*a, capacity=1),
                   lambda *a: tmoe.moe_ffn_local(*a, capacity=1),
                   (x, rw, wi, wo))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=1e-6)
    assert int((np.abs(to_np(to)).sum(-1) > 0).sum()) == 1


def test_load_balance_loss_matches_jax():
    """Uniform routing scores ~1, collapsed routing ~n_exp, and random
    logits with top-2 ids agree with the reference."""
    t, e = 64, 8
    ids_u = np.tile(np.arange(e), t // e)
    collapsed = np.zeros((t, e), np.float32)
    collapsed[:, 0] = 10.0
    cases = [(np.zeros((t, e), np.float32), ids_u),
             (collapsed, np.zeros((t,), np.int64)),
             (np.random.default_rng(4).standard_normal((t, e))
              .astype(np.float32),
              np.random.default_rng(5).integers(0, e, (t * 2,)))]
    for logits, ids in cases:
        j = jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(ids), e)
        p = tmoe.load_balance_loss(torch.from_numpy(logits),
                                   torch.from_numpy(ids), e)
        assert abs(float(p) - float(j)) <= 1e-6 * max(1.0, abs(float(j)))
    assert abs(float(tmoe.load_balance_loss(
        torch.zeros((t, e)), torch.from_numpy(ids_u), e)) - 1.0) < 1e-6


def test_argument_errors_match_jax():
    x, rw, wi, wo = _data(6)
    for kw, match in ((dict(top_k=5), "top_k"), (dict(top_k=0), "top_k")):
        with pytest.raises(ValueError, match=match):
            jmoe.moe_ffn_local(*map(jnp.asarray, (x, rw, wi, wo)), **kw)
        with pytest.raises(ValueError, match=match):
            tmoe.moe_ffn_local(*map(torch.from_numpy, (x, rw, wi, wo)), **kw)
    bad = np.zeros((x.shape[1], 3), np.float32)
    with pytest.raises(ValueError, match="router_w maps to 3"):
        tmoe.moe_ffn_local(*map(torch.from_numpy, (x, bad, wi, wo)))


# -- the MoE TransformerLM ---------------------------------------------------
@pytest.fixture(scope="module")
def moe_lm():
    jm = jtf.TransformerLM(**KW)
    params = jax_params(jm)
    return jm, params


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_moe_model_builds_and_converts(moe_lm):
    jm, params = moe_lm
    tm = port_of(jm, params)
    assert tuple(tm.h[0].moe.w_in.shape) == (4, 32, 128)
    assert tuple(tm.h[0].moe.router.shape) == (32, 4)
    assert not hasattr(tm.h[0], "mlp_in")
    np.testing.assert_array_equal(to_np(tm.h[1].moe.w_out),
                                  np.asarray(params["h1"]["moe"]["w_out"]))


def test_full_forward_logits_and_aux_loss_match_flax(moe_lm):
    jm, params = moe_lm
    tm = port_of(jm, params)
    toks = np.random.default_rng(8).integers(0, 64, (2, 12)).astype(np.int32)
    want, inter = jm.apply({"params": params}, jnp.asarray(toks),
                           mutable=["intermediates"])
    aux = []
    got = tm(torch.from_numpy(toks), decode=False, aux=aux)
    assert _rel_err(to_np(got), np.asarray(want)) <= 1e-5
    sown = [float(v) for v in jax.tree.leaves(inter["intermediates"])]
    assert len(aux) == len(sown) == 2
    for a, b in zip(aux, sown):
        assert abs(float(a) - b) <= 1e-6


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_logits_match_flax(moe_lm, layout, cache_dtype):
    """Bucketed prefill then one-token steps, the same weights under
    each cache layout and dtype (paged: the kernel's wrapper, its plain
    version on the CPU)."""
    jm0, params = moe_lm
    knobs = dict(kv_cache_layout=layout, kv_cache_dtype=cache_dtype)
    if layout == "paged":
        knobs.update(kv_block_size=8, paged_kernel="on")
    jm = jm0.clone(**knobs)
    tm = port_of(jm, params)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 64, (2, 5)).astype(np.int32)
    steps = rng.integers(0, 64, (2, 6)).astype(np.int32)
    want = _jax_decode(jm, params, prompt, 8, steps)
    got = _port_decode(tm, prompt, 8, steps)
    assert _rel_err(got, want) <= 1e-5


def test_paged_batcher_tokens_match_jax(moe_lm):
    jm0, params = moe_lm
    jm = jm0.clone(kv_cache_layout="paged", kv_block_size=8,
                   kv_pool_blocks=17)
    tm = port_of(jm, params)
    rng = np.random.default_rng(10)
    reqs = [(f"r{i}", rng.integers(0, 64, int(rng.integers(3, 12)))
             .astype(np.int32), int(rng.integers(3, 7))) for i in range(5)]

    def run(eng):
        for rid, p, n in reqs:
            eng.submit(rid, p, num_new=n)
        return eng.run()

    teng = PagedBatcher(tm, max_batch=3, device="cpu")
    want = run(JaxPaged(jm, params, max_batch=3))
    got = run(teng)
    assert got == want
    assert all(len(got[rid]) == n for rid, _p, n in reqs)
    assert teng.pool_stats()["leased"] == 0


def test_training_step_matches_jax_and_reduces_loss(moe_lm):
    """The loss and every gradient of the first step against
    ``jax.value_and_grad``; eight Adam steps reduce the loss."""
    jm, params = moe_lm
    tm = port_of(jm, params)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         64)).astype(np.int32)
    jt = jnp.asarray(toks)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(jm.apply({"params": p}, jt), jt))(params)
    tt = torch.from_numpy(toks)
    loss = ttf.lm_loss(tm(tt, decode=False), tt)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5
    for i in range(2):
        for leaf in ("router", "w_in", "w_out"):
            g = to_np(getattr(tm.h[i].moe, leaf).grad)
            want = np.asarray(jg[f"h{i}"]["moe"][leaf])
            assert np.abs(g - want).max() <= 1e-4 * max(
                np.abs(want).max(), 1e-12)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    losses = []
    for _ in range(8):
        opt.zero_grad()
        step = ttf.lm_loss(tm(tt, decode=False), tt)
        step.backward()
        opt.step()
        losses.append(float(step))
    assert losses[-1] < losses[0], losses


def test_moe_capacity_reaches_the_blocks(moe_lm):
    """``moe_capacity`` reaches every block (a capped model drops slots
    and differs from the lossless one) and matches flax's capped
    model."""
    jm0, params = moe_lm
    capped = jm0.clone(moe_capacity=4, depth=2)
    tm = port_of(capped, params)
    assert all(blk.moe.capacity == 4 for blk in tm.h)
    toks = np.random.default_rng(11).integers(0, 64, (2, 12)).astype(
        np.int32)
    want = np.asarray(capped.apply({"params": params}, jnp.asarray(toks)))
    got = to_np(tm(torch.from_numpy(toks), decode=False))
    assert _rel_err(got, want) <= 1e-5
    lossless = to_np(port_of(jm0, params)(torch.from_numpy(toks),
                                          decode=False))
    assert np.abs(lossless - got).max() > 1e-3
