"""Weight-only int8 trees in the port against ``vtpu.ops.quant`` on the
CPU: ``quantize_tree`` selects the same leaves with equal levels and
bit-equal scales, ``tree_bytes`` counts the same, ``params_from_flax``
carries a quantized flax tree (dense and MoE) into the port, the
int8-weight forward gives the JAX logits on ``dequantize_tree(qparams)``
(bf16, the engines' rule), and the dense ``ContinuousBatcher``, the
``PagedBatcher`` on both pools and a JAX prefill into a torch decode
engine serve int8 weights token for token as the JAX engines do.  The
quantized ``Linear`` builds no f32 copy of its weight.

The ``cuda``-marked cases hold the card's levels, scales and one-pass
dequantize against the CPU's and the three-op formula
(``python -m pytest tests/test_torch_quant_tree.py -m cuda``).

Each case caps torch's intra-op threads at 2 (the tier-1 run shares the
machine's cores among its workers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_transformer import _port_decode
from torch_parity import KNOBS, port_of, to_np
from vtpu.models import transformer as jtf
from vtpu.ops import quant as jq
from vtpu_torch.models.convert import params_from_flax
from vtpu_torch.models.transformer import QuantLinear
from vtpu_torch.models.transformer import TransformerLM as TorchLM
from vtpu_torch.ops import quant as tq
from vtpu_torch.serving.batcher import ContinuousBatcher
from vtpu_torch.serving.paged import PagedBatcher

# tests/test_quant.py's two models
SELECT_KW = dict(vocab=512, d_model=128, depth=2, num_heads=4, max_seq=32)
SERVE_KW = dict(vocab=128, d_model=64, depth=2, num_heads=4, max_seq=32)
PAGED = dict(kv_cache_layout="paged", kv_block_size=8, kv_pool_blocks=9)
MOE_KW = dict(vocab=64, d_model=32, depth=2, num_heads=4, max_seq=32,
              mlp="moe", n_experts=4, moe_top_k=2)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init(jm):
    """Seeded flax params (jitted: one compile instead of one per op)."""
    return jax.jit(jm.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]


def _jax_logits(jm, qparams, toks) -> np.ndarray:
    """The full forward on ``dequantize_tree(qparams)`` (bf16), jitted
    as the engines run it."""
    fn = jax.jit(lambda qp, t: jm.apply({"params": jq.dequantize_tree(qp)},
                                        t))
    return np.asarray(fn(qparams, jnp.asarray(toks)))


def _jax_decode(jm, qparams, prompt, bucket, steps) -> np.ndarray:
    """Bucketed prefill (the counter rewound to the true length), then
    one-token steps on ``steps``; each step's logits (jitted)."""
    @jax.jit
    def fwd(qp, cache, toks):
        logits, mut = jm.apply({"params": jq.dequantize_tree(qp),
                                "cache": cache}, toks, decode=True,
                               mutable=["cache"])
        return logits, mut["cache"]

    b, s = prompt.shape
    padded = np.zeros((b, bucket), np.int32)
    padded[:, :s] = prompt
    logits, cache = fwd(qparams, jtf._zero_cache(jm, jnp.asarray(prompt)),
                        jnp.asarray(padded))
    out = [np.asarray(logits[:, s - 1])]
    cache = jtf.set_cache_pos(cache, s)
    for tok in steps.T:
        logits, cache = fwd(qparams, cache, jnp.asarray(tok[:, None]))
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out)


def _converted(qparams) -> dict:
    return params_from_flax(jax.device_get(qparams), device="cpu")


def _same_quantized(got: dict, want: dict) -> None:
    """Same quantized names, equal levels, bit-equal scales, same axes."""
    assert ({n for n, v in got.items() if tq.is_quantized(v)}
            == {n for n, v in want.items() if tq.is_quantized(v)})
    for name, w in want.items():
        g = got[name]
        if tq.is_quantized(w):
            assert g.axis == w.axis, name
            assert torch.equal(g.q, w.q), name
            assert torch.equal(g.scale.view(torch.int32),
                               w.scale.view(torch.int32)), name
        else:
            assert torch.equal(g, w), name


# -- selection and bytes -----------------------------------------------------
@pytest.fixture(scope="module")
def select_model():
    jm = jtf.TransformerLM(**SELECT_KW)
    params = _init(jm)
    return params, jq.quantize_tree(params, min_elems=16384)


def test_selection_levels_and_bytes_match_jax(select_model):
    params, qparams = select_model
    sd = params_from_flax(jax.device_get(params), device="cpu")
    got = tq.quantize_tree(sd, min_elems=16384)
    _same_quantized(got, _converted(qparams))
    picked = {n for n, v in got.items() if tq.is_quantized(v)}
    assert picked == {f"h.{i}.{m}.weight" for i in range(2)
                      for m in ("attn.qkv", "attn.out", "mlp_in", "mlp_out")
                      } | {"lm_head.weight"}
    # the tables clear the bar and stay float
    assert got["wte.weight"].numel() >= 16384
    assert not tq.is_quantized(got["wte.weight"])
    assert not tq.is_quantized(got["wpe.weight"])
    # one scale per output channel of the [out, in] weight
    assert tuple(got["h.0.mlp_in.weight"].scale.shape) == (512, 1)
    assert tq.tree_bytes(got) == jq.tree_bytes(qparams)
    assert tq.tree_bytes(got) < 0.45 * tq.tree_bytes(sd)


def test_dequantize_tree_keeps_the_structure(select_model):
    params, qparams = select_model
    sd = params_from_flax(jax.device_get(params), device="cpu")
    qsd = tq.quantize_tree(sd, min_elems=16384)
    jback = _converted(jq.dequantize_tree(qparams, jnp.float32))
    for dtype in (torch.float32, torch.bfloat16):
        back = tq.dequantize_tree(qsd, dtype)
        assert list(back) == list(sd)
        for name, t in back.items():
            assert t.shape == sd[name].shape, name
            want = dtype if tq.is_quantized(qsd[name]) else sd[name].dtype
            assert t.dtype == want, name
    back = tq.dequantize_tree(qsd, torch.float32)
    for name, t in back.items():
        assert torch.equal(t, jback[name]), name


# the hand-built trees of tests/test_quant.py and more names under the
# same rule: the leaf name decides, and a wte/wpe component anywhere
NAMES = ["embed_proj.kernel", "embed.embeddings", "tok_embeddings.weight",
         "embed_proj.weight", "wte.embedding", "blocks.wpe.kernel",
         "model.embedding_out.w", "mlp.kernel", "mlp.weight"]


@pytest.mark.parametrize("name", NAMES)
def test_hand_built_names_follow_the_reference_rule(name):
    w = np.random.default_rng(0).standard_normal((256, 128)).astype(
        np.float32)
    tree = w
    for part in reversed(name.split(".")):
        tree = {part: tree}
    jtree = jq.quantize_tree(jax.tree.map(jnp.asarray, tree), min_elems=1024)
    leaf = jtree
    for part in name.split("."):
        leaf = leaf[part]
    got = tq.quantize_tree({name: torch.from_numpy(w)}, min_elems=1024)[name]
    assert tq.is_quantized(got) == jq.is_quantized(leaf)
    if jq.is_quantized(leaf) and not name.endswith(".weight"):
        # a flax-layout leaf: the same levels and scales as they stand
        assert np.array_equal(to_np(got.q), np.asarray(leaf.q))
        assert np.array_equal(to_np(got.scale).view(np.int32),
                              np.asarray(leaf.scale).view(np.int32))
    if name.endswith(".weight") and tq.is_quantized(got):
        # an nn.Linear weight [out, in]: its transpose's levels
        want = jq.quantize_int8(jnp.asarray(w.T), axis=0)
        assert np.array_equal(to_np(got.q), np.asarray(want.q).T)
        assert tuple(got.scale.shape) == (256, 1)


def test_small_and_non_float_leaves_stay():
    tree = {"a.kernel": torch.ones(64, 64), "b.kernel": torch.ones(16384),
            "c.kernel": torch.ones(128, 128, dtype=torch.int32),
            "d.kernel": torch.ones(128, 128)}
    got = tq.quantize_tree(tree, min_elems=16384)
    assert [tq.is_quantized(v) for v in got.values()] == [False, False,
                                                          False, True]
    assert tq.tree_bytes(got) == (64 * 64 * 4 + 16384 * 4 + 128 * 128 * 4
                                  + 128 * 128 + 128 * 4)


# -- logits --------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_model():
    jm = jtf.TransformerLM(**SERVE_KW)
    params = _init(jm)
    return jm, params, jq.quantize_tree(params, min_elems=4096)


def _port_quantized(jm, qparams, **override) -> TorchLM:
    cfg = {k: getattr(jm, k) for k in KNOBS}
    cfg.update(override)
    return TorchLM(**cfg, device="cpu").load_quantized(_converted(qparams))


def test_quantize_weights_equals_the_converted_tree(serve_model):
    jm, params, qparams = serve_model
    base = port_of(jm, params)
    tm = base.quantize_weights(min_elems=4096)
    got = dict(tm.state_dict())
    want = _port_quantized(jm, qparams).state_dict()
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # the source model keeps its float weights; the rest is shared
    assert isinstance(base.lm_head, torch.nn.Linear)
    assert isinstance(tm.lm_head, QuantLinear)
    assert tm.wte.weight is base.wte.weight
    assert tm.h[0].ln1.scale is base.h[0].ln1.scale


def test_full_forward_logits_match_jax(serve_model):
    jm, _params, qparams = serve_model
    toks = np.random.default_rng(1).integers(0, 128, (2, 8)).astype(np.int32)
    want = _jax_logits(jm, qparams, toks)
    got = to_np(_port_quantized(jm, qparams)(torch.from_numpy(toks),
                                             decode=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_logits_match_jax(serve_model, layout, cache_dtype):
    jm0, _params, qparams = serve_model
    knobs = dict(kv_cache_layout=layout, kv_cache_dtype=cache_dtype)
    if layout == "paged":
        knobs.update(kv_block_size=8, paged_kernel="on")
    jm = jm0.clone(**knobs)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 128, (2, 5)).astype(np.int32)
    steps = rng.integers(0, 128, (2, 6)).astype(np.int32)
    want = _jax_decode(jm, qparams, prompt, 8, steps)
    got = _port_decode(_port_quantized(jm, qparams), prompt, 8, steps)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# -- engines, on tests/test_quant.py's case ----------------------------------
def _prompts():
    toks = np.random.default_rng(3).integers(0, 128, (2, 8)).astype(np.int32)
    return [("a", toks[0, :5], 5), ("b", toks[1, :4], 5)]


@pytest.fixture(scope="module")
def jax_paged_tokens(serve_model):
    """The JAX PagedBatcher's tokens per pool, computed once a pool."""
    from vtpu.serving.paged import PagedBatcher as JaxPaged

    jm0, _params, qparams = serve_model
    memo = {}

    def tokens(pool):
        if pool not in memo:
            jm = jm0.clone(**PAGED, kv_cache_dtype=pool)
            memo[pool] = _serve(JaxPaged(jm, qparams, max_batch=2),
                                _prompts())
        return memo[pool]

    return tokens


def _serve(eng, reqs) -> dict:
    for rid, p, n in reqs:
        eng.submit(rid, p, num_new=n)
    return eng.run()


def _solo(tm, reqs) -> dict:
    from vtpu_torch.models.transformer import generate

    solo = tm.clone(kv_pool_blocks=0) if tm.kv_cache_layout == "paged" else tm
    return {rid: generate(solo, p[None], n, device="cpu")[0].tolist()
            for rid, p, n in reqs}


def test_dense_batcher_token_exact_against_jax(serve_model):
    from vtpu.serving import ContinuousBatcher as JaxBatcher

    jm, _params, qparams = serve_model
    reqs = _prompts()
    want = _serve(JaxBatcher(jm, qparams, max_batch=2), reqs)
    tm = _port_quantized(jm, qparams)
    got = _serve(ContinuousBatcher(tm, 2, device="cpu"), reqs)
    assert got == want
    assert got == _solo(tm, reqs)


@pytest.mark.parametrize("pool", ["native", "int8"])
def test_paged_batcher_token_exact_against_jax(serve_model, pool,
                                              jax_paged_tokens):
    jm0, _params, qparams = serve_model
    jm = jm0.clone(**PAGED, kv_cache_dtype=pool)
    reqs = _prompts()
    want = jax_paged_tokens(pool)
    tm = _port_quantized(jm, qparams)
    eng = PagedBatcher(tm, 2, device="cpu")
    got = _serve(eng, reqs)
    assert got == want
    assert got == _solo(tm, reqs)
    assert eng.pool_stats()["leased"] == 0


def test_jax_prefill_to_torch_decode_with_int8_weights(serve_model,
                                                      jax_paged_tokens):
    """A JAX PrefillEngine streams K/V (fp32 wire, loopback) into a torch
    DecodeEngine booted from gang annotations (``colo.boot_role_engine``)
    on the same int8 weights: the JAX monolithic engine's tokens."""
    import json

    from vtpu.serving import transport as jtp
    from vtpu.serving.disagg import PrefillEngine as JaxPrefill
    from vtpu_torch.serving import colo
    from vtpu_torch.serving import transport as ttp

    jm0, _params, qparams = serve_model
    jm = jm0.clone(**PAGED)
    reqs = _prompts()
    want = jax_paged_tokens("native")
    tm = _port_quantized(jm, qparams)
    annos = {colo.GANG_PLACEMENT: json.dumps({
        "gang": "default/serve", "role": "decode", "shape": "1x1x1",
        "hosts": 1, "index": 0, "node": "host-1"})}
    _pl, dec = colo.boot_role_engine(annos, tm, max_batch=2,
                                     engine_kw=dict(device="cpu"))
    assert dec.model is tm
    jpf = JaxPrefill(jm, qparams)
    for rid, p, n in reqs:
        jpf.submit(rid, p, num_new=n)
    rep = jtp.WireReplica(jtp.LoopbackLink(ttp.ReceiverHub(dec)), "w0",
                          chunk_blocks=2, codec="fp32")
    for r in jpf.run():
        rep.submit_handle(r.rid, r.handle, r.first_token, r.num_new,
                          source=jpf, admit=False)
    while rep.idle_senders():
        rep.pump_streams()
    while any(dec.active) or dec.queue or dec._inflight:
        dec.step()
    dec._flush_first_tokens()
    assert dec.out == want
    assert dec.pool.stats()["leased"] == 0
    assert jpf.pool.stats()["leased"] == 0


# -- MoE -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_model():
    jm = jtf.TransformerLM(**MOE_KW)
    return jm, _init(jm)


# router [32, 4] = 128 elements, experts [4, 32, 128] = 16384
@pytest.mark.parametrize("min_elems,router_quantized",
                         [(128, True), (1024, False)],
                         ids=["router_above", "router_below"])
def test_moe_tree_converts_and_logits_match_jax(moe_model, min_elems,
                                                router_quantized):
    jm, params = moe_model
    qparams = jq.quantize_tree(params, min_elems=min_elems)
    assert jq.is_quantized(qparams["h0"]["moe"]["router"]) == router_quantized
    assert jq.is_quantized(qparams["h0"]["moe"]["w_in"])
    conv = _converted(qparams)
    got = tq.quantize_tree(params_from_flax(jax.device_get(params),
                                            device="cpu"), min_elems)
    _same_quantized(got, conv)
    w_in = conv["h.0.moe.w_in"]
    assert tuple(w_in.scale.shape) == (4, 1, 128) and w_in.axis == 1
    tm = _port_quantized(jm, qparams)
    moe = tm.h[0].moe
    assert ("router_q" in moe._buffers) == router_quantized
    assert "w_in" not in moe._parameters
    toks = np.random.default_rng(4).integers(0, 64, (2, 12)).astype(np.int32)
    want = _jax_logits(jm, qparams, toks)
    np.testing.assert_allclose(to_np(tm(torch.from_numpy(toks),
                                        decode=False)), want,
                               atol=1e-4, rtol=0)
    # quantize_weights gives the converted tree's levels
    again = port_of(jm, params).quantize_weights(min_elems).state_dict()
    for name, t in tm.state_dict().items():
        assert torch.equal(again[name], t), name


# -- no f32 copy of a weight -----------------------------------------------------
class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append((str(func), [a.dtype for a in ins],
                         [(o.dtype, tuple(o.shape)) for o in outs
                          if isinstance(o, torch.Tensor)]))
        return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_quantized_linear_builds_no_f32_weight_copy(dtype):
    """Every aten op of one quantized Linear forward: the dequantize
    writes bf16 from int8 in one op, and no op returns an f32 tensor of
    the weight's shape, except (f32 model) the cast of that bf16 weight
    to the activations' dtype, which is flax's promotion."""
    w = torch.randn(384, 256, generator=torch.Generator().manual_seed(0))
    lin = QuantLinear(tq.quantize_int8(w, axis=1),
                      torch.nn.Parameter(torch.zeros(384, dtype=dtype)))
    x = torch.randn(3, 256).to(dtype)
    with _OpLog() as log:
        y = lin(x)
    assert y.dtype == dtype and tuple(y.shape) == (3, 384)
    muls = [op for op in log.ops if "mul" in op[0]]
    assert len(muls) == 1
    assert muls[0][1] == [torch.int8, torch.float32]
    assert muls[0][2] == [(torch.bfloat16, (384, 256))]
    f32_weights = [op for op in log.ops
                   if (torch.float32, (384, 256)) in op[2]]
    if dtype == torch.bfloat16:
        assert f32_weights == []
    else:
        assert [(op[0], op[1]) for op in f32_weights] == [
            ("aten._to_copy.default", [torch.bfloat16])]


def test_one_pass_dequantize_equals_three_op_formula():
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(512, 300, generator=gen) * torch.logspace(
        -4, 4, 512)[:, None]
    qt = tq.quantize_int8(w, axis=1)
    one = tq.dequantize_weight(qt.q, qt.scale)
    three = (qt.q.float() * qt.scale).to(torch.bfloat16)
    assert one.dtype == torch.bfloat16
    assert torch.equal(one.view(torch.int16), three.view(torch.int16))
    assert torch.equal(tq.dequantize_weight(qt.q, qt.scale, torch.float32),
                       three.float())


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's quantize and "
                    "dequantize)")
    return torch.device("cuda")


def _full_width_weights():
    """One weight of each quantized shape of the serve configuration
    (d 4096, GQA 32/8, MLP ratio 4, vocab 32000), scaled per row."""
    gen = torch.Generator().manual_seed(2)
    for out_f, in_f in ((4096, 4096), (2048, 4096), (16384, 4096),
                        (4096, 16384), (32000, 4096)):
        yield (torch.randn(out_f, in_f, generator=gen)
               * torch.logspace(-3, 1, out_f)[:, None]).to(torch.bfloat16)


@pytest.mark.cuda
def test_card_levels_and_scales_equal_the_cpu_s(cuda_card):
    for w in _full_width_weights():
        cpu = tq.quantize_tree({"x.weight": w})["x.weight"]
        card = tq.quantize_tree({"x.weight": w.to(cuda_card)})["x.weight"]
        assert torch.equal(card.q.cpu(), cpu.q)
        assert torch.equal(card.scale.cpu().view(torch.int32),
                           cpu.scale.view(torch.int32))


@pytest.mark.cuda
def test_card_one_pass_dequantize_equals_three_op_formula(cuda_card):
    for w in _full_width_weights():
        qt = tq.quantize_int8(w.to(cuda_card), axis=1)
        one = tq.dequantize_weight(qt.q, qt.scale)
        three = (qt.q.float() * qt.scale).to(torch.bfloat16)
        assert torch.equal(one.view(torch.int16), three.view(torch.int16))
