"""The port's TransformerLM (paged decode path) against the flax model on
the CPU: weight conversion, decode logits over the knob matrix, greedy
generate, and the same errors for bad knobs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_params, port_of, to_np
from vtpu.models import transformer as jtf
from vtpu_torch.models import transformer as ttf
from vtpu_torch.models.convert import params_from_flax

KW = dict(vocab=64, d_model=64, depth=2, num_heads=4, max_seq=64,
          kv_cache_layout="paged", kv_block_size=8)


def test_params_from_flax_round_trip():
    jm = jtf.TransformerLM(**KW, num_kv_heads=2)
    params = jax.device_get(jax_params(jm))
    sd = params_from_flax(params, device="cpu")
    model = port_of(jm, params)
    assert set(sd) == set(model.state_dict())
    back = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "h":
            parts = [f"h{parts[1]}"] + parts[2:]
        leaf = parts.pop()
        key = {"weight": "kernel"}.get(leaf, leaf)
        if parts[-1] in ("wte", "wpe"):
            key = "embedding"
        arr = t.numpy()
        if key == "kernel":
            arr = arr.T  # nn.Linear weight is the flax kernel transposed
        node = back
        for p in parts:
            node = node.setdefault(p, {})
        node[key] = arr
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))
    bf = params_from_flax(params, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf.values())


def _jax_decode(jm, params, prompt, bucket, steps):
    """Bucketed prefill (right-padded, counter rewound to the true
    length) then one-token steps on the given tokens; logits per step."""
    b, s = prompt.shape
    cache = jtf._zero_cache(jm, jnp.asarray(prompt))
    padded = np.zeros((b, bucket), np.int32)
    padded[:, :s] = prompt
    logits, mut = jm.apply({"params": params, "cache": cache},
                           jnp.asarray(padded), decode=True,
                           mutable=["cache"])
    out = [np.asarray(logits[:, s - 1])]
    cache = jtf.set_cache_pos(mut["cache"], s)
    for tok in steps.T:
        logits, mut = jm.apply({"params": params, "cache": cache},
                               jnp.asarray(tok[:, None]), decode=True,
                               mutable=["cache"])
        cache = mut["cache"]
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out)


def _port_decode(tm, prompt, bucket, steps):
    b, s = prompt.shape
    cache = tm.init_cache(b)
    padded = np.zeros((b, bucket), np.int32)
    padded[:, :s] = prompt
    logits = tm(torch.from_numpy(padded), cache)
    out = [to_np(logits[:, s - 1])]
    ttf.set_cache_pos(cache, s)
    for tok in steps.T:
        out.append(to_np(tm(torch.from_numpy(tok[:, None].copy()),
                            cache)[:, -1]))
    return np.stack(out)


@pytest.mark.parametrize("kernel", ["on", "off"])
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("n_kv", [0, 2], ids=["mha", "gqa"])
def test_paged_decode_logits_match_jax(n_kv, pos, cache_dtype, kernel):
    jm = jtf.TransformerLM(**KW, num_kv_heads=n_kv, pos_embedding=pos,
                           kv_cache_dtype=cache_dtype, paged_kernel=kernel)
    params = jax_params(jm)
    tm = port_of(jm, params)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 64, (2, 5)).astype(np.int32)
    steps = rng.integers(0, 64, (2, 6)).astype(np.int32)
    want = _jax_decode(jm, params, prompt, 8, steps)
    got = _port_decode(tm, prompt, 8, steps)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
@pytest.mark.parametrize("n_kv", [0, 2], ids=["mha", "gqa"])
def test_sliding_window_decode_matches_jax(n_kv, cache_dtype):
    """attn_window masks the gather path's keys to the last W positions
    (prefill and steps both cross the window)."""
    jm = jtf.TransformerLM(**KW, num_kv_heads=n_kv, pos_embedding="rope",
                           attn_window=4, kv_cache_dtype=cache_dtype,
                           paged_kernel="off")
    params = jax_params(jm)
    tm = port_of(jm, params)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 64, (2, 6)).astype(np.int32)
    steps = rng.integers(0, 64, (2, 6)).astype(np.int32)
    want = _jax_decode(jm, params, prompt, 8, steps)
    got = _port_decode(tm, prompt, 8, steps)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # "auto" serves a windowed model through the gather path too
    auto = _port_decode(tm.clone(paged_kernel="auto"), prompt, 8, steps)
    np.testing.assert_allclose(auto, want, atol=1e-4, rtol=0)


def test_decode_without_a_cache_raises():
    m = ttf.TransformerLM(**KW, device="cpu")
    with pytest.raises(ValueError, match="cache"):
        m(torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("cfg", [
    dict(num_kv_heads=0, pos_embedding="learned", paged_kernel="on"),
    dict(num_kv_heads=2, pos_embedding="rope", kv_cache_dtype="int8",
         paged_kernel="on"),
], ids=["mha-learned", "gqa-rope-int8"])
def test_generate_greedy_matches_jax(cfg):
    jm = jtf.TransformerLM(**KW, **cfg)
    params = jax_params(jm)
    tm = port_of(jm, params)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 7)).astype(
        np.int32)
    want = np.asarray(jtf.generate(jm, params, jnp.asarray(prompt),
                                   num_new=10, prefill_chunk=3, eos_id=5))
    got = ttf.generate(tm, prompt, num_new=10, prefill_chunk=3, eos_id=5,
                       device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


BAD_KNOBS = [
    dict(pos_embedding="alibi"),
    dict(mlp="sparse"),
    dict(kv_cache_dtype="fp8"),
    dict(kv_cache_layout="ring"),
    dict(paged_kernel="On"),
    dict(attn_window=8, paged_kernel="on"),
    dict(kv_block_size=7),
]


@pytest.mark.parametrize("bad", BAD_KNOBS,
                         ids=[next(iter(b)) for b in BAD_KNOBS])
def test_bad_knobs_raise_the_same_value_error(bad):
    kw = dict(KW, **bad)
    with pytest.raises(ValueError) as want:
        jtf.TransformerLM(**kw).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 4), jnp.int32),
                                     decode=True)
    with pytest.raises(ValueError) as got:
        ttf.TransformerLM(**kw, device="cpu")
    assert str(got.value) == str(want.value)


def test_generate_errors_match_jax():
    pooled = jtf.TransformerLM(**KW, kv_pool_blocks=9)
    params = jax_params(pooled)
    cases = [(pooled, np.zeros((1, 4), np.int32), 0),
             (pooled, np.zeros((1, 4), np.int32), 2),
             (jtf.TransformerLM(**KW), np.zeros((1, 60), np.int32), 8)]
    for jm, prompt, num_new in cases:
        with pytest.raises(ValueError) as want:
            jtf.generate(jm, params, jnp.asarray(prompt), num_new=num_new)
        with pytest.raises(ValueError) as got:
            ttf.generate(port_of(jm, params), prompt, num_new=num_new,
                         device="cpu")
        # the port names its own engine where the reference names vtpu's
        assert str(got.value).replace("vtpu_torch.", "vtpu.") == str(
            want.value)


@pytest.mark.parametrize("what", ["moe"])
def test_deferred_paths_raise_not_implemented(what):
    """MoE was the last deferred path: it now builds (and converts from
    flax) instead of raising; an unknown mlp still raises the
    reference's ValueError."""
    kw = dict(KW)
    m = ttf.TransformerLM(**kw, mlp=what, device="cpu")
    assert all(hasattr(blk, what) for blk in m.h)
    jm = jtf.TransformerLM(**kw, mlp=what)
    port_of(jm, jax_params(jm))
    with pytest.raises(ValueError, match="mlp must be"):
        ttf.TransformerLM(**kw, mlp="sparse", device="cpu")


def test_clone_shares_weights_and_validates():
    m = ttf.TransformerLM(**KW, device="cpu")
    c = m.clone(kv_cache_dtype="int8", kv_pool_blocks=9, paged_kernel="off")
    assert c.wte.weight is m.wte.weight
    assert m.kv_cache_dtype == "native" and c.kv_cache_dtype == "int8"
    assert c.init_cache(2)["layers"][0]["k_pool"].dtype == torch.int8
    with pytest.raises(ValueError, match="paged_kernel"):
        m.clone(paged_kernel="yes")
    assert m.clone(flash_kernel="off").flash_kernel == "off"
    with pytest.raises(ValueError, match="flash_kernel"):
        m.clone(flash_kernel="on")
    with pytest.raises(TypeError):
        m.clone(d_model=32)


def test_bucket_length_matches_jax():
    for n in (1, 2, 3, 5, 8, 9, 63, 64, 65, 1000):
        assert ttf.bucket_length(n, 64) == jtf.bucket_length(n, 64)
