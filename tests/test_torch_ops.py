"""The port's ops against the JAX reference on the CPU: the int8 codec
bit for bit, the LayerNorm's plain version against the Pallas kernel
(interpret mode) and the reference, and the paged decode attention's
plain version against the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.ops import layernorm as jln
from vtpu.ops import paged_attention as jpa
from vtpu.ops import quant as jquant
from vtpu_torch.ops import layernorm as tln
from vtpu_torch.ops import paged_attention as tpa
from vtpu_torch.ops import quant as tquant


@pytest.mark.parametrize("shape,axis", [((64, 48), 1), ((3, 5, 7, 16), -1),
                                        ((40, 8), 0)])
def test_quantize_int8_bit_identical(shape, axis):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    # zero vectors (scale 1.0) and exact ties between two levels
    x.reshape(-1, shape[-1])[0] = 0.0
    t = x.reshape(-1, shape[-1])[1]
    t[:] = 1.0
    t[0] = 127.0
    t[1:6] = [0.5, 1.5, 2.5, -0.5, -126.5]
    want = jquant.quantize_int8(jnp.asarray(x), axis=axis)
    got = tquant.quantize_int8(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    deq = tquant.dequantize(got, torch.float32).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jquant.dequantize(want, jnp.float32)))


@pytest.mark.parametrize("rows", [8, 256, 512, 37, 300])
def test_layernorm_plain_matches_jax(rows):
    """256-divisible (and <= 256) rows take the Pallas kernel in
    interpret mode on the JAX side, ragged ones its plain XLA path; the
    port has one plain version for both."""
    rng = np.random.default_rng(rows)
    d = 128
    x = (rng.standard_normal((rows, d)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(d).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(jln.fused_layernorm(jnp.asarray(x), jnp.asarray(g),
                                          jnp.asarray(b)))
    got = tln.fused_layernorm(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ref = np.asarray(jln._reference_ln(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), 1e-6))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows", [8, 37])
def test_layernorm_grad_matches_jax(rows):
    """The backward (the reference's VJP on both sides) for x, gamma and
    beta, f32, 1e-5 abs."""
    import jax

    rng = np.random.default_rng(100 + rows)
    d = 64
    x = (rng.standard_normal((2, rows, d)) * 3 + 1).astype(np.float32)
    g, b, ct = (rng.standard_normal(s).astype(np.float32)
                for s in (d, d, (2, rows, d)))
    want = jax.grad(
        lambda a, gg, bb: jnp.sum(jln.fused_layernorm(a, gg, bb) * ct),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, g, b)]
    (tln.fused_layernorm(*ts) * torch.from_numpy(ct)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_layernorm_bf16_plain_is_f32_math():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    g = torch.ones(64)
    b = torch.zeros(64)
    got = tln.fused_layernorm(x.bfloat16(), g.bfloat16(), b.bfloat16())
    assert got.dtype == torch.bfloat16
    want = tln._reference_ln(x.bfloat16().float(), g, b).bfloat16()
    assert torch.equal(got, want)


def _paged_inputs(g: int, quant: bool, seed: int):
    rng = np.random.default_rng(seed)
    b, n_kv, hd, bs, nb_max = 5, 2, 32, 8, 4
    n_heads = n_kv * g
    P = 1 + b * nb_max
    q = rng.standard_normal((b, n_heads, hd)).astype(np.float32)
    # shuffled physical blocks; rows own disjoint blocks
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tables = perm.reshape(b, nb_max)
    # 0, a block edge, inside, the last slot, and an overshoot row
    lengths = np.array([0, bs, bs * 2 + 3, nb_max * bs - 1,
                        nb_max * bs + 5], np.int32)
    kv = {}
    if quant:
        for n in ("k", "v"):
            kv[n] = rng.integers(-127, 128, (P, n_kv, bs, hd)).astype(np.int8)
            kv[n + "s"] = rng.uniform(0.001, 0.05, (P, n_kv, bs, 1)).astype(
                np.float32)
    else:
        for n in ("k", "v"):
            kv[n] = rng.standard_normal((P, n_kv, bs, hd)).astype(np.float32)
    return q, tables, lengths, kv


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_attention_plain_matches_pallas(g, quant):
    q, tables, lengths, kv = _paged_inputs(g, quant, seed=10 * g + quant)
    scales_j = ((jnp.asarray(kv["ks"]), jnp.asarray(kv["vs"])) if quant
                else (None, None))
    # the Pallas kernel's walk indexes the table by the logical block,
    # so the overshoot row reads every block it owns, as the port does
    want = np.asarray(jpa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kv["k"]), jnp.asarray(kv["v"]),
        jnp.asarray(tables), jnp.asarray(lengths), *scales_j,
        interpret=True))
    scales_t = ((torch.from_numpy(kv["ks"]), torch.from_numpy(kv["vs"]))
                if quant else (None, None))
    args = (torch.from_numpy(q), torch.from_numpy(kv["k"]),
            torch.from_numpy(kv["v"]), torch.from_numpy(tables),
            torch.from_numpy(lengths), *scales_t)
    got = tpa.paged_attention_decode(*args).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    ref = tpa.paged_attention_reference(*args).numpy()
    np.testing.assert_array_equal(got, ref)  # CPU: the wrapper IS the plain
    if not quant:
        want_ref = np.asarray(jpa.paged_attention_reference(
            jnp.asarray(q), jnp.asarray(kv["k"]), jnp.asarray(kv["v"]),
            jnp.asarray(tables), jnp.asarray(lengths)))
        np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=2e-5)


def test_paged_attention_wrapper_counts_only_kernel_launches():
    q, tables, lengths, kv = _paged_inputs(2, False, seed=3)
    before = dict(tpa.paged_attention_decode.launches)
    tpa.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(kv["k"]),
        torch.from_numpy(kv["v"]), torch.from_numpy(tables),
        torch.from_numpy(lengths))
    assert tpa.paged_attention_decode.launches == before
    n = tln.fused_layernorm.launches
    tln.fused_layernorm(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    assert tln.fused_layernorm.launches == n
