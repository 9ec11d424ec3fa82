"""The port's flash attention against the JAX package's on the CPU.

The JAX side runs its Pallas kernels in interpret mode (forward, dq and
dk/dv), or its XLA reference where it routes there itself (a ragged
length); the port runs its kernels' plain versions inside the same
autograd functions that launch the kernels on the card.  Inputs and
cotangents are numpy-seeded and shared.  Tolerance: 1e-4 abs on o, lse,
dq, dk and dv in f32 (the two sides sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.ops import attention as jat
from vtpu_torch.ops import attention as tat

TOL = 1e-4


def _inputs(seed, q_shape, kv_shape=None, n=3):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or q_shape
    q = rng.standard_normal(q_shape).astype(np.float32)
    k, v = (rng.standard_normal(kv_shape).astype(np.float32)
            for _ in range(2))
    cts = [rng.standard_normal(q_shape).astype(np.float32)
           for _ in range(n - 2)]
    return q, k, v, cts


def _jax_grads(fn, q, k, v, ct):
    def loss(a, b, c):
        return jnp.sum(fn(a, b, c) * ct)

    o = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    return [np.asarray(o)] + [np.asarray(x) for x in g]


def _port_grads(fn, q, k, v, ct):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fn(*ts)
    (o * torch.from_numpy(ct)).sum().backward()
    return [o.detach().numpy()] + [t.grad.numpy() for t in ts]


def _close(got, want, names="o dq dk dv".split()):
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(256, 64), (2, 3, 128, 64)],
                         ids=["2d", "4d"])
def test_flash_attention_and_grads_match_jax(shape, causal):
    q, k, v, (ct,) = _inputs(1, shape)
    want = _jax_grads(lambda a, b, c: jat.flash_attention(a, b, c,
                                                          causal=causal),
                      q, k, v, ct)
    got = _port_grads(lambda a, b, c: tat.flash_attention(a, b, c,
                                                          causal=causal),
                      q, k, v, ct)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_gqa_matches_jax_kernel(causal):
    """Hq 4 over Hkv 2: the JAX side vmaps its Pallas kernel over the
    group (use_kernel=True); the port indexes kv head h // g."""
    q, k, v, (ct,) = _inputs(2, (2, 4, 128, 32), (2, 2, 128, 32))
    want = _jax_grads(lambda a, b, c: jat.flash_attention_gqa(
        a, b, c, causal=causal, use_kernel=True), q, k, v, ct)
    for uk in (None, True, False):
        got = _port_grads(lambda a, b, c: tat.flash_attention_gqa(
            a, b, c, causal=causal, use_kernel=uk), q, k, v, ct)
        _close(got, want)


def test_sliding_window_matches_jax_kernel():
    q, k, v, (ct,) = _inputs(3, (1, 2, 512, 32))
    want = _jax_grads(lambda a, b, c: jat.flash_attention(
        a, b, c, causal=True, window=200), q, k, v, ct)
    got = _port_grads(lambda a, b, c: tat.flash_attention(
        a, b, c, causal=True, window=200), q, k, v, ct)
    _close(got, want)


def _with_lse_grads(mod, q, k, v, ct, ct_lse, shift, torch_side):
    if torch_side:
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o, lse = mod.flash_attention_with_lse(*ts, causal=True, shift=shift)
        ((o * torch.from_numpy(ct)).sum()
         + (lse * torch.from_numpy(ct_lse)).sum()).backward()
        return ([o.detach().numpy(), lse.detach().numpy()]
                + [t.grad.numpy() for t in ts])

    def loss(a, b, c):
        o, lse = mod.flash_attention_with_lse(a, b, c, True, shift)
        return jnp.sum(o * ct) + jnp.sum(lse * ct_lse)

    args = [jnp.asarray(x) for x in (q, k, v)]
    o, lse = mod.flash_attention_with_lse(*args, True, shift)
    g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(o), np.asarray(lse)] + [np.asarray(x) for x in g]


@pytest.mark.parametrize("shift", [0, -1], ids=["diag", "strict"])
def test_flash_attention_with_lse_matches_jax_kernel(shift):
    """o in f32 and a real lse from the forward (the JAX forward is its
    Pallas kernel at s = 256); grads through the reference on both
    sides.  Under shift=-1 the first row has no key: lse ~-1e30 on both,
    o = 0 in the port (the TPU kernel writes its first block's mean of v,
    whose merge weight is 0 all the same)."""
    q, k, v, (ct, ct_lse) = _inputs(4, (2, 2, 256, 64), n=4)
    ct_lse = ct_lse[..., :1]
    want = _with_lse_grads(jat, q, k, v, ct, ct_lse, shift, False)
    got = _with_lse_grads(tat, q, k, v, ct, ct_lse, shift, True)
    assert got[0].dtype == np.float32 and got[1].shape == (2, 2, 256, 1)
    if shift == -1:
        assert np.all(got[1][..., 0, 0] < -1e29)
        assert np.all(want[1][..., 0, 0] < -1e29)
        np.testing.assert_array_equal(got[0][..., 0, :], 0.0)
        got[0], want[0] = got[0][..., 1:, :], want[0][..., 1:, :]
        got[1], want[1] = got[1][..., 1:, :], want[1][..., 1:, :]
    _close(got, want, "o lse dq dk dv".split())


def test_ragged_length_matches_jax():
    """s = 200: the JAX package routes to its reference (both ways, and
    the reference lse for with_lse); the port takes its kernel path."""
    q, k, v, (ct, ct_lse) = _inputs(5, (1, 2, 200, 64), n=4)
    want = _jax_grads(lambda a, b, c: jat.flash_attention(a, b, c,
                                                          causal=True),
                      q, k, v, ct)
    got = _port_grads(lambda a, b, c: tat.flash_attention(a, b, c,
                                                          causal=True),
                      q, k, v, ct)
    _close(got, want)
    ct_lse = ct_lse[..., :1]
    want = _with_lse_grads(jat, q, k, v, ct, ct_lse, 0, False)
    got = _with_lse_grads(tat, q, k, v, ct, ct_lse, 0, True)
    _close(got, want, "o lse dq dk dv".split())


@pytest.mark.parametrize("kw", [dict(causal=True, shift=0, window=0),
                                dict(causal=True, shift=-1, window=0),
                                dict(causal=True, shift=0, window=37),
                                dict(causal=False, shift=0, window=0)],
                         ids=["causal", "strict", "window", "full"])
def test_plain_kernel_versions_match_jax_pallas_kernels(kw):
    """The three plain versions (the kernels' arithmetic) against the
    JAX forward and backward Pallas kernels called directly, at 128-row
    blocks, including the p = 0 rule on masked entries."""
    q, k, v, (do,) = _inputs(6, (256, 32))
    causal, shift, window = kw["causal"], kw["shift"], kw["window"]
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jat._flash_2d(jq, jk, jv, causal, 128, 128, None, shift, window)
    dq, dk, dv = jat._flash_bwd_2d(jq, jk, jv, o, lse, jdo, causal, 128,
                                   128, shift, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tlse = tat.flash_attention_reference(tq, tk, tv, causal, shift,
                                             window)
    rows = slice(1, None) if shift == -1 else slice(None)
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(o)[rows],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy()[rows], np.asarray(lse)[rows],
                               atol=TOL, rtol=0)
    # the backward from the JAX side's own (o, lse)
    jo, jlse = torch.from_numpy(np.array(o)), torch.from_numpy(
        np.array(lse))
    delta = (tdo * jo).sum(-1, keepdim=True)
    tdq = tat.flash_bwd_dq_reference(tq, tk, tv, tdo, jlse, delta, causal,
                                     shift, window)
    tdk, tdv = tat.flash_bwd_dkv_reference(tq, tk, tv, tdo, jlse, delta,
                                           causal, shift, window)
    for g, w in zip((tdq, tdk, tdv), (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True),
                                dict(causal=True, window=5),
                                dict(causal=True, shift=-1)],
                         ids=["full", "causal", "window", "strict"])
def test_reference_attention_matches_jax(kw):
    q, k, v, _ = _inputs(7, (2, 3, 24, 16))
    want = jat.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   **kw)
    got = tat.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_errors_match_jax():
    q, k, v, _ = _inputs(8, (1, 4, 16, 8), (1, 3, 16, 8))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for jfn, tfn in [
        (lambda: jat.flash_attention(jq, jq, jq, window=4),
         lambda: tat.flash_attention(tq, tq, tq, window=4)),
        (lambda: jat.flash_attention_gqa(jq, jk, jv, window=4),
         lambda: tat.flash_attention_gqa(tq, tk, tv, window=4)),
        (lambda: jat.flash_attention_gqa(jq, jk, jv),
         lambda: tat.flash_attention_gqa(tq, tk, tv)),
        (lambda: jat.reference_attention(jq, jq, jq, window=2),
         lambda: tat.reference_attention(tq, tq, tq, window=2)),
    ]:
        with pytest.raises(ValueError) as want:
            jfn()
        with pytest.raises(ValueError) as got:
            tfn()
        assert str(got.value) == str(want.value)


def test_wrappers_count_no_launch_on_the_cpu():
    before = (tat.flash_forward.launches, tat.flash_bwd_dq.launches,
              tat.flash_bwd_dkv.launches)
    q, k, v, (ct,) = _inputs(9, (1, 2, 64, 16))
    _port_grads(lambda a, b, c: tat.flash_attention(a, b, c, causal=True),
                q, k, v, ct)
    assert (tat.flash_forward.launches, tat.flash_bwd_dq.launches,
            tat.flash_bwd_dkv.launches) == before
