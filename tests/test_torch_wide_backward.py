"""The bf16 flash backward at head dims above 128, which runs on the
tensor cores (``flash_dq_wide_tc`` and ``flash_dkv_wide_tc`` in
``csrc/flash_attention_sm90.cu``), held on the CPU.

(a) The slice against the JAX package: a wide-head ``TransformerLM``
(d 512 as 2 heads of 256 over 1 kv head, rope, depth 2) built from the
same flax params on both sides, with numpy-seeded tokens (1, 128):
logits, loss and every parameter's gradient.  Off a TPU the JAX model
sends grouped-query attention to its XLA reference, so its
``flash_attention_gqa`` is wrapped with ``use_kernel=True``: the JAX side
then runs its Pallas forward, dq and dk/dv kernels in interpret mode (s
128, a multiple of their 128-row blocks).  The port runs its wrappers'
plain versions.  Tolerances are tests/test_torch_train.py's: logits and
grads 1e-4 abs, the loss 1e-5 (f32, other summation orders).

(b) The tensor-core kernels' rounding, emulated in torch: p and dS
rounded to bf16 before the products that take them (dv = p^T do;
dq = dS k, dk = dS^T q), every sum in f32, the outputs rounded to bf16.
dq, dk and dv must lie within two bf16 ulps (at the plain output's
scale) of ``flash_bwd_dq_reference`` / ``flash_bwd_dkv_reference``, the
bound the card tests hold the kernels to: this records the divergence.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import port_of, to_np
from vtpu.models import transformer as jtf
from vtpu.ops import attention as jat
from vtpu_torch.models import transformer as ttf
from vtpu_torch.models.convert import params_from_flax
from vtpu_torch.ops import attention as tat

WIDE = dict(vocab=128, d_model=512, depth=2, num_heads=2, num_kv_heads=1,
            pos_embedding="rope", max_seq=128)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """The JAX side's logits, loss and grads, computed once, with its
    grouped attention on the Pallas kernels (interpret mode)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtf, "flash_attention_gqa",
               functools.partial(jat.flash_attention_gqa, use_kernel=True))
    try:
        jm = jtf.TransformerLM(**WIDE)
        params = jax.jit(jm.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 4), jnp.int32))["params"]
        tokens = np.random.default_rng(19).integers(
            0, WIDE["vocab"], (1, 128)).astype(np.int32)
        jt = jnp.asarray(tokens)

        @jax.jit
        def logits_loss_grads(p):
            def loss_fn(p):
                logits = jm.apply({"params": p}, jt)
                return jtf.lm_loss(logits, jt), logits

            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            return logits, loss, grads

        logits, loss, grads = logits_loss_grads(params)
        logits = np.array(logits)
    finally:
        mp.undo()
    return dict(jm=jm, params=params, tokens=tokens, logits=logits,
                loss=float(loss), grads=jax.device_get(grads))


def test_the_jax_side_runs_its_pallas_kernels(monkeypatch):
    """The wrapper the fixture installs reaches the Pallas path: with
    ``use_kernel=True`` the grouped call differs from the XLA fallback
    only by the kernels' f32 rounding, and it calls flash_attention."""
    calls = []
    real = jat.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(jat, "flash_attention", counting)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, 2, 128, 256)), jnp.float32)
    kv = jnp.asarray(rng.standard_normal((1, 1, 128, 256)), jnp.float32)
    got = jat.flash_attention_gqa(q, kv, kv, causal=True, use_kernel=True)
    want = jat.flash_attention_gqa(q, kv, kv, causal=True, use_kernel=False)
    assert calls == [(128, 256)]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_wide_head_logits_match_jax(case):
    """Heads of 256: on the card the backward of this model takes the
    wide entries."""
    hd = WIDE["d_model"] // WIDE["num_heads"]
    assert [tat._entry(base, hd, "bf16") for base in
            ("flash_bwd_dq", "flash_bwd_dkv")] == [
        "vtpu_flash_bwd_dq_wide_bf16", "vtpu_flash_bwd_dkv_wide_bf16"]
    tm = port_of(case["jm"], case["params"])
    got = tm(torch.from_numpy(case["tokens"]), decode=False)
    np.testing.assert_allclose(to_np(got), case["logits"], atol=1e-4,
                               rtol=0)


def test_wide_head_loss_and_every_grad_match_jax(case):
    tm = port_of(case["jm"], case["params"])
    tok = torch.from_numpy(case["tokens"])
    loss = ttf.lm_loss(tm(tok, decode=False), tok)
    np.testing.assert_allclose(loss.item(), case["loss"], atol=1e-5, rtol=0)
    loss.backward()
    want = params_from_flax(case["grads"], device="cpu")
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        got = named[name].grad
        assert got is not None, name
        np.testing.assert_allclose(to_np(got), g.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


# -- (b) the tensor-core kernels' rounding ---------------------------------
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_bwd(q, k, v, do, lse, delta, causal, shift):
    """dq, dk, dv as the wide tensor-core kernels compute them: S and dP
    from bf16 operands with f32 sums, p = exp(S - lse) in f32 (0 where
    masked), dS = p (dP - delta) scale in f32, then p and dS rounded to
    bf16 before dv = p^T dO, dq = dS K and dk = dS^T Q (f32 sums); the
    outputs rounded to bf16.  q, do [n_kv, g, s, hd]; k, v [n_kv, s, hd]."""
    hd = q.shape[-1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("ngqd,nkd->ngqk", qf, kf) * hd ** -0.5
    keep = tat._keep(q.shape[-2], k.shape[-2], causal, shift, 0, q.device)
    p = torch.exp(s - lse.float()).masked_fill(~keep, 0.0)
    dp = torch.einsum("ngqd,nkd->ngqk", dof, vf)
    ds = p * (dp - delta.float()) * hd ** -0.5
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = torch.einsum("ngqk,nkd->ngqd", ds16, kf)
    dk = torch.einsum("ngqk,ngqd->nkd", ds16, qf)
    dv = torch.einsum("ngqk,ngqd->nkd", p16, dof)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _ulps(got, want):
    """max |got - want| in bf16 ulps at want's scale (the card tests'
    measure)."""
    want = want.float()
    scale = want.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return (got.float() - want).abs().max().item() / ulp


@pytest.mark.parametrize("causal,shift", [(True, 0), (True, -1),
                                          (False, 0)],
                         ids=["causal", "shift-1", "full"])
@pytest.mark.parametrize("hd", [192, 256, 512])
def test_bf16_rounding_of_p_and_ds_stays_within_two_ulps(hd, causal, shift):
    """GQA g 4 (4 query heads over 1 kv head), s 256, numpy-seeded bf16
    inputs; lse and delta from the plain forward."""
    rng = np.random.default_rng(hd * 10 + shift + causal)
    n_kv, g, s = 1, 4, 256

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, do = rnd(n_kv, g, s, hd), rnd(n_kv, g, s, hd)
    k, v = rnd(n_kv, s, hd), rnd(n_kv, s, hd)
    cfg = (causal, shift, 0)
    o, lse = tat.flash_attention_reference(q, k, v, *cfg)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    got = _tensor_core_bwd(q, k, v, do, lse, delta, causal, shift)
    want = (tat.flash_bwd_dq_reference(q, k, v, do, lse, delta, *cfg),
            *tat.flash_bwd_dkv_reference(q, k, v, do, lse, delta, *cfg))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        assert _ulps(a, b) <= 2, (name, hd, cfg, _ulps(a, b))
    # the rounding is real: the emulation is not the plain version
    assert not all(torch.equal(a, b) for a, b in zip(got, want))
